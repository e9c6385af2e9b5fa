// GRU scan at any width over a cooperative grid of row groups: the training
// forward (with residuals), the same forward without them, and the
// reverse-time backward.
//
// Replaces vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel (training
// variant, save_residuals=True; and the no-grad variant wherever H is too
// wide for gru_scan.cu's one-block kernel),
// vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel_masked where H is too
// wide for it (template flag kMask), and
// vectorquantizedcpc_tpu/ops/gru_train.py:_bwd_kernel.
//
// Forward, per step t and batch row b (torch gate order r, z, n; bh inside
// the reset product; bh holds bf16 values in f32):
//   hproj = bf16(h) @ wh + bh                                  (f32 acc)
//   r = sigmoid(xr + hr);  z = sigmoid(xz + hz);  n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h                                    (f32 carry)
//   hs[t] = bf16(h); with residuals acts[t] = bf16([r, z, n]) and
//   hn[t] = bf16(hn); h_T in f32.
// Backward, t from T - 1 down to 0 (h_prev[t] = bf16 h entering step t):
//   dh = carry + dhs[t]
//   dn = dh (1 - z);  dz = dh (h_prev - n);  da_n = dn (1 - n^2)
//   dr = da_n hn;  dhn = da_n r;  da_r = dr r (1 - r);  da_z = dz z (1 - z)
//   dgx[t] = bf16([da_r, da_z, da_n]);  dgh[t] = bf16([da_r, da_z, dhn])
//   carry = dh z + bf16(dgh[t]) @ wh^T                          (f32 acc)
//   dh0 = the carry after t = 0; the carry starts at dh_T.
//
// What bounds it on an H100: at the vocoder's T = 5,120, B = 32, H = 896
// the forward moves ~2.35 GB (xproj in; hs, acts, hn out) and the backward
// ~3.5 GB, 0.7 and 1.05 ms at 3.35 TB/s; each does 2 T B H 3H = 789 GFLOP,
// 0.80 ms at the bf16 tensor-core peak. Neither roofline is what bounds
// them: 5,120 dependent steps are, each a hand-off of h (or dgh) between
// the blocks through L2 and a product of the block's slice of wh, which is
// read from shared memory every step (the TPU kernel keeps wh, 4.6 MiB, in
// one core's VMEM; one H100 block holds at most 227 KB, so wh is spread
// over the SMs).
//
// The design rests on the batch rows being independent sequences: row b's
// step needs only row b's h. So the grid is split into row groups, each of
// R rows (8 where the batch allows: the mma's N) with its own blocks. At B
// 32, H 896 on 132 SMs that is 4 groups x 32 blocks x 28 hidden units.
// Block j of a group owns units [j U, j U + U):
//   - forward: it keeps its 3U columns of wh (147 KB at U 28) in shared
//     memory as the A operand for the whole scan. Each step its warps read
//     the group's R rows of bf16(h) of the step before (bf16(h0) at t = 0)
//     straight from L2 into mma.sync B fragments, 16 bytes a lane, all in
//     flight at once, and form hproj^T = wh^T bf16(h)^T (m16n8k16, bf16 in,
//     f32 sums), each warp over its part of K; the parts are added in a
//     fixed order. Each thread then owns (row, unit) pairs: it carries their
//     f32 h in registers, makes their gates and writes hs, acts, hn;
//   - backward: it keeps its U rows of wh (each 3H long, the A operand of
//     dgh @ wh^T). Each step each thread first makes its pairs' dgx, dgh
//     from the residuals and its f32 carry, then, after its group's
//     barrier, the warps read the group's rows of dgh[t] from L2 into B
//     fragments and form the carry's product the same way;
//   - the forward hands h on without a barrier: h travels as 32-bit words,
//     bf16(h) and a tag of its step, in two slots that alternate by step
//     (``xchg``), and a reader polls its words until every tag is the
//     step's. That takes one L2 round trip after the last writer's store,
//     where a count barrier (release add, acquire polls) and then the data
//     took two to three. A block overwrites a slot two steps later, after
//     reading the step in between from every block of its group, each of
//     which wrote it after reading the slot: no word is overwritten before
//     its readers are done. The backward keeps a barrier per step and
//     group (a release / acquire count that only grows): its exchange is
//     three times as wide, and tagged words that double it cost more time
//     in L2 than the barrier (PERF.md);
//   - what needs no other block's data sits after the block's own stores
//     (in the backward, between arriving at the barrier and waiting): the
//     next step's xproj (forward) and six residuals (backward), loaded a
//     step ahead into registers and left in bf16 until used.
// Per step each block reads R rows of h or dgh from L2 (28 KB of words /
// 42 KB at R 8), against all B rows in a one-group layout: 4x fewer rows
// through L2 at B 32, and each barrier joins a quarter of the blocks. The
// price is a 4x wider slice of wh per block; the plan takes fewer, wider
// groups where that slice would not fit, and where not even one group's
// does (on 132 SMs at B 32, H above about 2,100), the blocks stage their
// slice of wh with each K chunk of every step, adding up the chunks'
// products in shared memory. K is loaded 16 bytes a lane and the A operand uses the same
// permutation of K, so one load feeds two mma steps; A rows sit 64 bytes
// apart modulo 128, so the 16-byte shared loads of a warp hit distinct
// banks. Exchange reads bypass L1 (not coherent across SMs).
//
// The row-group building blocks (the product, the exchange, the barrier,
// the staging of wh) and the plan live in grid_common.cuh, which
// lstm_grid.cu's LSTM pair shares at 4 gates.
//
// The kStamps variants (vq_gru_scan_grid_stamped_launch,
// vq_gru_scan_bwd_stamped_launch) also record, on thread 0 of block 0 and
// of the grid's last block, the clock64 cycles of each phase of every step
// (FwdPhase, BwdPhase); no entry point of the package launches them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

using namespace vq_grid;

constexpr int kFwdMt = 6, kFwdLoads = 4;   // A tiles of one pass, K blocks in flight
constexpr int kBwdMt = 2, kBwdLoads = 12;

struct FwdArgs {
  const __nv_bfloat16* xproj;  // (T, B, 3H)
  const int* valid;            // (T, B) masked variant: rows at 0 keep their carry
  const __nv_bfloat16* wh;     // (H, 3H)
  const float* bh;             // (3H,)
  const float* h0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H)
  __nv_bfloat16* acts;         // (T, B, 3H) residuals: r, z, n
  __nv_bfloat16* hn;           // (T, B, H) residual: the recurrent n term
  float* h_out;                // (B, H)
  unsigned int* xchg;          // (2, B, H) tagged h words (bf16 | tag << 16), zeroed
  long long* stamps;           // kStamps: (2, 4 + steps * kFwdPhases)
  int steps, batch, hidden;
  int rows, blocks, units;     // rows and blocks of a group, hidden units of a block
  int chunk;                   // K extent staged at once (H: all of it)
};

struct BwdArgs {
  const __nv_bfloat16* acts;   // (T, B, 3H)
  const __nv_bfloat16* hn;     // (T, B, H)
  const __nv_bfloat16* hprev;  // (T, B, H) bf16 h entering each step
  const __nv_bfloat16* dhs;    // (T, B, H)
  const __nv_bfloat16* wh;     // (H, 3H)
  const float* dh_t;           // (B, H)
  __nv_bfloat16* dgx;          // (T, B, 3H) = dxproj
  __nv_bfloat16* dgh;          // (T, B, 3H), also the exchange buffer
  float* dh0;                  // (B, H)
  unsigned int* sync;          // (groups, kSyncStride) barrier counts, zeroed
  long long* stamps;           // kStamps: (2, 4 + steps * kBwdPhases)
  int steps, batch, hidden;
  int rows, blocks, units;
  int chunk;                   // K extent staged at once (3H: all of it)
};

// Phases of a step that the stamped kernels time (gru_train.py:
// FWD_STAMP_PHASES, BWD_STAMP_PHASES).
enum FwdPhase { kXproj, kHLoad, kProduct, kReduce, kGates, kPrefetch, kFwdPhases };
enum BwdPhase { kResiduals, kGateGrads, kBwdBarrier, kDghLoad, kBwdProduct, kCarry, kBwdPhases };

// The GRU's layouts: 3 U columns of wh and their biases forward, U rows
// of wh (each 3H long) backward.
__host__ __device__ __forceinline__ Layout gru_fwd_layout(int H, int U, int kc, int rows) {
  return fwd_layout(3, true, H, U, kc, rows);
}

__host__ __device__ __forceinline__ Layout gru_bwd_layout(int H, int U, int kc, int rows) {
  return bwd_layout(3, H, U, kc, rows);
}

// kSave: also write the residuals acts and hn. kMask: rows whose valid[t, b]
// is 0 keep their carry at step t, and hs[t] holds bf16 of it (the serving
// PreNet's reverse direction, _fwd_kernel_masked). kStream: the plan's K
// chunk is below H, so wh is staged with each chunk of every step;
// otherwise once, with all of K.
template <bool kSave, bool kMask, bool kStream, bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) gru_scan_grid_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, tid = threadIdx.x;
  const Share sh = block_share(B, H, a.rows, a.blocks, a.units);
  const int r0 = sh.r0, nr = sh.nr, u0 = sh.u0, nu = sh.nu, n_cols = 3 * nu;
  const int n_pairs = nr * nu, kparts = group_kparts(nr);
  const int n_chunks = kStream ? cdiv(H, a.chunk) : 1;

  const Layout L = gru_fwd_layout(H, a.units, a.chunk, a.rows);
  unsigned char* w_s = smem + L.w;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [lc]
  float* carry_s = reinterpret_cast<float*>(smem + L.state);  // pairs past kRegPairs

  for (int lc = tid; lc < n_cols; lc += kBlockThreads)
    bias_s[lc] = a.bh[(lc / nu) * H + u0 + lc % nu];
  if (!kStream) stage_fwd_rows<3>(w_s, L.stride, a.wh, H, u0, nu, 0, H, L.kp);

  // Pair p is (group row p / nu, unit p % nu). Thread tid holds pairs
  // tid + k kBlockThreads (k < kMaxPairs) in registers: their offsets,
  // biases, f32 carries and the step's gate inputs, loaded a step ahead
  // and left in bf16 until the gate pass uses them (converting them where
  // they are loaded would wait for the loads there). Pairs past kRegPairs
  // (more than 512 in a block) keep their carry in shared memory and load
  // their inputs when they are used.
  Pair<3> pr[kMaxPairs];
  float carry[kMaxPairs], bias[kMaxPairs][3];
  __nv_bfloat16 xv[kMaxPairs][3];
  int valid[kMaxPairs];
  auto load_x = [&](int t, const Pair<3>& q, __nv_bfloat16 (&x)[3], int& ok) {
    const __nv_bfloat16* xr = a.xproj + (size_t)t * B * H3 + q.rhg;
    x[0] = xr[0];
    x[1] = xr[H];
    x[2] = xr[2 * H];
    if (kMask) ok = a.valid[(size_t)t * B + q.row];
  };
  auto load_inputs = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) load_x(t, pr[k], xv[k], valid[k]);
  };
  __syncthreads();  // bias_s is staged
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = tid + k * kBlockThreads;
    pr[k] = make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 3);
    carry[k] = p < n_pairs ? a.h0[pr[k].rh] : 0.f;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) bias[k][gate] = p < n_pairs ? bias_s[gate * nu + p % nu] : 0.f;
    valid[k] = 1;
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    carry_s[p - kRegPairs] = a.h0[make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh];
  // bf16(h0) into the exchange as step -1 (slot 1), for the first product.
  for (int p = tid; p < n_pairs; p += kBlockThreads) {
    const int rh = make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh;
    st_relaxed(a.xchg + (size_t)B * H + rh,
               __bfloat16_as_ushort(__float2bfloat16(a.h0[rh])) | (tag_of(-1) << 16));
  }
  load_inputs(0);

  // Pair q's gates at step t from its hproj (bias added): its new carry
  // and its stores, the exchange word first.
  auto gates = [&](int t, const Pair<3>& q, float& h, const __nv_bfloat16 (&x)[3], int ok,
                   const float (&hp)[3]) {
    const float r = sigmoid(__bfloat162float(x[0]) + hp[0]);
    const float z = sigmoid(__bfloat162float(x[1]) + hp[1]);
    const float n = tanhf(__bfloat162float(x[2]) + r * hp[2]);
    float h_new = (1.f - z) * n + z * h;
    if (kMask && ok == 0) h_new = h;
    h = h_new;
    const __nv_bfloat16 hb = __float2bfloat16(h_new);
    st_relaxed(a.xchg + (size_t)(t & 1) * B * H + q.rh, __bfloat16_as_ushort(hb) | (tag_of(t) << 16));
    const size_t rh = (size_t)t * B * H + q.rh, rh3 = (size_t)t * B * H3 + q.rhg;
    a.hs[rh] = hb;
    if (kSave) {
      a.acts[rh3] = __float2bfloat16(r);
      a.acts[rh3 + H] = __float2bfloat16(z);
      a.acts[rh3 + 2 * H] = __float2bfloat16(n);
      a.hn[rh] = __float2bfloat16(hp[2]);
    }
    if (t == a.steps - 1) a.h_out[q.rh] = h_new;
  };

  PhaseStamps<kFwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, a.steps);
  for (int t = 0; t < a.steps; ++t) {
    if constexpr (kStamps) st.begin_step();
    // hproj^T of this block's columns for its group's rows, from bf16(h) of
    // the step before (bf16(h0) at t = 0) in the exchange words.
    Rows src{};
    src.ld = H;
    src.K = H;
    src.vec = H % 4 == 0;
    src.tagged = a.xchg + ((size_t)((t - 1) & 1) * B + r0) * H;
    src.want = tag_of(t - 1);
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = kStream ? c * a.chunk : 0;
      const int kn = kStream ? min(a.chunk, H - k0) : H;
      if (kStream) {
        __syncthreads();  // the last chunk's w_s and part_s are read
        stage_fwd_rows<3>(w_s, L.stride, a.wh, H, u0, nu, k0, kn, round_up(kn, kKBlock));
        __syncthreads();
      }
      chunk_product<kFwdMt, kFwdLoads, true, kStamps>(w_s, L.stride, n_cols, L.mts, src, nr, k0,
                                                      kn, part_s, L.tile_row, kStream && c > 0, st,
                                                      kHLoad);
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kProduct);

    float hp[kMaxPairs][3];
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          hp[k][gate] = part_at(part_s, pr[k].part[gate], kparts) + bias[k][gate];
    if constexpr (kStamps) {
      if (n_pairs > tid) {
        settle(hp[0][0] + hp[0][1] + hp[0][2]);
        st.mark(kReduce);
        settle(__bfloat162float(xv[0][0]) + __bfloat162float(xv[0][1]) +
               __bfloat162float(xv[0][2]));
        st.mark(kXproj);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) gates(t, pr[k], carry[k], xv[k], valid[k], hp[k]);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
      const Pair<3> q = make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 3);
      __nv_bfloat16 x[3];
      float hq[3];
      int ok = 1;
      load_x(t, q, x, ok);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        hq[gate] = part_at(part_s, q.part[gate], kparts) + bias_s[gate * nu + p % nu];
      gates(t, q, carry_s[p - kRegPairs], x, ok, hq);
    }
    if constexpr (kStamps) st.mark(kGates);
    if (t + 1 < a.steps) load_inputs(t + 1);
    __syncthreads();  // part_s is read
    if constexpr (kStamps) {
      st.mark(kPrefetch);
      st.end_step(t);
    }
  }
  if constexpr (kStamps) st.close();
}

template <bool kStream, bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) gru_scan_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, tid = threadIdx.x;
  const Share sh = block_share(B, H, a.rows, a.blocks, a.units);
  const int r0 = sh.r0, nr = sh.nr, u0 = sh.u0, nu = sh.nu;
  const int n_pairs = nr * nu, kparts = group_kparts(nr);
  const int n_chunks = kStream ? cdiv(H3, a.chunk) : 1;
  unsigned int* sync = a.sync + (size_t)(blockIdx.x / a.blocks) * kSyncStride;  // the group's

  const Layout L = gru_bwd_layout(H, a.units, a.chunk, a.rows);
  unsigned char* w_s = smem + L.w;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  const int n_tail = max(0, a.rows * a.units - kRegPairs);
  float* carry_s = reinterpret_cast<float*>(smem + L.state);  // pairs past kRegPairs
  float* dhz_s = carry_s + n_tail;
  if (!kStream) stage_bwd_rows(w_s, L.stride, a.wh, H3, u0, nu, 0, H3, L.kp);

  // Pairs as in the forward: in registers their offsets, the f32 carry,
  // dh z and the step's residuals r, z, n, hn, h_prev, dhs (loaded a step
  // ahead, bf16 until used); past kRegPairs the carry and dh z in shared
  // memory.
  Pair<3> pr[kMaxPairs];
  float carry[kMaxPairs], dhz[kMaxPairs];
  __nv_bfloat16 res[kMaxPairs][6];
  auto load_res = [&](int t, const Pair<3>& q, __nv_bfloat16 (&v)[6]) {
    const size_t rh = (size_t)t * B * H + q.rh, rh3 = (size_t)t * B * H3 + q.rhg;
    v[0] = a.acts[rh3];
    v[1] = a.acts[rh3 + H];
    v[2] = a.acts[rh3 + 2 * H];
    v[3] = a.hn[rh];
    v[4] = a.hprev[rh];
    v[5] = a.dhs[rh];
  };
  auto load_residuals = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) load_res(t, pr[k], res[k]);
  };
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = tid + k * kBlockThreads;
    pr[k] = make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 1);
    carry[k] = p < n_pairs ? a.dh_t[pr[k].rh] : 0.f;
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    carry_s[p - kRegPairs] = a.dh_t[make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh];
  load_residuals(a.steps - 1);
  __syncthreads();  // w_s is staged

  // Pair q's gate gradients at step t from its residuals and carry: its
  // dgh (the exchange) first, then dgx, and dh z.
  auto grads = [&](int t, const Pair<3>& q, const __nv_bfloat16 (&v)[6], float carry_p,
                   float& dhz_p) {
    const float r = __bfloat162float(v[0]), z = __bfloat162float(v[1]);
    const float n = __bfloat162float(v[2]), hn = __bfloat162float(v[3]);
    const float dh = carry_p + __bfloat162float(v[5]);
    const float dn = dh * (1.f - z);
    const float dz = dh * (__bfloat162float(v[4]) - n);
    const float da_n = dn * (1.f - n * n);
    const float dr = da_n * hn;
    const float dhn = da_n * r;
    const float da_r = dr * r * (1.f - r);
    const float da_z = dz * z * (1.f - z);
    const size_t rh3 = (size_t)t * B * H3 + q.rhg;
    const __nv_bfloat16 bdr = __float2bfloat16(da_r), bdz = __float2bfloat16(da_z);
    a.dgh[rh3] = bdr;
    a.dgh[rh3 + H] = bdz;
    a.dgh[rh3 + 2 * H] = __float2bfloat16(dhn);
    a.dgx[rh3] = bdr;
    a.dgx[rh3 + H] = bdz;
    a.dgx[rh3 + 2 * H] = __float2bfloat16(da_n);
    dhz_p = dh * z;
  };

  PhaseStamps<kBwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, a.steps);
  for (int t = a.steps - 1; t >= 0; --t) {
    if constexpr (kStamps) {
      st.begin_step();
      if (n_pairs > tid) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) sum += __bfloat162float(res[0][i]);
        settle(sum);
        st.mark(kResiduals);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) grads(t, pr[k], res[k], carry[k], dhz[k]);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
      const Pair<3> q = make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 0);
      __nv_bfloat16 v[6];
      load_res(t, q, v);
      grads(t, q, v, carry_s[p - kRegPairs], dhz_s[p - kRegPairs]);
    }
    if constexpr (kStamps) st.mark(kGateGrads);
    count_arrive(sync);  // dgh[t] of the group is complete once all arrive
    if (t > 0) load_residuals(t - 1);
    count_wait(sync, (unsigned int)(a.steps - t) * a.blocks);
    if constexpr (kStamps) st.mark(kBwdBarrier);

    // carry = dh z + dgh[t] @ wh^T for this block's units and group's rows.
    Rows src{};
    src.bf = a.dgh + ((size_t)t * B + r0) * H3;
    src.ld = H3;
    src.K = H3;
    src.vec = H3 % 8 == 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = kStream ? c * a.chunk : 0;
      const int kn = kStream ? min(a.chunk, H3 - k0) : H3;
      if (kStream) {
        __syncthreads();  // the last chunk's w_s and part_s are read
        stage_bwd_rows(w_s, L.stride, a.wh, H3, u0, nu, k0, kn, round_up(kn, kKBlock));
        __syncthreads();
      }
      chunk_product<kBwdMt, kBwdLoads, false, kStamps>(w_s, L.stride, nu, L.mts, src, nr, k0, kn,
                                                       part_s, L.tile_row, kStream && c > 0, st,
                                                       kDghLoad);
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kBwdProduct);
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs)
        carry[k] = dhz[k] + part_at(part_s, pr[k].part[0], kparts);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
      carry_s[p - kRegPairs] = dhz_s[p - kRegPairs] +
                               part_at(part_s, part_base(L.tile_row, kparts, p / nu, p % nu), kparts);
    if constexpr (kStamps) {
      if (n_pairs > tid) settle(carry[0]);
      st.mark(kCarry);
      st.end_step(a.steps - 1 - t);
    }
  }
  if constexpr (kStamps) st.close();

#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k)
    if (tid + k * kBlockThreads < n_pairs) a.dh0[pr[k].rh] = carry[k];
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    a.dh0[make_pair<3>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh] = carry_s[p - kRegPairs];
}

// The forward kernel of a launch: with residuals (``save``), masked, or
// neither; streaming wh in K chunks or not; stamped (with residuals).
const void* fwd_kernel(bool save, bool mask, bool stream, bool stamps) {
  if (stamps)
    return stream ? (const void*)gru_scan_grid_kernel<true, false, true, true>
                  : (const void*)gru_scan_grid_kernel<true, false, false, true>;
  if (stream)
    return save ? (const void*)gru_scan_grid_kernel<true, false, true, false>
           : mask ? (const void*)gru_scan_grid_kernel<false, true, true, false>
                  : (const void*)gru_scan_grid_kernel<false, false, true, false>;
  return save ? (const void*)gru_scan_grid_kernel<true, false, false, false>
         : mask ? (const void*)gru_scan_grid_kernel<false, true, false, false>
                : (const void*)gru_scan_grid_kernel<false, false, false, false>;
}

const void* bwd_kernel(bool stream, bool stamps) {
  if (stamps)
    return stream ? (const void*)gru_scan_bwd_kernel<true, true>
                  : (const void*)gru_scan_bwd_kernel<false, true>;
  return stream ? (const void*)gru_scan_bwd_kernel<true, false>
                : (const void*)gru_scan_bwd_kernel<false, false>;
}

}  // namespace

extern "C" {

// The forward's and then the backward's row groups, rows per group, blocks
// per group, hidden units per block, dynamic shared memory bytes and K
// chunk of a launch at these widths (``units`` 0: the default); returns a
// cudaError_t, also where the plain kernels cannot all be resident.
int vq_gru_grid_plan(int batch, int hidden, int units, int* out12) {
  GridPlan p;
  cudaError_t err = plan_grid(3, true, batch, hidden, units, &p);
  if (err != cudaSuccess) return (int)err;
  plan_numbers(p, out12);
  err = ready_resident(fwd_kernel(true, false, p.fwd.chunk < hidden, false), p.fwd.smem,
                       p.fwd.groups * p.fwd.blocks, p.sms, kBlockThreads);
  if (err != cudaSuccess) return (int)err;
  return (int)ready_resident(bwd_kernel(p.bwd.chunk < 3 * hidden, false), p.bwd.smem,
                             p.bwd.groups * p.bwd.blocks, p.sms, kBlockThreads);
}

// The forward on ``stream``, with ``stamps`` non-null the stamped variant
// (int64, 2 x (4 + steps x kFwdPhases), zeroed; it takes ``save`` 1). With
// ``save`` 0, ``acts`` and ``hn`` are not written (and may be null); a
// non-null ``valid`` (T, B) int32 masks rows (and takes ``save`` 0).
// ``xchg`` (2, B, H) uint32, zeroed: the exchange of h between blocks.
// Allocates nothing and does not synchronise; returns cudaGetLastError()
// after the launch.
int vq_gru_scan_grid_stamped_launch(const void* xproj, const void* valid, const void* wh,
                                    const void* bh, const void* h0, void* hs, void* acts, void* hn,
                                    void* h_out, void* xchg, int steps, int batch, int hidden,
                                    int save, void* stamps, void* stream) {
  if (steps < 1 || xchg == nullptr ||
      (save && (acts == nullptr || hn == nullptr || valid != nullptr)) ||
      (stamps != nullptr && !save))
    return (int)cudaErrorInvalidValue;
  GridPlan p;
  const cudaError_t err = plan_grid(3, true, batch, hidden, 0, &p);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.valid = static_cast<const int*>(valid);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.h0 = static_cast<const float*>(h0);
  a.hs = static_cast<__nv_bfloat16*>(hs);
  a.acts = static_cast<__nv_bfloat16*>(acts);
  a.hn = static_cast<__nv_bfloat16*>(hn);
  a.h_out = static_cast<float*>(h_out);
  a.xchg = static_cast<unsigned int*>(xchg);
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.rows = p.fwd.rows;
  a.blocks = p.fwd.blocks;
  a.units = p.fwd.units;
  a.chunk = p.fwd.chunk;
  const void* kernel = fwd_kernel(save, valid != nullptr, p.fwd.chunk < hidden, stamps != nullptr);
  return (int)launch_grid(kernel, p.fwd, p.sms, &a, stream);
}

int vq_gru_scan_grid_launch(const void* xproj, const void* valid, const void* wh, const void* bh,
                            const void* h0, void* hs, void* acts, void* hn, void* h_out,
                            void* xchg, int steps, int batch, int hidden, int save, void* stream) {
  return vq_gru_scan_grid_stamped_launch(xproj, valid, wh, bh, h0, hs, acts, hn, h_out, xchg,
                                         steps, batch, hidden, save, nullptr, stream);
}

// The backward on ``stream``; the same contract as the forward's launch
// (``stamps``: 2 x (4 + steps x kBwdPhases), its steps in reverse time).
int vq_gru_scan_bwd_stamped_launch(const void* acts, const void* hn, const void* hprev,
                                   const void* dhs, const void* wh, const void* dh_t, void* dgx,
                                   void* dgh, void* dh0, void* sync, int steps, int batch,
                                   int hidden, void* stamps, void* stream) {
  if (steps < 1 || sync == nullptr) return (int)cudaErrorInvalidValue;
  GridPlan p;
  const cudaError_t err = plan_grid(3, true, batch, hidden, 0, &p);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a;
  a.acts = static_cast<const __nv_bfloat16*>(acts);
  a.hn = static_cast<const __nv_bfloat16*>(hn);
  a.hprev = static_cast<const __nv_bfloat16*>(hprev);
  a.dhs = static_cast<const __nv_bfloat16*>(dhs);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.dh_t = static_cast<const float*>(dh_t);
  a.dgx = static_cast<__nv_bfloat16*>(dgx);
  a.dgh = static_cast<__nv_bfloat16*>(dgh);
  a.dh0 = static_cast<float*>(dh0);
  a.sync = static_cast<unsigned int*>(sync);
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.rows = p.bwd.rows;
  a.blocks = p.bwd.blocks;
  a.units = p.bwd.units;
  a.chunk = p.bwd.chunk;
  return (int)launch_grid(bwd_kernel(p.bwd.chunk < 3 * hidden, stamps != nullptr), p.bwd, p.sms,
                          &a, stream);
}

int vq_gru_scan_bwd_launch(const void* acts, const void* hn, const void* hprev, const void* dhs,
                           const void* wh, const void* dh_t, void* dgx, void* dgh, void* dh0,
                           void* sync, int steps, int batch, int hidden, void* stream) {
  return vq_gru_scan_bwd_stamped_launch(acts, hn, hprev, dhs, wh, dh_t, dgx, dgh, dh0, sync,
                                        steps, batch, hidden, nullptr, stream);
}

}  // extern "C"
