// LSTM scan at any width over a cooperative grid of row groups: the forward
// (inference and training variants) and the reverse-time backward, for the
// widths that lstm_scan.cu's cluster of 8 CTAs cannot hold (H not a
// multiple of 8, H > 432 forward, H > 352 backward; lstm_scan.py:scan_route
// picks).
//
// Forward. Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_fwd_kernel at
// those widths. Per step t and batch row b (torch gate order i, f, g, o):
//   gates = f32(xproj[t, b]) + bf16(h) @ wh                     (f32 acc)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   hs[t, b] = bf16(h); c carries in f32.
// The training variant (template flag kSave) also writes c_prev[t, b] (f32)
// and acts[t, b] = bf16(sigmoid i, sigmoid f, tanh g, sigmoid o); its hs,
// h_T and c_T are the inference variant's bits.
//
// Backward. Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_bwd_kernel at
// those widths: lstm_scan.cu's arithmetic (dgates[t] = bf16(da), dh =
// bf16(da) @ wh^T, dc *= f), carried from (dh_T, dc_T) down to t = 0.
//
// What bounds them on an H100: at the CPC shape with a 512-wide context
// (B 64, T 70) each moves ~51 MB (~15 us at 3.35 TB/s) and does 9.4 GFLOP
// (~9.5 us at the bf16 tensor rate); both are latency-bound instead: T
// dependent steps, each a (B, H) x (H, 4H) product whose operand wh (2 MB
// at H 512) is spread over the SMs, and a hand-off of h (or the gate
// gradients) between them.
//
// The design is gru_train.cu's, on grid_common.cuh's row groups (the batch
// rows are independent sequences). At B 64, H 512 on 132 SMs that is 8
// groups x 16 blocks x 32 hidden units (B 16: 2 x 64 x 8). Block j of a
// group owns units [j U, j U + U):
//   - forward: it keeps its 4U i/f/g/o columns of wh (128 KB at U 32) in
//     shared memory as the A operand for the whole scan. Each step its
//     warps read the group's R rows of bf16(h) of the step before
//     (bf16(h0) at t = 0) from L2 straight into mma.sync B fragments and
//     form gates^T = wh^T bf16(h)^T, each warp over its part of K; each
//     thread then owns (row, unit) pairs, carries their f32 c in registers,
//     makes their gates and writes hs (and acts, c_prev). h travels to the
//     group's other blocks as tagged 32-bit words (bf16(h) and its step's
//     tag, two slots alternating by step: grid_common.cuh tag_of): no
//     barrier;
//   - backward: it keeps its U rows of wh (each 4H long). Each step each
//     thread makes its pairs' da from the residuals (acts, c_prev, dhs) and
//     its f32 carries dh, dc, and writes dgates[t]; then its group's count
//     barrier (a release / acquire count that only grows), then the warps
//     read the group's rows of dgates[t] from L2 into B fragments and form
//     dh = dgates[t] @ wh^T for its units;
//   - what needs no other block's data sits after the block's own stores
//     (in the backward, between arriving at the barrier and waiting): the
//     next step's xproj (forward) and residuals (backward), loaded a step
//     ahead into registers.
// Each block reads only its group's R rows a step from L2 (at B 64, 8 of
// the 64 rows), and each barrier joins a group's blocks, not the grid.
// Where not even one group's
// slice of wh fits a block (on 132 SMs at B 64: H above ~1,900), the
// blocks stage it with each K chunk of every step, adding up the chunks'
// products in shared memory. The exchange words and the counts live in
// buffers the wrapper zeroes for each launch (so a replayed CUDA graph
// starts each scan from clean tags and counts).
//
// The kStamps variants (vq_lstm_scan_grid_stamped_launch,
// vq_lstm_scan_grid_bwd_stamped_launch) also record, on thread 0 of block
// 0 and of the grid's last block, the clock64 cycles of each phase of
// every step (FwdPhase, BwdPhase); no entry point of the package launches
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

using namespace vq_grid;

constexpr int kGates = 4;
constexpr int kFwdMt = 8, kFwdLoads = 4;  // A tiles of one pass, K blocks in flight
constexpr int kBwdMt = 2, kBwdLoads = 8;

struct FwdArgs {
  const __nv_bfloat16* xproj;  // (T, B, 4H) input projection x @ wx + b
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* h0;             // (B, H)
  const float* c0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H)
  __nv_bfloat16* acts;         // (T, B, 4H) activated gates (training variant)
  float* c_prev;               // (T, B, H) cell state entering each step (training)
  float* h_out;                // (B, H)
  float* c_out;                // (B, H)
  unsigned int* xchg;          // (2, B, H) tagged h words (bf16 | tag << 16), zeroed
  long long* stamps;           // kStamps: (2, 4 + steps * kFwdPhases)
  int steps, batch, hidden;
  int rows, blocks, units;     // rows and blocks of a group, hidden units of a block
  int chunk;                   // K extent staged at once (H: all of it)
};

struct BwdArgs {
  const __nv_bfloat16* acts;   // (T, B, 4H)
  const float* c_prev;         // (T, B, H)
  const __nv_bfloat16* dhs;    // (T, B, H)
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* dh_t;           // (B, H)
  const float* dc_t;           // (B, H)
  __nv_bfloat16* dgates;       // (T, B, 4H), also the exchange buffer
  float* dh0;                  // (B, H)
  float* dc0;                  // (B, H)
  unsigned int* sync;          // (groups, kSyncStride) barrier counts, zeroed
  long long* stamps;           // kStamps: (2, 4 + steps * kBwdPhases)
  int steps, batch, hidden;
  int rows, blocks, units;
  int chunk;                   // K extent staged at once (4H: all of it)
};

// Phases of a step that the stamped kernels time (lstm_scan.py:
// GRID_FWD_STAMP_PHASES, GRID_BWD_STAMP_PHASES).
enum FwdPhase { kXproj, kHLoad, kProduct, kReduce, kGatePass, kPrefetch, kFwdPhases };
enum BwdPhase { kResiduals, kGateGrads, kBwdBarrier, kDgLoad, kBwdProduct, kCarry, kBwdPhases };

// A pair's residuals of one step: the activated gates and dhs in bf16 (left
// so until used), c_prev in f32.
struct Residuals {
  __nv_bfloat16 act[4], dhs;
  float cp;
};

// kSave: also write acts and c_prev. kStream: the plan's K chunk is below
// H, so wh is staged with each chunk of every step; otherwise once.
template <bool kSave, bool kStream, bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) lstm_scan_grid_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch, tid = threadIdx.x;
  const Share sh = block_share(B, H, a.rows, a.blocks, a.units);
  const int r0 = sh.r0, nr = sh.nr, u0 = sh.u0, nu = sh.nu, n_cols = 4 * nu;
  const int n_pairs = nr * nu, kparts = group_kparts(nr);
  const int n_chunks = kStream ? cdiv(H, a.chunk) : 1;

  const Layout L = fwd_layout(kGates, false, H, a.units, a.chunk, a.rows);
  unsigned char* w_s = smem + L.w;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* carry_s = reinterpret_cast<float*>(smem + L.state);  // c of pairs past kRegPairs
  if (!kStream) stage_fwd_rows<kGates>(w_s, L.stride, a.wh, H, u0, nu, 0, H, L.kp);

  // Pair p is (group row p / nu, unit p % nu). Thread tid holds pairs
  // tid + k kBlockThreads (k < kMaxPairs) in registers: their offsets, f32
  // c and the step's gate inputs, loaded a step ahead and left in bf16
  // until the gate pass uses them. Pairs past kRegPairs keep c in shared
  // memory and load their inputs when they are used.
  Pair<kGates> pr[kMaxPairs];
  float cell[kMaxPairs];
  __nv_bfloat16 xv[kMaxPairs][4];
  auto load_x = [&](int t, const Pair<kGates>& q, __nv_bfloat16 (&x)[4]) {
    const __nv_bfloat16* xr = a.xproj + (size_t)t * B * H4 + q.rhg;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = xr[g * H];
  };
  auto load_inputs = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) load_x(t, pr[k], xv[k]);
  };
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = tid + k * kBlockThreads;
    pr[k] = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, kGates);
    cell[k] = p < n_pairs ? a.c0[pr[k].rh] : 0.f;
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    carry_s[p - kRegPairs] = a.c0[make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh];
  // bf16(h0) into the exchange as step -1 (slot 1), for the first product.
  for (int p = tid; p < n_pairs; p += kBlockThreads) {
    const int rh = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh;
    st_relaxed(a.xchg + (size_t)B * H + rh,
               __bfloat16_as_ushort(__float2bfloat16(a.h0[rh])) | (tag_of(-1) << 16));
  }
  load_inputs(0);
  __syncthreads();  // w_s is staged

  // Pair q's gates at step t from its product (xproj added): its new c and
  // its stores, the exchange word first.
  auto gates = [&](int t, const Pair<kGates>& q, float& c, const __nv_bfloat16 (&x)[4],
                   const float (&hp)[4]) {
    const float ig = sigmoid(__bfloat162float(x[0]) + hp[0]);
    const float fg = sigmoid(__bfloat162float(x[1]) + hp[1]);
    const float gg = tanhf(__bfloat162float(x[2]) + hp[2]);
    const float og = sigmoid(__bfloat162float(x[3]) + hp[3]);
    const float c_old = c;
    c = fg * c_old + ig * gg;
    const float h = og * tanhf(c);
    const __nv_bfloat16 hb = __float2bfloat16(h);
    st_relaxed(a.xchg + (size_t)(t & 1) * B * H + q.rh, __bfloat16_as_ushort(hb) | (tag_of(t) << 16));
    const size_t rh = (size_t)t * B * H + q.rh, rhg = (size_t)t * B * H4 + q.rhg;
    a.hs[rh] = hb;
    if (kSave) {
      a.c_prev[rh] = c_old;
      a.acts[rhg] = __float2bfloat16(ig);
      a.acts[rhg + H] = __float2bfloat16(fg);
      a.acts[rhg + 2 * H] = __float2bfloat16(gg);
      a.acts[rhg + 3 * H] = __float2bfloat16(og);
    }
    if (t == a.steps - 1) {
      a.h_out[q.rh] = h;
      a.c_out[q.rh] = c;
    }
  };

  PhaseStamps<kFwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, a.steps);
  for (int t = 0; t < a.steps; ++t) {
    if constexpr (kStamps) st.begin_step();
    // gates^T of this block's columns for its group's rows, from bf16(h)
    // of the step before (bf16(h0) at t = 0) in the exchange words.
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
        stage_fwd_rows<kGates>(w_s, L.stride, a.wh, H, u0, nu, k0, kn, round_up(kn, kKBlock));
        __syncthreads();
      }
      chunk_product<kFwdMt, kFwdLoads, true, kStamps>(w_s, L.stride, n_cols, L.mts, src, nr, k0,
                                                      kn, part_s, L.tile_row, kStream && c > 0, st,
                                                      kHLoad);
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kProduct);

    float hp[kMaxPairs][4];
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs)
#pragma unroll
        for (int g = 0; g < 4; ++g) hp[k][g] = part_at(part_s, pr[k].part[g], kparts);
    if constexpr (kStamps) {
      if (n_pairs > tid) {
        settle(hp[0][0] + hp[0][1] + hp[0][2] + hp[0][3]);
        st.mark(kReduce);
        settle(__bfloat162float(xv[0][0]) + __bfloat162float(xv[0][1]) +
               __bfloat162float(xv[0][2]) + __bfloat162float(xv[0][3]));
        st.mark(kXproj);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) gates(t, pr[k], cell[k], xv[k], hp[k]);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
      const Pair<kGates> q = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, kGates);
      __nv_bfloat16 x[4];
      float hq[4];
      load_x(t, q, x);
#pragma unroll
      for (int g = 0; g < 4; ++g) hq[g] = part_at(part_s, q.part[g], kparts);
      gates(t, q, carry_s[p - kRegPairs], x, hq);
    }
    if constexpr (kStamps) st.mark(kGatePass);
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
__global__ void __launch_bounds__(kBlockThreads, 1) lstm_scan_grid_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch, tid = threadIdx.x;
  const Share sh = block_share(B, H, a.rows, a.blocks, a.units);
  const int r0 = sh.r0, nr = sh.nr, u0 = sh.u0, nu = sh.nu;
  const int n_pairs = nr * nu, kparts = group_kparts(nr);
  const int n_chunks = kStream ? cdiv(H4, a.chunk) : 1;
  unsigned int* sync = a.sync + (size_t)(blockIdx.x / a.blocks) * kSyncStride;  // the group's

  const Layout L = bwd_layout(kGates, H, a.units, a.chunk, a.rows);
  unsigned char* w_s = smem + L.w;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  const int n_tail = max(0, a.rows * a.units - kRegPairs);
  float* dh_s = reinterpret_cast<float*>(smem + L.state);  // pairs past kRegPairs
  float* dc_s = dh_s + n_tail;
  if (!kStream) stage_bwd_rows(w_s, L.stride, a.wh, H4, u0, nu, 0, H4, L.kp);

  // Pairs as in the forward: in registers their offsets, the f32 carries
  // dh (the product of the step after) and dc, and the step's residuals
  // (loaded a step ahead); past kRegPairs the carries in shared memory.
  Pair<kGates> pr[kMaxPairs];
  float dh[kMaxPairs], dc[kMaxPairs];
  Residuals res[kMaxPairs];
  auto load_res = [&](int t, const Pair<kGates>& q, Residuals& v) {
    const __nv_bfloat16* ar = a.acts + (size_t)t * B * H4 + q.rhg;
#pragma unroll
    for (int g = 0; g < 4; ++g) v.act[g] = ar[g * H];
    const size_t rh = (size_t)t * B * H + q.rh;
    v.cp = a.c_prev[rh];
    v.dhs = a.dhs[rh];
  };
  auto load_residuals = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) load_res(t, pr[k], res[k]);
  };
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = tid + k * kBlockThreads;
    pr[k] = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, 1);
    dh[k] = p < n_pairs ? a.dh_t[pr[k].rh] : 0.f;
    dc[k] = p < n_pairs ? a.dc_t[pr[k].rh] : 0.f;
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
    const int rh = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh;
    dh_s[p - kRegPairs] = a.dh_t[rh];
    dc_s[p - kRegPairs] = a.dc_t[rh];
  }
  load_residuals(a.steps - 1);
  __syncthreads();  // w_s is staged

  // Pair q's gate gradients at step t from its residuals and carries:
  // dgates[t] (the exchange), and its new dc.
  auto grads = [&](int t, const Pair<kGates>& q, const Residuals& v, float dh_in, float& dc_p) {
    const float ai = __bfloat162float(v.act[0]), af = __bfloat162float(v.act[1]);
    const float ag = __bfloat162float(v.act[2]), ao = __bfloat162float(v.act[3]);
    const float cp = v.cp;
    const float dhv = dh_in + __bfloat162float(v.dhs);
    const float tc = tanhf(af * cp + ai * ag);  // c, recomputed, not stored
    const float d_o = dhv * tc;
    const float dcv = dc_p + dhv * ao * (1.f - tc * tc);
    __nv_bfloat16* grow = a.dgates + (size_t)t * B * H4 + q.rhg;
    grow[0] = __float2bfloat16(dcv * ag * ai * (1.f - ai));
    grow[H] = __float2bfloat16(dcv * cp * af * (1.f - af));
    grow[2 * H] = __float2bfloat16(dcv * ai * (1.f - ag * ag));
    grow[3 * H] = __float2bfloat16(d_o * ao * (1.f - ao));
    dc_p = dcv * af;
  };

  PhaseStamps<kBwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, a.steps);
  for (int t = a.steps - 1; t >= 0; --t) {
    if constexpr (kStamps) {
      st.begin_step();
      if (n_pairs > tid) {
        float sum = res[0].cp + __bfloat162float(res[0].dhs);
#pragma unroll
        for (int g = 0; g < 4; ++g) sum += __bfloat162float(res[0].act[g]);
        settle(sum);
        st.mark(kResiduals);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) grads(t, pr[k], res[k], dh[k], dc[k]);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
      const Pair<kGates> q = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, 0);
      Residuals v;
      load_res(t, q, v);
      grads(t, q, v, dh_s[p - kRegPairs], dc_s[p - kRegPairs]);
    }
    if constexpr (kStamps) st.mark(kGateGrads);
    count_arrive(sync);  // dgates[t] of the group is complete once all arrive
    if (t > 0) load_residuals(t - 1);
    count_wait(sync, (unsigned int)(a.steps - t) * a.blocks);
    if constexpr (kStamps) st.mark(kBwdBarrier);

    // dh = dgates[t] @ wh^T for this block's units and group's rows.
    Rows src{};
    src.bf = a.dgates + ((size_t)t * B + r0) * H4;
    src.ld = H4;
    src.K = H4;
    src.vec = H4 % 8 == 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = kStream ? c * a.chunk : 0;
      const int kn = kStream ? min(a.chunk, H4 - k0) : H4;
      if (kStream) {
        __syncthreads();  // the last chunk's w_s and part_s are read
        stage_bwd_rows(w_s, L.stride, a.wh, H4, u0, nu, k0, kn, round_up(kn, kKBlock));
        __syncthreads();
      }
      chunk_product<kBwdMt, kBwdLoads, false, kStamps>(w_s, L.stride, nu, L.mts, src, nr, k0, kn,
                                                       part_s, L.tile_row, kStream && c > 0, st,
                                                       kDgLoad);
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kBwdProduct);
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) dh[k] = part_at(part_s, pr[k].part[0], kparts);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
      dh_s[p - kRegPairs] = part_at(part_s, part_base(L.tile_row, kparts, p / nu, p % nu), kparts);
    if constexpr (kStamps) {
      if (n_pairs > tid) settle(dh[0]);
      st.mark(kCarry);
      st.end_step(a.steps - 1 - t);
    }
  }
  if constexpr (kStamps) st.close();

#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    if (tid + k * kBlockThreads < n_pairs) {
      a.dh0[pr[k].rh] = dh[k];
      a.dc0[pr[k].rh] = dc[k];
    }
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
    const int rh = make_pair<kGates>(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh;
    a.dh0[rh] = dh_s[p - kRegPairs];
    a.dc0[rh] = dc_s[p - kRegPairs];
  }
}

// The forward kernel of a launch: training (``save``) or inference,
// streaming wh in K chunks or not; stamped (training).
const void* fwd_kernel(bool save, bool stream, bool stamps) {
  if (stamps)
    return stream ? (const void*)lstm_scan_grid_kernel<true, true, true>
                  : (const void*)lstm_scan_grid_kernel<true, false, true>;
  if (stream)
    return save ? (const void*)lstm_scan_grid_kernel<true, true, false>
                : (const void*)lstm_scan_grid_kernel<false, true, false>;
  return save ? (const void*)lstm_scan_grid_kernel<true, false, false>
              : (const void*)lstm_scan_grid_kernel<false, false, false>;
}

const void* bwd_kernel(bool stream, bool stamps) {
  if (stamps)
    return stream ? (const void*)lstm_scan_grid_bwd_kernel<true, true>
                  : (const void*)lstm_scan_grid_bwd_kernel<false, true>;
  return stream ? (const void*)lstm_scan_grid_bwd_kernel<true, false>
                : (const void*)lstm_scan_grid_bwd_kernel<false, false>;
}

}  // namespace

extern "C" {

// The forward's and then the backward's row groups, rows per group, blocks
// per group, hidden units per block, dynamic shared memory bytes and K
// chunk of a launch at these widths (``units`` 0: the default); returns a
// cudaError_t, also where the plain kernels cannot all be resident.
int vq_lstm_grid_plan(int batch, int hidden, int units, int* out12) {
  GridPlan p;
  cudaError_t err = plan_grid(kGates, false, batch, hidden, units, &p);
  if (err != cudaSuccess) return (int)err;
  plan_numbers(p, out12);
  for (int save = 0; save < 2; ++save) {
    err = ready_resident(fwd_kernel(save, p.fwd.chunk < hidden, false), p.fwd.smem,
                         p.fwd.groups * p.fwd.blocks, p.sms, kBlockThreads);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)ready_resident(bwd_kernel(p.bwd.chunk < 4 * hidden, false), p.bwd.smem,
                             p.bwd.groups * p.bwd.blocks, p.sms, kBlockThreads);
}

// The forward on ``stream``, with ``stamps`` non-null the stamped variant
// (int64, 2 x (4 + steps x kFwdPhases), zeroed; it takes ``save`` 1). With
// ``save`` 0, ``acts`` and ``c_prev`` are not written (and may be null).
// ``xchg`` (2, B, H) uint32, zeroed: the exchange of h between blocks.
// Allocates nothing and does not synchronise; returns cudaGetLastError()
// after the launch.
int vq_lstm_scan_grid_stamped_launch(const void* xproj, const void* wh, const void* h0,
                                     const void* c0, void* hs, void* acts, void* c_prev,
                                     void* h_out, void* c_out, void* xchg, int steps, int batch,
                                     int hidden, int save, void* stamps, void* stream) {
  if (steps < 1 || xchg == nullptr || (save && (acts == nullptr || c_prev == nullptr)) ||
      (stamps != nullptr && !save))
    return (int)cudaErrorInvalidValue;
  GridPlan p;
  const cudaError_t err = plan_grid(kGates, false, batch, hidden, 0, &p);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.hs = static_cast<__nv_bfloat16*>(hs);
  a.acts = static_cast<__nv_bfloat16*>(acts);
  a.c_prev = static_cast<float*>(c_prev);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.xchg = static_cast<unsigned int*>(xchg);
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.rows = p.fwd.rows;
  a.blocks = p.fwd.blocks;
  a.units = p.fwd.units;
  a.chunk = p.fwd.chunk;
  const void* kernel = fwd_kernel(save, p.fwd.chunk < hidden, stamps != nullptr);
  return (int)launch_grid(kernel, p.fwd, p.sms, &a, stream);
}

int vq_lstm_scan_grid_launch(const void* xproj, const void* wh, const void* h0, const void* c0,
                             void* hs, void* acts, void* c_prev, void* h_out, void* c_out,
                             void* xchg, int steps, int batch, int hidden, int save, void* stream) {
  return vq_lstm_scan_grid_stamped_launch(xproj, wh, h0, c0, hs, acts, c_prev, h_out, c_out, xchg,
                                          steps, batch, hidden, save, nullptr, stream);
}

// The backward on ``stream``; the same contract as the forward's launch
// (``sync``: grid_plan.py:SYNC_WORDS uint32, zeroed; ``stamps``: 2 x (4 +
// steps x kBwdPhases), its steps in reverse time).
int vq_lstm_scan_grid_bwd_stamped_launch(const void* acts, const void* c_prev, const void* dhs,
                                         const void* wh, const void* dh_t, const void* dc_t,
                                         void* dgates, void* dh0, void* dc0, void* sync, int steps,
                                         int batch, int hidden, void* stamps, void* stream) {
  if (steps < 1 || sync == nullptr) return (int)cudaErrorInvalidValue;
  GridPlan p;
  const cudaError_t err = plan_grid(kGates, false, batch, hidden, 0, &p);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a;
  a.acts = static_cast<const __nv_bfloat16*>(acts);
  a.c_prev = static_cast<const float*>(c_prev);
  a.dhs = static_cast<const __nv_bfloat16*>(dhs);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.dh_t = static_cast<const float*>(dh_t);
  a.dc_t = static_cast<const float*>(dc_t);
  a.dgates = static_cast<__nv_bfloat16*>(dgates);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.sync = static_cast<unsigned int*>(sync);
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.rows = p.bwd.rows;
  a.blocks = p.bwd.blocks;
  a.units = p.bwd.units;
  a.chunk = p.bwd.chunk;
  return (int)launch_grid(bwd_kernel(p.bwd.chunk < 4 * hidden, stamps != nullptr), p.bwd, p.sms,
                          &a, stream);
}

int vq_lstm_scan_grid_bwd_launch(const void* acts, const void* c_prev, const void* dhs,
                                 const void* wh, const void* dh_t, const void* dc_t, void* dgates,
                                 void* dh0, void* dc0, void* sync, int steps, int batch, int hidden,
                                 void* stream) {
  return vq_lstm_scan_grid_bwd_stamped_launch(acts, c_prev, dhs, wh, dh_t, dc_t, dgates, dh0, dc0,
                                              sync, steps, batch, hidden, nullptr, stream);
}

}  // extern "C"
