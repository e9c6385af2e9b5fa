// WaveRNN's dual-softmax decode (arXiv:1802.08435 section 2) in one
// cooperative launch: every 16-bit sample of a batch of utterances, two
// dependent draws a sample.
//
// Per sample t and batch row, with h of H units split into a coarse half
// [0, H/2) and a fine half, s(v) = v / 127.5 - 1, bf16 weights and f32 sums:
//   x      = cond_proj[t / hop] + w_prev[0] s(c_{t-1}) + w_prev[1] s(f_{t-1})
//   hproj  = bf16(h_{t-1}) @ wh + bh                           (both halves)
//   coarse units: the GRU update from x and hproj -> y_c
//   c_t    = argmax(bf16(relu(bf16(y_c) @ o1 + b1)) @ o2 + b2 [+ Gumbel])
//   fine units:   x + w_ct s(c_t), then the GRU update -> y_f
//   f_t    = argmax(bf16(relu(bf16(y_f) @ o3 + b3)) @ o4 + b4 [+ Gumbel])
//   sample = 256 c_t + f_t
// The coarse draw's noise is gumbel(key(t), b, c, 2C), the fine draw's
// gumbel(key(t), b, C + f, 2C): one hash of (seed, step, row, class) over
// 2C classes a row, the coarse classes first (dual_decode.py:dual_noise).
//
// The chain y_c -> c_t -> y_f -> f_t -> h_t crosses the grid four times a
// step, so the step is six grid barriers deep. Block j owns U coarse units
// [jU, jU + U) and the U fine units H/2 + [jU, jU + U), so both gate passes
// spread over every block. Its shared memory holds two A operands over K =
// H/2 (grid_common.cuh's chunk_product and part_at, the GRU grid kernels'
// product tiles): the 3 x 2U wh columns of its units over the coarse K rows
// plus its columns of o1, and the same over the fine K rows plus its
// columns of o3. A step:
//   coarse gates                      -> bf16(y_c) to xc            barrier 1
//   xc x [wh_c | o1]: hproj(t + 1) from the coarse half, and o1 -> hidc
//                                     (the coarse noise between)    barrier 2
//   o2 head: blocks form groups of C / 16, block (group, tile) holds 16
//   classes of o2 (and of o4) and scores them for its group's rows; each
//   row's best of the 16 goes to cand, (score, class) in 8 bytes    barrier 3
//   every block: c_t of every row, the best of its C / 16 candidates, read
//   two to a 16-byte load
//   fine gates (with c_t)             -> bf16(y_f) to xf            barrier 4
//   xf x [wh_f | o3]: hproj(t + 1) += the fine half, o3 -> hidf     barrier 5
//   o4 head                           -> cand                       barrier 6
//   every block: f_t of every row; block 0 writes 256 c_t + f_t.
// hproj is double-buffered: the coarse product of step t writes the next
// step's while the fine gates of step t still read this step's. Barriers
// are grid_common.cuh's count (release add, acquire polls), one count for
// the grid. Every exchanged buffer is read with __ldcg.
//
// The kStamps variant (vq_dual_decode_stamped_launch) records the cycles of
// each phase (DualPhase) on thread 0 of block 0 and of the last block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "grid_common.cuh"

namespace {

using namespace vq_grid;
using vq_decode::better;
using vq_decode::gumbel;
using vq_decode::mix32;

constexpr int kMaxBatch = 128;  // rows of one launch
constexpr int kClassTile = 16;  // classes a head block scores: one mma M tile
constexpr int kMaxTiles = 16;   // class tiles a softmax has: C <= 256
constexpr int kDualMt = 2;      // A tiles a warp takes in one pass of the product
constexpr int kDualLoads = 14;  // K blocks a warp loads at once: all of H/2 = 448

// Phases of a step that the stamped kernel times (dual_decode.py:DUAL_STAMP_PHASES).
enum DualPhase {
  kCoarseGates, kBarrier1, kCoarseLoad, kCoarseProduct, kBarrier2, kCoarseHead, kBarrier3,
  kCoarseDraw, kFineGates, kBarrier4, kFineLoad, kFineProduct, kBarrier5, kFineHead, kBarrier6,
  kFineDraw, kDualPhases
};

struct DualArgs {
  const __nv_bfloat16* cond;  // (Tf, B, 3H) frame-rate input projection, bias included
  const __nv_bfloat16* wh;    // (H, 3H)
  const float* bh;            // (3H,)
  const float* w_prev;        // (2, 3H): s(c_{t-1}) and s(f_{t-1}) into every gate
  const float* w_ct;          // (3, H/2): s(c_t) into the fine half's r, z, n
  const __nv_bfloat16* o1;    // (H/2, H/2) input-major
  const float* o1_b;          // (H/2,)
  const __nv_bfloat16* o2;    // (H/2, C)
  const float* o2_b;          // (C,)
  const __nv_bfloat16* o3;
  const float* o3_b;
  const __nv_bfloat16* o4;
  const float* o4_b;
  const int* c0;              // (B,) bytes before the first sample
  const int* f0;
  const float* h0;            // (B, H)
  __nv_bfloat16* xc;          // (B, ld) bf16(y_c), zero beyond H/2
  __nv_bfloat16* xf;          // (B, ld) bf16(y_f)
  __nv_bfloat16* hidc;        // (B, ld) relu(o1) rows
  __nv_bfloat16* hidf;        // (B, ld) relu(o3) rows
  uint2* cand;                // (B, ct_ld) each class tile's best (score bits, class) a row
  int* out;                   // (T, B) samples 256 c + f
  float* h_out;               // (B, H) final hidden state
  int n_steps, batch, hidden, classes, hop, greedy;
  unsigned int seed;
  int units;   // U: units of each half per block
  int o_cols;  // o1 / o3 columns per block
  int ld;      // elements between two rows of the exchanged buffers
  int ct_ld;   // candidates between two rows of cand: C / 16 rounded up to even
  long long* stamps;   // kStamps: (2, 4 + n_steps * kDualPhases)
  unsigned int* sync;  // (1,) the grid barrier's count, zeroed by the caller
};

struct DualLayout {
  size_t wc, wf, o2, o4, part, hp, carry, cx, bias, noise, bytes, total;
  int kp, stride, tile_row_p, tile_row_h;
};

__host__ __device__ __forceinline__ int part_tile_row(int rows) {
  const int tasks = max(kBlockWarps, cdiv(rows, kTile));
  return tasks * kPartTile + (tasks % 2 == 0 ? 16 : 0);
}

// Dynamic shared memory of a block; the same on the host (size) and the
// card. wc / wf: the two A operands (3 x 2U wh columns, then the o1 / o3
// columns, one zero row) over K = H/2; o2 / o4: this block's 16 classes of
// each head (one zero row); part: the products' partial tiles; hp: hproj
// of this step and of the next, per row; carry: the f32 h of the block's
// units per row; cx: the frame's conditioning inputs of its columns per
// row; bias: bh, w_prev's two rows and w_ct of its columns, its o1 / o3
// biases and its classes' o2 / o4 biases; noise: the head's scores of its
// rows; bytes: c_{t-1}, f_{t-1} and c_t of every row.
__host__ __device__ __forceinline__ DualLayout dual_layout(int B, int half, int U, int o_cols,
                                                          int groups) {
  DualLayout L;
  const int nu = 2 * U, m_rows = 3 * nu + o_cols, rows_h = cdiv(B, groups);
  L.kp = round_up(half, kKBlock);
  L.stride = a_stride(2 * L.kp);
  L.tile_row_p = part_tile_row(B);
  L.tile_row_h = part_tile_row(rows_h);
  size_t off = 0;
  L.wc = take(&off, (size_t)(m_rows + 1) * L.stride);
  L.wf = take(&off, (size_t)(m_rows + 1) * L.stride);
  L.o2 = take(&off, (size_t)(kClassTile + 1) * L.stride);
  L.o4 = take(&off, (size_t)(kClassTile + 1) * L.stride);
  L.part = take(&off, sizeof(float) * max(L.tile_row_p * cdiv(m_rows, 16), L.tile_row_h));
  L.hp = take(&off, sizeof(float) * 2 * B * 3 * nu);
  L.carry = take(&off, sizeof(float) * B * nu);
  L.cx = take(&off, sizeof(float) * B * 3 * nu);
  L.bias = take(&off, sizeof(float) * (4 * 3 * nu + 2 * o_cols + 2 * kClassTile));
  L.noise = take(&off, sizeof(float) * rows_h * kClassTile);
  L.bytes = take(&off, sizeof(int) * 3 * kMaxBatch);
  L.total = off;
  return L;
}

__device__ __forceinline__ float byte_in(int v) { return __fsub_rn(__fdiv_rn((float)v, 127.5f), 1.f); }

template <bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) dual_decode_kernel(DualArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned barriers = 0;
  const int G = gridDim.x;
  auto grid_sync = [&]() {
    count_arrive(a.sync);
    count_wait(a.sync, ++barriers * G);
  };
  const int H = a.hidden, half = H / 2, H3 = 3 * H, B = a.batch, C = a.classes;
  const int tid = threadIdx.x, blk = blockIdx.x, U = a.units, ld = a.ld;
  const int nuc = max(0, min(U, half - blk * U));  // units of each half this block owns
  const int nu = 2 * nuc, n3 = 3 * nu;
  int n_o = 0;
  while (n_o < a.o_cols && blk + n_o * G < half) ++n_o;
  const int m_rows = n3 + n_o, mts = cdiv(m_rows, 16);
  const int n_ct = cdiv(C, kClassTile), groups = G / n_ct, rows_h = cdiv(B, groups);
  const int grp = blk / n_ct, ct = blk % n_ct;
  const int hr0 = grp * rows_h, hnr = grp < groups ? max(0, min(rows_h, B - hr0)) : 0;
  const bool vec = half % 8 == 0 && ld % 8 == 0;
  auto unit_of = [&](int u) { return u < nuc ? blk * U + u : half + blk * U + (u - nuc); };

  const DualLayout L = dual_layout(B, half, U, a.o_cols, groups);
  unsigned char* wc_s = smem + L.wc;
  unsigned char* wf_s = smem + L.wf;
  unsigned char* o2_s = smem + L.o2;
  unsigned char* o4_s = smem + L.o4;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* hp_s[2] = {reinterpret_cast<float*>(smem + L.hp),
                    reinterpret_cast<float*>(smem + L.hp) + B * n3};
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]
  float* cx_s = reinterpret_cast<float*>(smem + L.cx);        // [b][lc]
  float* bh_s = reinterpret_cast<float*>(smem + L.bias);      // [lc]
  float* wcp_s = bh_s + n3;
  float* wfp_s = wcp_s + n3;
  float* wct_s = wfp_s + n3;
  float* o1b_s = wct_s + n3;
  float* o3b_s = o1b_s + n_o;
  float* o2b_s = o3b_s + n_o;
  float* o4b_s = o2b_s + kClassTile;
  float* noise_s = reinterpret_cast<float*>(smem + L.noise);  // [row][class of the tile]
  int* cprev_s = reinterpret_cast<int*>(smem + L.bytes);
  int* fprev_s = cprev_s + kMaxBatch;
  int* ccur_s = fprev_s + kMaxBatch;

  // ---- Resident weights and state, loaded once. ----
  // A rows: local column lc = gate * nu + u of wh over K rows [koff, koff +
  // H/2), then the head's columns blk + i G; zero beyond H/2 and in row m_rows.
  auto stage = [&](unsigned char* w_s, int koff, const __nv_bfloat16* o) {
    for (int i = tid; i < (m_rows + 1) * L.kp; i += kBlockThreads) {
      const int m = i / L.kp, k = i % L.kp;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (k < half && m < n3)
        v = a.wh[(size_t)(koff + k) * H3 + (m / nu) * H + unit_of(m % nu)];
      else if (k < half && m < m_rows)
        v = o[(size_t)k * half + blk + (m - n3) * G];
      reinterpret_cast<__nv_bfloat16*>(w_s + (size_t)m * L.stride)[k] = v;
    }
  };
  stage(wc_s, 0, a.o1);
  stage(wf_s, half, a.o3);
  // The 16 classes ct * 16 + c of o2 and o4 as A rows (zero beyond C).
  for (int i = tid; i < (kClassTile + 1) * L.kp; i += kBlockThreads) {
    const int m = i / L.kp, k = i % L.kp, cls = ct * kClassTile + m;
    const bool ok = hnr > 0 && m < kClassTile && cls < C && k < half;
    reinterpret_cast<__nv_bfloat16*>(o2_s + (size_t)m * L.stride)[k] =
        ok ? a.o2[(size_t)k * C + cls] : __float2bfloat16(0.f);
    reinterpret_cast<__nv_bfloat16*>(o4_s + (size_t)m * L.stride)[k] =
        ok ? a.o4[(size_t)k * C + cls] : __float2bfloat16(0.f);
  }
  for (int lc = tid; lc < n3; lc += kBlockThreads) {
    const int gate = lc / nu, u = lc % nu, col = gate * H + unit_of(u);
    bh_s[lc] = a.bh[col];
    wcp_s[lc] = a.w_prev[col];
    wfp_s[lc] = a.w_prev[H3 + col];
    wct_s[lc] = u < nuc ? 0.f : a.w_ct[gate * half + unit_of(u) - half];
  }
  for (int i = tid; i < n_o; i += kBlockThreads) {
    o1b_s[i] = a.o1_b[blk + i * G];
    o3b_s[i] = a.o3_b[blk + i * G];
  }
  for (int c = tid; c < kClassTile; c += kBlockThreads) {
    const int cls = ct * kClassTile + c;
    o2b_s[c] = cls < C ? a.o2_b[cls] : 0.f;
    o4b_s[c] = cls < C ? a.o4_b[cls] : 0.f;
  }
  for (int b = tid; b < B; b += kBlockThreads) {
    cprev_s[b] = min(max(a.c0[b], 0), C - 1);
    fprev_s[b] = min(max(a.f0[b], 0), C - 1);
  }
  // The pad candidate of rows whose C / 16 is odd never wins.
  if (n_ct % 2)
    for (int b = tid; b < B; b += kBlockThreads)
      a.cand[(size_t)b * a.ct_ld + n_ct] = make_uint2(__float_as_uint(-INFINITY), 0x7fffffffu);
  // h0: the carry of this block's units, and bf16(h0) in xc / xf.
  for (int i = tid; i < B * nu; i += kBlockThreads) {
    const int b = i / nu, u = i % nu, j = unit_of(u);
    const float h = a.h0[(size_t)b * H + j];
    carry_s[b * nu + u] = h;
    (u < nuc ? a.xc : a.xf)[(size_t)b * ld + j - (u < nuc ? 0 : half)] = __float2bfloat16(h);
  }
  grid_sync();

  PhaseStamps<kDualPhases> st;
  // One half's product: xs (B rows of bf16 y) x [wh columns | head columns]
  // into hproj of the next step (``first``: its coarse share, else the fine
  // share added) and, where ``heads``, relu(head + bias) into hid.
  auto product = [&](const unsigned char* w_s, const __nv_bfloat16* xs, float* hp, bool first,
                     bool heads, const float* ob, __nv_bfloat16* hid, int load_phase) {
    Rows src{};
    src.bf = xs;
    src.ld = ld;
    src.K = half;
    src.vec = vec;
    chunk_product<kDualMt, kDualLoads, false, kStamps>(w_s, L.stride, m_rows, mts, src, B, 0,
                                                       half, part_s, L.tile_row_p, false, st,
                                                       load_phase);
    __syncthreads();
    const int kparts = group_kparts(B);
    for (int i = tid; i < B * m_rows; i += kBlockThreads) {
      const int b = i / m_rows, m = i % m_rows;
      if (m >= n3 && !heads) continue;
      const float v = part_at(part_s, part_base(L.tile_row_p, kparts, b, m), kparts);
      if (m < n3)
        hp[b * n3 + m] = first ? v : hp[b * n3 + m] + v;
      else
        hid[(size_t)b * ld + blk + (m - n3) * G] = __float2bfloat16(fmaxf(v + ob[m - n3], 0.f));
    }
    __syncthreads();
  };
  // The head's noise of this block's (row, class) pairs; the fine draw's
  // classes follow the coarse draw's C.
  auto noise_of = [&](uint32_t step_key, int class_base) {
    for (int i = tid; i < hnr * kClassTile; i += kBlockThreads) {
      const int cls = ct * kClassTile + i % kClassTile;
      noise_s[i] = !a.greedy && cls < C
                       ? gumbel(step_key, hr0 + i / kClassTile, class_base + cls, 2 * C)
                       : 0.f;
    }
  };
  // One softmax's scores of this block's 16 classes for its group's rows,
  // each row's best of them (the lowest class among equals) to cand.
  auto head = [&](const unsigned char* o_s, const __nv_bfloat16* hid, const float* ob,
                  int phase) {
    if (hnr == 0) return;
    Rows src{};
    src.bf = hid + (size_t)hr0 * ld;
    src.ld = ld;
    src.K = half;
    src.vec = vec;
    chunk_product<1, kDualLoads, false, kStamps>(o_s, L.stride, kClassTile, 1, src, hnr, 0, half,
                                                 part_s, L.tile_row_h, false, st, phase);
    __syncthreads();
    const int kparts = group_kparts(hnr);
    for (int i = tid; i < hnr * kClassTile; i += kBlockThreads) {
      const int rb = i / kClassTile, c = i % kClassTile;
      float v = part_at(part_s, part_base(L.tile_row_h, kparts, rb, c), kparts) + ob[c];
      if (!a.greedy) v = v + noise_s[i];
      noise_s[i] = ct * kClassTile + c < C ? v : -INFINITY;
    }
    __syncthreads();
    for (int rb = tid; rb < hnr; rb += kBlockThreads) {
      float bv = noise_s[rb * kClassTile];
      int bi = ct * kClassTile;
      for (int c = 1; c < kClassTile; ++c)
        if (better(noise_s[rb * kClassTile + c], ct * kClassTile + c, bv, bi)) {
          bv = noise_s[rb * kClassTile + c];
          bi = ct * kClassTile + c;
        }
      __stcg(a.cand + (size_t)(hr0 + rb) * a.ct_ld + ct, make_uint2(__float_as_uint(bv), bi));
    }
  };
  // Every row's draw: the best of its C / 16 candidates, into dst (the
  // order of the scan does not matter: ``better`` is a total order).
  auto draw = [&](int* dst) {
    for (int b = tid; b < B; b += kBlockThreads) {
      const uint4* row = reinterpret_cast<const uint4*>(a.cand + (size_t)b * a.ct_ld);
      uint4 v[kMaxTiles / 2];
#pragma unroll
      for (int k = 0; k < kMaxTiles / 2; ++k) v[k] = 2 * k < n_ct ? __ldcg(row + k) : v[0];
      float bv = __uint_as_float(v[0].x);
      int bi = (int)v[0].y;
#pragma unroll
      for (int k = 0; k < kMaxTiles / 2; ++k) {
        if (better(__uint_as_float(v[k].x), (int)v[k].y, bv, bi)) {
          bv = __uint_as_float(v[k].x);
          bi = (int)v[k].y;
        }
        if (better(__uint_as_float(v[k].z), (int)v[k].w, bv, bi)) {
          bv = __uint_as_float(v[k].z);
          bi = (int)v[k].w;
        }
      }
      dst[b] = min(max(bi, 0), C - 1);
    }
    __syncthreads();
  };
  // One half's GRU update of this block's units for every row: the coarse
  // half from c_{t-1}, f_{t-1}; the fine half with c_t too.
  auto gates = [&](bool fine, int t, const float* hp) {
    const int n = nuc, u_lo = fine ? nuc : 0;
    __nv_bfloat16* xs = fine ? a.xf : a.xc;
    for (int i = tid; i < B * n; i += kBlockThreads) {
      const int b = i / n, u = u_lo + i % n, j = unit_of(u);
      const float cp = byte_in(cprev_s[b]), fp = byte_in(fprev_s[b]);
      const float cc = fine ? byte_in(ccur_s[b]) : 0.f;
      float x[3], hh[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const int lc = gate * nu + u;
        float xv = __fadd_rn(cx_s[b * n3 + lc], __fmul_rn(wcp_s[lc], cp));
        xv = __fadd_rn(xv, __fmul_rn(wfp_s[lc], fp));
        if (fine) xv = __fadd_rn(xv, __fmul_rn(wct_s[lc], cc));
        x[gate] = xv;
        hh[gate] = hp[b * n3 + lc] + bh_s[lc];
      }
      const float r = __frcp_rn(1.f + expf(-(x[0] + hh[0])));
      const float z = __frcp_rn(1.f + expf(-(x[1] + hh[1])));
      const float nn = tanhf(x[2] + r * hh[2]);
      const float h_new = (1.f - z) * nn + z * carry_s[b * nu + u];
      carry_s[b * nu + u] = h_new;
      xs[(size_t)b * ld + j - (fine ? half : 0)] = __float2bfloat16(h_new);
      if (t == a.n_steps - 1) a.h_out[(size_t)b * H + j] = h_new;
    }
  };

  // hproj of step 0 from h0, both halves; then no block writes xc / xf
  // before every block has read them.
  product(wc_s, a.xc, hp_s[0], true, false, nullptr, nullptr, kCoarseLoad);
  product(wf_s, a.xf, hp_s[0], false, false, nullptr, nullptr, kFineLoad);
  grid_sync();

  const uint32_t seed_key = mix32(a.seed);
  if constexpr (kStamps) st.open(a.stamps, a.n_steps);
  for (int t = 0; t < a.n_steps; ++t) {
    if constexpr (kStamps) st.begin_step();
    const float* hp_cur = hp_s[t & 1];
    float* hp_nxt = hp_s[(t + 1) & 1];
    if (t % a.hop == 0) {  // a new frame: the conditioning inputs of this block's columns
      const int f = t / a.hop;
      for (int i = tid; i < B * n3; i += kBlockThreads) {
        const int b = i / n3, lc = i % n3;
        cx_s[i] = __bfloat162float(
            a.cond[((size_t)f * B + b) * H3 + (lc / nu) * H + unit_of(lc % nu)]);
      }
      __syncthreads();
    }
    const uint32_t step_key = mix32(seed_key ^ (uint32_t)t);

    // ---- Coarse half: gates, product with o1, o2 head, c_t. ----
    gates(false, t, hp_cur);
    if constexpr (kStamps) st.mark(kCoarseGates);
    grid_sync();
    if constexpr (kStamps) st.mark(kBarrier1);
    product(wc_s, a.xc, hp_nxt, true, true, o1b_s, a.hidc, kCoarseLoad);
    if constexpr (kStamps) st.mark(kCoarseProduct);
    count_arrive(a.sync);
    noise_of(step_key, 0);
    count_wait(a.sync, ++barriers * G);
    if constexpr (kStamps) st.mark(kBarrier2);
    head(o2_s, a.hidc, o2b_s, kCoarseHead);
    if constexpr (kStamps) st.mark(kCoarseHead);
    grid_sync();
    if constexpr (kStamps) st.mark(kBarrier3);
    draw(ccur_s);
    if constexpr (kStamps) st.mark(kCoarseDraw);

    // ---- Fine half: gates with c_t, product with o3, o4 head, f_t. ----
    gates(true, t, hp_cur);
    if constexpr (kStamps) st.mark(kFineGates);
    grid_sync();
    if constexpr (kStamps) st.mark(kBarrier4);
    product(wf_s, a.xf, hp_nxt, false, true, o3b_s, a.hidf, kFineLoad);
    if constexpr (kStamps) st.mark(kFineProduct);
    count_arrive(a.sync);
    noise_of(step_key, C);
    count_wait(a.sync, ++barriers * G);
    if constexpr (kStamps) st.mark(kBarrier5);
    head(o4_s, a.hidf, o4b_s, kFineHead);
    if constexpr (kStamps) st.mark(kFineHead);
    grid_sync();
    if constexpr (kStamps) st.mark(kBarrier6);
    draw(fprev_s);
    for (int b = tid; b < B; b += kBlockThreads) {
      cprev_s[b] = ccur_s[b];
      if (blk == 0) __stcg(a.out + (size_t)t * B + b, ccur_s[b] * 256 + fprev_s[b]);
    }
    __syncthreads();
    if constexpr (kStamps) {
      st.mark(kFineDraw);
      st.end_step(t);
    }
  }
  if constexpr (kStamps) st.close();
}

struct DualPlan {
  int grid, units, o_cols, sms;
  DualLayout layout;
  const void* kernel;
};

cudaError_t plan_dual(int batch, int hidden, int classes, bool stamps, DualPlan* p) {
  if (batch < 1 || batch > kMaxBatch || hidden < 2 || hidden % 2 || classes < 1 ||
      classes > kClassTile * kMaxTiles)
    return cudaErrorInvalidValue;
  int max_smem;
  cudaError_t err = device_limits(&p->sms, &max_smem);
  if (err != cudaSuccess) return err;
  const int half = hidden / 2;
  p->units = cdiv(half, p->sms);
  p->grid = cdiv(half, p->units);
  p->o_cols = cdiv(half, p->grid);
  const int n_ct = cdiv(classes, kClassTile);
  if (p->grid < n_ct) return cudaErrorInvalidValue;  // a head block per class tile
  p->layout = dual_layout(batch, half, p->units, p->o_cols, p->grid / n_ct);
  if (p->layout.total > (size_t)max_smem) return cudaErrorInvalidValue;
  p->kernel = stamps ? (const void*)dual_decode_kernel<true> : (const void*)dual_decode_kernel<false>;
  return ready_resident(p->kernel, p->layout.total, p->grid, p->sms, kBlockThreads);
}

}  // namespace

extern "C" {

// Grid size, units of each half per block and dynamic shared memory bytes
// of a launch at these widths; returns a cudaError_t.
int vq_dual_decode_plan(int batch, int hidden, int classes, int* out3) {
  DualPlan p;
  const cudaError_t err = plan_dual(batch, hidden, classes, false, &p);
  if (err != cudaSuccess) return (int)err;
  out3[0] = p.grid;
  out3[1] = p.units;
  out3[2] = (int)p.layout.total;
  return 0;
}

// The decode with ``stamps`` non-null: the variant that records per-phase
// clock64 counts of two blocks into ``stamps`` (int64, 2 x (4 + n_steps x
// kDualPhases), zeroed by the caller; grid_common.cuh PhaseStamps). With
// ``stamps`` null, the plain kernel: vq_dual_decode_launch.
int vq_dual_decode_stamped_launch(const void* cond, const void* wh, const void* bh,
                                  const void* w_prev, const void* w_ct, const void* o1,
                                  const void* o1_b, const void* o2, const void* o2_b,
                                  const void* o3, const void* o3_b, const void* o4,
                                  const void* o4_b, const void* c0, const void* f0,
                                  const void* h0, void* xc, void* xf, void* hidc, void* hidf,
                                  void* cand, void* out, void* h_out,
                                  void* sync_buf, int n_steps, int batch, int hidden, int classes,
                                  int hop, int greedy, unsigned int seed, void* stamps,
                                  void* stream) {
  if (n_steps < 1 || hop < 1 || sync_buf == nullptr) return (int)cudaErrorInvalidValue;
  DualPlan p;
  cudaError_t err = plan_dual(batch, hidden, classes, stamps != nullptr, &p);
  if (err != cudaSuccess) return (int)err;
  DualArgs a;
  a.cond = static_cast<const __nv_bfloat16*>(cond);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.w_prev = static_cast<const float*>(w_prev);
  a.w_ct = static_cast<const float*>(w_ct);
  a.o1 = static_cast<const __nv_bfloat16*>(o1);
  a.o1_b = static_cast<const float*>(o1_b);
  a.o2 = static_cast<const __nv_bfloat16*>(o2);
  a.o2_b = static_cast<const float*>(o2_b);
  a.o3 = static_cast<const __nv_bfloat16*>(o3);
  a.o3_b = static_cast<const float*>(o3_b);
  a.o4 = static_cast<const __nv_bfloat16*>(o4);
  a.o4_b = static_cast<const float*>(o4_b);
  a.c0 = static_cast<const int*>(c0);
  a.f0 = static_cast<const int*>(f0);
  a.h0 = static_cast<const float*>(h0);
  a.xc = static_cast<__nv_bfloat16*>(xc);
  a.xf = static_cast<__nv_bfloat16*>(xf);
  a.hidc = static_cast<__nv_bfloat16*>(hidc);
  a.hidf = static_cast<__nv_bfloat16*>(hidf);
  a.cand = static_cast<uint2*>(cand);
  a.out = static_cast<int*>(out);
  a.h_out = static_cast<float*>(h_out);
  a.n_steps = n_steps;
  a.batch = batch;
  a.hidden = hidden;
  a.classes = classes;
  a.hop = hop;
  a.greedy = greedy;
  a.seed = seed;
  a.units = p.units;
  a.o_cols = p.o_cols;
  a.ld = round_up(hidden / 2, 8);
  a.ct_ld = round_up(cdiv(classes, kClassTile), 2);
  a.stamps = static_cast<long long*>(stamps);
  a.sync = static_cast<unsigned int*>(sync_buf);
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(kBlockThreads), params,
                              p.layout.total, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Launches the dual decode on ``stream``. ``h0`` (B, H) f32, ``c0`` / ``f0``
// (B,) int32 the bytes of the sample before the first; ``xc``, ``xf``,
// ``hidc``, ``hidf`` (B, ld) bf16 with ld = H/2 rounded up to 8, zeroed by
// the caller (the padding stays zero); ``cand`` (B, C / 16 rounded up to
// even) pairs of uint32; ``out`` (n_steps, B) int32; ``sync_buf`` one
// uint32, zeroed.
// Allocates nothing and does not synchronise.
int vq_dual_decode_launch(const void* cond, const void* wh, const void* bh, const void* w_prev,
                          const void* w_ct, const void* o1, const void* o1_b, const void* o2,
                          const void* o2_b, const void* o3, const void* o3_b, const void* o4,
                          const void* o4_b, const void* c0, const void* f0, const void* h0,
                          void* xc, void* xf, void* hidc, void* hidf, void* cand, void* out,
                          void* h_out, void* sync_buf, int n_steps, int batch,
                          int hidden, int classes, int hop, int greedy, unsigned int seed,
                          void* stream) {
  return vq_dual_decode_stamped_launch(cond, wh, bh, w_prev, w_ct, o1, o1_b, o2, o2_b, o3, o3_b,
                                       o4, o4_b, c0, f0, h0, xc, xf, hidc, hidf, cand, out, h_out,
                                       sync_buf, n_steps, batch, hidden, classes, hop,
                                       greedy, seed, nullptr, stream);
}

}  // extern "C"
