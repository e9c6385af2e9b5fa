// Whole-utterance autoregressive vocoder decode in one cooperative launch.
//
// Replaces vectorquantizedcpc_tpu/ops/ar_decode.py:_decode_kernel, both its
// modes (template flag kInt8 for use_int8=True). Per 16 kHz sample and batch
// row, bf16 mode:
//   xp     = embed_proj[prev] + cond_proj[t / hop]                 (f32)
//   hproj  = bf16(h) @ wh + bh                                     (f32 acc)
//   r, z   = sigmoid(xr + hr), sigmoid(xz + hz)
//   n      = tanh(xn + r * hn);  h = (1 - z) * n + z * h
//   logits = bf16(relu(bf16(h) @ fc1 + b1)) @ fc2 + b2
//   sample = argmax(logits [+ Gumbel noise]), lowest index on ties
// int8 mode (weight-only int8, static activation scale; JAX _mm and
// _embed_gather): embed_proj, wh and fc1 are int8 with per-column f32 scales
// (wh's and fc1's with the activation's 1/127 folded in), and with
// q(h) = round_half_even(h * 127) as int8 (|h| < 1):
//   xp     = f32(embed_q[prev]) * embed_scale + cond_proj[t / hop]
//   hproj  = f32(q(h) . wh_q) * wh_scale + bh          (exact int32 sums)
//   hidden = relu(f32(q(h) . fc1_q) * fc1_scale + b1);  FC2 as in bf16 mode
// Each product rounds once, then each sum: __fmul_rn / __fadd_rn keep the
// compiler from fusing them into one FMA.
//
// What bounds it on an H100: the operations are 2*B*(H*3H + H*F + F*C) per
// step (5.4 MFLOP per row at the reference widths), far below what the
// tensor cores could do in one step; the step is latency-bound by the
// sample-to-sample dependency: per step, two or three round trips through
// L2 between the SMs, each behind a grid barrier. The TPU kernel keeps every
// weight in one core's VMEM; one H100 block holds at most 227 KB of shared
// memory, so the weights are spread over the SMs, one block per SM, looping
// over all steps:
//   - block j owns hidden units [j*U, (j+1)*U): their r/z/n columns of wh
//     and of embed_proj, and FC1 columns j, j+G, ...; the wh and FC1
//     columns are the rows of one A operand (3U + FC1 columns, padded to
//     16), so one mma.sync pass over the staged h gives both;
//   - the f32 carry of the block's units stays in its shared memory; only
//     bf16(h) (int8: q(h)) crosses the grid, in a double-buffered exchange
//     buffer written once per step by the gate pass;
//   - after the barrier that publishes h(t), each block forms, with one
//     read of h(t) from L2, its FC1 columns of h(t) and its hproj of the
//     next step (which needs no sample), on the tensor cores:
//     mma.sync.m16n8k16 bf16 / m16n8k32 s8 (exact int32), the batch as N
//     in tiles of 8 rows, the K range split over the warps where there are
//     fewer tiles than warps, the warps' parts added in a fixed order;
//     where there are more, a warp takes two tiles in one pass, so that
//     each A fragment it reads from shared memory feeds both;
//   - after the barrier that publishes FC1, FC2 (bf16, A fragments of
//     fc2^T in shared memory, the sampled FC1 rows staged once per block)
//     and the argmax / Gumbel sample: at B <= 8 every block computes them
//     for all rows itself (same inputs, same code, same bits), so no third
//     barrier; above, block g samples rows g, g + G, ... and a third
//     barrier publishes the samples. The Gumbel noise depends on no other
//     block: it is computed between arriving at the second barrier and
//     waiting at it;
//   - the next step's gate pass then needs only the embedding row of the
//     sample, the conditioning row (held in registers for a frame) and
//     the hproj already in shared memory.
// The grid barriers are grid_common.cuh's count on ``sync_buf``
// (count_arrive / count_wait), cheaper than cooperative_groups' grid sync;
// the cooperative launch guarantees that every block is resident. The
// product runs decode_common.cuh's tile_pass, as the dual decode's does.
// K is loaded 16 bytes a lane (8 bf16 or 16 int8) and the A operand uses
// the same permutation of K, so one vector load feeds two mma steps.
// Buffers exchanged between blocks are read with __ldcg: L1 is not
// coherent across SMs.
//
// Gumbel noise is a counter-based hash of (seed, t, b, class), so the plain
// PyTorch version (ar_decode.py:gumbel_bits) reproduces it bit for bit
// (decode_common.cuh, shared with dual_decode.cu).
//
// The kStamps variant (vq_ar_decode_stamped_launch) also records
// grid_common.cuh's PhaseStamps of each phase of every step (Phase); no
// entry point of the package launches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"
#include "grid_common.cuh"

namespace {

using namespace vq_decode;

constexpr int kMaxMt = 2;       // 16-row A tiles of a block's wh + FC1 columns
constexpr int kLoads = 8;       // K blocks whose B fragments a warp loads at once
constexpr int kPairs = 5;       // (row, unit) pairs of the gate pass a thread takes: 128 x 10 / 256
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const __nv_bfloat16* cond;   // (Tf, B, 3H) frame-rate input projection
  const void* embed;           // (C, 3H) pre-projected sample embedding, bf16 or int8
  const void* wh;              // (H, 3H) bf16 or int8
  const float* bh;             // (3H,)
  const void* fc1;             // (H, F) bf16 or int8
  const float* fc1_b;          // (F,)
  const float* embed_scale;    // (3H,) int8 mode: per-column scales
  const float* wh_scale;       // (3H,) scale / 127
  const float* fc1_scale;      // (F,) scale / 127
  const __nv_bfloat16* fc2;    // (F, C)
  const float* fc2_b;          // (C,)
  const int* prev0;            // (B,) class entering the decode
  const float* h0;             // (B, H) slot 0 of h_buf
  unsigned char* x_buf;        // (2, B, row_bytes) bf16(h) or q(h), zero beyond H
  __nv_bfloat16* hid_buf;      // (B, Fk) FC1 output, zero beyond F
  int* out;                    // (T, B) samples
  float* h_out;                // (B, H) final hidden state
  int n_steps, batch, hidden, fc, classes, hop, greedy;
  unsigned int seed;
  int units;    // hidden units per block
  int fc_cols;  // FC1 columns per block
  long long* stamps;  // kStamps: (2, 4 + n_steps * kPhases)
  unsigned int* sync;  // (1,) grid barrier count, zeroed by the caller
};

// Phases of a step that the stamped kernel times (ar_decode.py:STAMP_PHASES).
enum Phase {
  kGatePass, kBarrier1, kProduct, kReduce, kBarrier2, kFc2Stage, kFc2Product, kSample, kBarrier3,
  kPhases
};

// Bytes of one exchanged h row: H elements of the mode's type, zero-padded
// to whole K blocks (ar_decode.py:exchange_row_bytes).
__host__ __device__ __forceinline__ int row_bytes(int H, bool int8) {
  return cdiv(H * (int8 ? 1 : 2), kKBytes) * kKBytes;
}

// FC2's K (FC1 width) padded to whole bf16 K blocks.
__host__ __device__ __forceinline__ int fc_k(int F) { return cdiv(F, kKBlock) * kKBlock; }

struct DecodeLayout {
  size_t w, fc2, emb, hp, carry, part, bias, hid, scale, prev, red_v, red_i, total;
};

// Dynamic shared memory layout; the same on the host (size) and the card.
// w: the block's wh columns then FC1 columns as rows of K (plus one zero
// row for the padding of the last 16-row tile); fc2: A fragments of fc2^T
// per (16-class tile, K block, lane), two 16-byte words each; hp: hproj of
// the next step per row; carry: the f32 h of the block's units per row;
// part: one 16 x 8 tile of partial sums per task where the K range is split
// over the warps (under 8 row tiles); bias:
// the block's bh columns, its FC1 biases and all of FC2's; hid: the FC1
// rows of up to 8 sampled rows, staged once for all warps.
__host__ __device__ __forceinline__ DecodeLayout make_layout(int B, int H, int F, int C,
                                                            int units, int fc_cols, bool int8) {
  const int rb = row_bytes(H, int8), tiles = cdiv(B, kTile);
  const int mt = cdiv(3 * units + fc_cols, 16);
  DecodeLayout L;
  size_t off = 0;
  L.w = take(&off, (size_t)(3 * units + fc_cols + 1) * a_stride(rb));
  L.fc2 = take(&off, (size_t)cdiv(C, 16) * (fc_k(F) / 32) * 32 * 32);
  L.emb = take(&off, (size_t)C * 3 * units * (int8 ? 1 : 2));
  L.hp = take(&off, sizeof(float) * B * 3 * units);
  L.carry = take(&off, sizeof(float) * B * units);
  L.part = take(&off, (size_t)(tiles >= kBlockWarps ? 0 : kBlockWarps) * mt * 32 * 16);
  L.bias = take(&off, sizeof(float) * (3 * units + fc_cols + C));
  L.hid = take(&off, (size_t)kTile * a_stride(fc_k(F) * 2));
  L.scale = take(&off, int8 ? sizeof(float) * (6 * units + fc_cols) : 0);
  L.prev = take(&off, sizeof(int) * kMaxBatch);
  L.red_v = take(&off, sizeof(float) * kBlockWarps * kTile);
  L.red_i = take(&off, sizeof(int) * kBlockWarps * kTile);
  L.total = off;
  return L;
}

template <typename T>
__device__ __forceinline__ T zero_value() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ int8_t quant_h(float h) {
  return (int8_t)__float2int_rn(h * 127.f);  // round half to even, as jnp.round
}

template <bool kInt8, bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) ar_decode_kernel(DecodeArgs a) {
  using W = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  unsigned barriers = 0;  // grid barriers passed
  auto grid_sync = [&]() {
    count_arrive(a.sync);
    count_wait(a.sync, ++barriers * gridDim.x);
  };
  extern __shared__ __align__(16) unsigned char smem[];

  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, F = a.fc, C = a.classes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int blk = blockIdx.x, G = gridDim.x;
  const int u0 = blk * a.units;
  const int n_units = max(0, min(a.units, H - u0));
  const int n_cols = 3 * n_units;  // local wh column lc = gate * n_units + unit
  int n_fc = 0;
  while (n_fc < a.fc_cols && blk + n_fc * G < F) ++n_fc;
  const int m_rows = n_cols + n_fc;  // A rows: wh columns, then FC1 columns
  const int mts = cdiv(m_rows, 16);
  const int rb = row_bytes(H, kInt8), kb_count = rb / kKBytes, stride = a_stride(rb);
  const int FK = fc_k(F), fb_count = FK / 32, ct_count = cdiv(C, 16);
  const int tiles = cdiv(B, kTile);
  const int kparts = group_kparts(B);
  const int tasks = tiles * kparts;
  const bool self_sample = B <= kTile;  // every block samples every row

  const DecodeLayout L = make_layout(B, H, F, C, a.units, a.fc_cols, kInt8);
  unsigned char* w_s = smem + L.w;
  uint4* fc2_s = reinterpret_cast<uint4*>(smem + L.fc2);
  W* emb_s = reinterpret_cast<W*>(smem + L.emb);
  float* hp_s = reinterpret_cast<float*>(smem + L.hp);        // [b][lc]
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* bh_s = reinterpret_cast<float*>(smem + L.bias);  // [lc]
  float* fc1b_s = bh_s + n_cols;                           // [j]
  float* fc2b_s = fc1b_s + n_fc;                           // [c]
  unsigned char* hid_s = smem + L.hid;                     // [s][hstride]
  const int hstride = a_stride(FK * 2);
  float* wh_sc = reinterpret_cast<float*>(smem + L.scale);  // int8: [lc]
  float* emb_sc = wh_sc + n_cols;                           // int8: [lc]
  float* fc1_sc = emb_sc + n_cols;                          // int8: [j]
  int* prev_s = reinterpret_cast<int*>(smem + L.prev);
  float* red_v = reinterpret_cast<float*>(smem + L.red_v);
  int* red_i = reinterpret_cast<int*>(smem + L.red_i);
  const W* wh_g = static_cast<const W*>(a.wh);
  const W* emb_g = static_cast<const W*>(a.embed);
  const W* fc1_g = static_cast<const W*>(a.fc1);
  constexpr int kW = sizeof(W);

  // ---- Resident weights and state, loaded once. ----
  // A rows (row-major over K, zero beyond H and in the zero row m_rows).
  for (int i = tid; i < (m_rows + 1) * (rb / kW); i += kBlockThreads) {
    const int m = i / (rb / kW), k = i % (rb / kW);
    W v = zero_value<W>();
    if (k < H && m < n_cols)
      v = wh_g[(size_t)k * H3 + (m / n_units) * H + u0 + m % n_units];
    else if (k < H && m < m_rows)
      v = fc1_g[(size_t)k * F + blk + (m - n_cols) * G];
    reinterpret_cast<W*>(w_s + (size_t)m * stride)[k] = v;
  }
  // fc2^T fragments: tile ct, K block fb, lane (g, q): rows ct*16 + g and
  // + 8, K 32 fb + 8q .. + 7; zero beyond C and F. Only samplers read them.
  if (self_sample || blk < B)
    for (int i = tid; i < ct_count * fb_count * 32 * 2; i += kBlockThreads) {
      const int half = i & 1, ln = (i >> 1) & 31, fb = (i >> 6) % fb_count, ct = (i >> 6) / fb_count;
      const int c = ct * 16 + (ln >> 2) + 8 * half, k0 = fb * 32 + 8 * (ln & 3);
      uint32_t wv[4];
      for (int p = 0; p < 4; ++p) {
        uint32_t lo = 0, hi = 0;
        if (c < C && k0 + 2 * p < F) lo = __bfloat16_as_ushort(a.fc2[(size_t)(k0 + 2 * p) * C + c]);
        if (c < C && k0 + 2 * p + 1 < F)
          hi = __bfloat16_as_ushort(a.fc2[(size_t)(k0 + 2 * p + 1) * C + c]);
        wv[p] = lo | (hi << 16);
      }
      fc2_s[i] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
  for (int i = tid; i < C * n_cols; i += kBlockThreads) {
    const int c = i / n_cols, lc = i % n_cols;
    emb_s[i] = emb_g[(size_t)c * H3 + (lc / n_units) * H + u0 + lc % n_units];
  }
  if constexpr (kInt8) {
    for (int lc = tid; lc < n_cols; lc += kBlockThreads) {
      const int col = (lc / n_units) * H + u0 + lc % n_units;
      wh_sc[lc] = a.wh_scale[col];
      emb_sc[lc] = a.embed_scale[col];
    }
    for (int j = tid; j < n_fc; j += kBlockThreads) fc1_sc[j] = a.fc1_scale[blk + j * G];
  }
  for (int lc = tid; lc < n_cols; lc += kBlockThreads)
    bh_s[lc] = a.bh[(lc / n_units) * H + u0 + lc % n_units];
  for (int j = tid; j < n_fc; j += kBlockThreads) fc1b_s[j] = a.fc1_b[blk + j * G];
  for (int c = tid; c < C; c += kBlockThreads) fc2b_s[c] = a.fc2_b[c];
  for (int b = tid; b < B; b += kBlockThreads) prev_s[b] = min(max(a.prev0[b], 0), C - 1);
  // h0: the f32 carry of this block's units, and its bf16 / q row in slot 0.
  for (int i = tid; i < B * n_units; i += kBlockThreads) {
    const int b = i / n_units, u = i % n_units, j = u0 + u;
    const float h = a.h0[(size_t)b * H + j];
    carry_s[b * a.units + u] = h;
    if constexpr (kInt8)
      reinterpret_cast<int8_t*>(a.x_buf + (size_t)b * rb)[j] = quant_h(h);
    else
      reinterpret_cast<__nv_bfloat16*>(a.x_buf + (size_t)b * rb)[j] = __float2bfloat16(h);
  }
  grid_sync();

  PhaseStamps<kPhases> st;
  // One output of the product, row b, A row m (int8: the int32 sum's bits):
  // hproj of the next step, or FC1 through ReLU into hid_buf.
  auto emit = [&](int b, int m, float sum) {
    float v = sum;
    if constexpr (kInt8)
      v = __fmul_rn(__int2float_rn(__float_as_int(sum)), m < n_cols ? wh_sc[m] : fc1_sc[m - n_cols]);
    if (m < n_cols) {
      hp_s[b * n_cols + m] = v;
    } else {
      const int col = blk + (m - n_cols) * G;
      a.hid_buf[(size_t)b * FK + col] = __float2bfloat16(fmaxf(v + fc1b_s[m - n_cols], 0.f));
    }
  };
  // The product of the A rows with the h rows of slot ``slot``: hproj of
  // the next step into hp_s and, where ``fc1``, FC1 into hid_buf. Under 8
  // row tiles (B <= 56) the K range is split over the warps; above
  // kBlockWarps row tiles (B > 64) a warp takes tiles w and w + kBlockWarps
  // in one pass, which halves the block's reads of A from shared memory.
  auto product = [&](int slot, bool fc1) {
    const unsigned char* xs = a.x_buf + (size_t)slot * B * rb;
    auto load = [&](int n, int kb) {
      return __ldcg(reinterpret_cast<const uint4*>(xs + (size_t)n * rb + kb * kKBytes) + q);
    };
    // One task's pass (NT 2: tasks task and task + kBlockWarps): whole K
    // ranges give final sums; split ones their part of each 16 x 8 tile, to
    // part_s. Its K range is worked out inside each NT's instance: shared by
    // the two, it cost the kernel some 80 registers (nvcc 12.9, sm_90a).
    auto pass = [&](auto nt, int task) {
      constexpr int NT = decltype(nt)::value;
      const int tile = task / kparts, kp = task % kparts;
      const int kb_lo = kp * kb_count / kparts, kb_hi = (kp + 1) * kb_count / kparts;
      const auto sums = tile_pass<NT, kMaxMt, kLoads, kInt8, false>(
          w_s, stride, m_rows, 0, mts, tile, B, kb_lo, kb_hi, load, st, 0);
      if (kparts == 1) {
        emit_chains<kInt8>(sums, 0, mts, tile, B, m_rows, [&](int b, int m, float v) {
          if (fc1 || m < n_cols) emit(b, m, v);
        });
        return;
      }
      if constexpr (NT == 1) {
#pragma unroll
        for (int mt = 0; mt < kMaxMt; ++mt)
          if (mt < mts) {
            const float(&c)[2][4] = sums.c[0][mt];
            reinterpret_cast<float4*>(part_s)[(task * mts + mt) * 32 + lane] = make_float4(
                add_chains<kInt8>(c[0][0], c[1][0]), add_chains<kInt8>(c[0][1], c[1][1]),
                add_chains<kInt8>(c[0][2], c[1][2]), add_chains<kInt8>(c[0][3], c[1][3]));
          }
      }
    };
    for (int task = warp; task < tasks; task += kBlockWarps) {
      if (kparts == 1 && task + kBlockWarps < tasks) {
        pass(std::integral_constant<int, 2>(), task);
        task += kBlockWarps;
      } else {
        pass(std::integral_constant<int, 1>(), task);
      }
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kProduct);
    if (kparts == 1) return;
    // Each (row, A row) output: its K parts added in order.
    for (int i = tid; i < B * m_rows; i += kBlockThreads) {
      const int b = i / m_rows, m = i % m_rows;
      if (m >= n_cols && !fc1) continue;
      const int tile = b / kTile, n = b % kTile, mt = m / 16, mm = m % 16;
      const int ln = (mm % 8) * 4 + n / 2, e = (mm / 8) * 2 + (n & 1);
      const float* p = part_s + ((size_t)(tile * kparts) * mts + mt) * 128 + ln * 4 + e;
      float v = 0.f;
      if constexpr (kInt8) {
        int sum = 0;
#pragma unroll
        for (int k = 0; k < kBlockWarps; ++k)
          if (k < kparts) sum += __float_as_int(p[(size_t)k * mts * 128]);
        v = __int_as_float(sum);
      } else {
#pragma unroll
        for (int k = 0; k < kBlockWarps; ++k)
          if (k < kparts) v += p[(size_t)k * mts * 128];
      }
      emit(b, m, v);
    }
  };
  product(0, false);  // hproj of step 0
  __syncthreads();

  // The gate pass's (row, unit) pairs of this thread (row -1: none) and
  // their conditioning inputs, reloaded once per frame.
  int pb[kPairs], pu[kPairs];
  float cx[kPairs][3];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = tid + k * kBlockThreads;
    pb[k] = i < B * n_units ? i / n_units : -1;
    pu[k] = i < B * n_units ? i % n_units : 0;
  }

  const uint32_t seed_key = mix32(a.seed);
  if constexpr (kStamps) st.open(a.stamps, a.n_steps);
  for (int t = 0; t < a.n_steps; ++t) {
    if constexpr (kStamps) st.begin_step();
    const int f = t / a.hop;
    unsigned char* x_nxt = a.x_buf + (size_t)((t + 1) & 1) * B * rb;

    // ---- Gate pass: this block's units of h(t), from prev(t - 1). ----
    if (t % a.hop == 0)  // a new frame: this thread's conditioning inputs
#pragma unroll
      for (int k = 0; k < kPairs; ++k)
        if (pb[k] >= 0) {
          const __nv_bfloat16* crow = a.cond + ((size_t)f * B + pb[k]) * H3 + u0 + pu[k];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) cx[k][gate] = __bfloat162float(crow[gate * H]);
        }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (pb[k] < 0) continue;
      const int b = pb[k], u = pu[k], j = u0 + u;
      const W* erow = emb_s + (size_t)prev_s[b] * n_cols;
      const float* hp = hp_s + b * n_cols;
      float xr, xz, xn;
      if constexpr (kInt8) {
        xr = __fadd_rn(__fmul_rn((float)erow[u], emb_sc[u]), cx[k][0]);
        xz = __fadd_rn(__fmul_rn((float)erow[n_units + u], emb_sc[n_units + u]), cx[k][1]);
        xn = __fadd_rn(__fmul_rn((float)erow[2 * n_units + u], emb_sc[2 * n_units + u]),
                       cx[k][2]);
      } else {
        xr = __bfloat162float(erow[u]) + cx[k][0];
        xz = __bfloat162float(erow[n_units + u]) + cx[k][1];
        xn = __bfloat162float(erow[2 * n_units + u]) + cx[k][2];
      }
      const float hr = hp[u] + bh_s[u];
      const float hz = hp[n_units + u] + bh_s[n_units + u];
      const float hn = hp[2 * n_units + u] + bh_s[2 * n_units + u];
      const float r = __frcp_rn(1.f + expf(-(xr + hr)));
      const float z = __frcp_rn(1.f + expf(-(xz + hz)));
      const float n = tanhf(xn + r * hn);
      const float h_new = (1.f - z) * n + z * carry_s[b * a.units + u];
      carry_s[b * a.units + u] = h_new;
      if constexpr (kInt8)
        reinterpret_cast<int8_t*>(x_nxt + (size_t)b * rb)[j] = quant_h(h_new);
      else
        reinterpret_cast<__nv_bfloat16*>(x_nxt + (size_t)b * rb)[j] = __float2bfloat16(h_new);
      if (t == a.n_steps - 1) a.h_out[(size_t)b * H + j] = h_new;
    }
    if constexpr (kStamps) st.mark(kGatePass);
    grid_sync();
    if constexpr (kStamps) st.mark(kBarrier1);

    // ---- h(t) x [wh | FC1] columns: hproj(t + 1) and FC1(t). ----
    product((t + 1) & 1, true);
    if constexpr (kStamps) st.mark(kReduce);
    // ---- FC2 + sample: every block for B <= 8, else block g for rows g + iG. ----
    // The Gumbel noise of the first 8 sampled rows needs no other block's
    // writes: it is computed between arriving at the barrier and waiting.
    const int n_sample = self_sample ? B : (blk < B ? cdiv(B - blk, G) : 0);
    const uint32_t step_key = mix32(seed_key ^ (uint32_t)t);
    auto row_of = [&](int s) { return self_sample ? s : blk + s * G; };
    float noise[2][4];
    auto noise_of = [&](int s0, int cnt) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cls = (warp + j * kBlockWarps) * 16 + g + 8 * (e >> 1), s = 2 * q + (e & 1);
          noise[j][e] = !a.greedy && cls < C && s < cnt ? gumbel(step_key, row_of(s0 + s), cls, C)
                                                         : 0.f;
        }
    };
    count_arrive(a.sync);
    noise_of(0, min(kTile, n_sample));
    count_wait(a.sync, ++barriers * gridDim.x);
    if constexpr (kStamps) st.mark(kBarrier2);

    for (int s0 = 0; s0 < n_sample; s0 += kTile) {
      const int cnt = min(kTile, n_sample - s0);
      float best_v[2] = {-INFINITY, -INFINITY};
      int best_i[2] = {0x7fffffff, 0x7fffffff};
      if (s0 > 0) noise_of(s0, cnt);
      // The cnt FC1 rows, staged once for all warps (16 bytes a thread).
      const int chunks = FK * 2 / 16;
      for (int i = tid; i < cnt * chunks; i += kBlockThreads)
        *reinterpret_cast<uint4*>(hid_s + (size_t)(i / chunks) * hstride + (i % chunks) * 16) =
            __ldcg(reinterpret_cast<const uint4*>(a.hid_buf + (size_t)row_of(s0 + i / chunks) * FK) +
                   i % chunks);
      __syncthreads();
      if constexpr (kStamps) st.mark(kFc2Stage);
      // This warp's class tiles ct = warp and warp + 8 (C <= 256).
      float c[2][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][0][e] = c[j][1][e] = 0.f;
      const uint4* frag = fc2_s + (size_t)warp * fb_count * 64 + lane * 2;
      const size_t frag_next = (size_t)kBlockWarps * fb_count * 64;
      const bool second = warp + kBlockWarps < ct_count;
      const unsigned char* hrow = hid_s + (size_t)g * hstride + q * 16;
      if (warp < ct_count)
        for (int fb0 = 0; fb0 < fb_count; fb0 += kLoads) {
#pragma unroll
          for (int i = 0; i < kLoads; ++i) {
            const int fb = fb0 + i;
            if (fb < fb_count) {
              const uint4 bv = g < cnt ? *reinterpret_cast<const uint4*>(hrow + fb * kKBytes)
                                       : make_uint4(0, 0, 0, 0);
              mma_k32(c[0][0], c[0][1], frag[fb * 64], frag[fb * 64 + 1], bv);
              if (second)
                mma_k32(c[1][0], c[1][1], frag[frag_next + fb * 64],
                                 frag[frag_next + fb * 64 + 1], bv);
            }
          }
        }
      if constexpr (kStamps) st.mark(kFc2Product);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cls = (warp + j * kBlockWarps) * 16 + g + 8 * (e >> 1), s = 2 * q + (e & 1);
          if (cls >= C || s >= cnt) continue;
          // As the plain version: logits, then the noise added.
          float score = (c[j][0][e] + c[j][1][e]) + fc2b_s[cls];
          if (!a.greedy) score = score + noise[j][e];
          if (better(score, cls, best_v[e & 1], best_i[e & 1])) {
            best_v[e & 1] = score;
            best_i[e & 1] = cls;
          }
        }
      // Across the 8 lanes of one q (the classes), then across the warps.
#pragma unroll
      for (int k = 0; k < 2; ++k)
        for (int o = 4; o < 32; o <<= 1) {
          const float ov = __shfl_xor_sync(kFull, best_v[k], o);
          const int oi = __shfl_xor_sync(kFull, best_i[k], o);
          if (better(ov, oi, best_v[k], best_i[k])) {
            best_v[k] = ov;
            best_i[k] = oi;
          }
        }
      if (g == 0)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          red_v[warp * kTile + 2 * q + k] = best_v[k];
          red_i[warp * kTile + 2 * q + k] = best_i[k];
        }
      __syncthreads();
      if (tid < cnt) {
        float bv = red_v[tid];
        int bi = red_i[tid];
        for (int w = 1; w < kBlockWarps; ++w)
          if (better(red_v[w * kTile + tid], red_i[w * kTile + tid], bv, bi)) {
            bv = red_v[w * kTile + tid];
            bi = red_i[w * kTile + tid];
          }
        const int b = row_of(s0 + tid);
        if (self_sample) prev_s[b] = min(max(bi, 0), C - 1);
        if (!self_sample || blk == 0) __stcg(a.out + (size_t)t * B + b, bi);
      }
      __syncthreads();
    }
    if constexpr (kStamps) st.mark(kSample);
    if (!self_sample) {
      grid_sync();
      for (int b = tid; b < B; b += kBlockThreads)
        prev_s[b] = min(max(__ldcg(a.out + (size_t)t * B + b), 0), C - 1);
      __syncthreads();
    }
    if constexpr (kStamps) {
      st.mark(kBarrier3);
      st.end_step(t);
    }
  }
  if constexpr (kStamps) st.close();
}

struct Plan {
  int grid, units, fc_cols;
  DecodeLayout layout;
  const void* kernel;
};

cudaError_t plan_launch(int batch, int hidden, int fc, int classes, int int8, bool stamps,
                        Plan* p) {
  if (batch < 1 || batch > kMaxBatch || hidden < 1 || fc < 1 || classes < 1)
    return cudaErrorInvalidValue;
  int sms, max_smem;
  const cudaError_t err = device_limits(&sms, &max_smem);
  if (err != cudaSuccess) return err;
  p->units = cdiv(hidden, sms);
  p->grid = cdiv(hidden, p->units);
  p->fc_cols = cdiv(fc, p->grid);
  if (3 * p->units + p->fc_cols > 16 * kMaxMt || classes > 16 * 2 * kBlockWarps)
    return cudaErrorInvalidValue;
  p->layout = make_layout(batch, hidden, fc, classes, p->units, p->fc_cols, int8 != 0);
  if (stamps)
    p->kernel = int8 ? (const void*)ar_decode_kernel<true, true>
                     : (const void*)ar_decode_kernel<false, true>;
  else
    p->kernel = int8 ? (const void*)ar_decode_kernel<true, false>
                     : (const void*)ar_decode_kernel<false, false>;
  if (p->layout.total > (size_t)max_smem) return cudaErrorInvalidValue;
  return ready_resident(p->kernel, p->layout.total, p->grid, sms, kBlockThreads);
}

}  // namespace

extern "C" {

// Grid size, hidden units per block and dynamic shared memory bytes that a
// launch at these widths and in this mode (``int8`` 0: bf16) uses; returns
// a cudaError_t.
int vq_ar_decode_plan(int batch, int hidden, int fc, int classes, int int8, int* out3) {
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, fc, classes, int8, false, &p);
  if (err != cudaSuccess) return (int)err;
  out3[0] = p.grid;
  out3[1] = p.units;
  out3[2] = (int)p.layout.total;
  return 0;
}

// The decode with ``stamps`` non-null: the kernel variant that records
// per-phase clock64 counts of two blocks into ``stamps`` (int64, 2 x (4 +
// n_steps x kPhases), zeroed by the caller; grid_common.cuh PhaseStamps).
// With ``stamps`` null, the plain kernel: vq_ar_decode_launch.
int vq_ar_decode_stamped_launch(const void* cond, const void* embed, const void* wh,
                                const void* bh, const void* fc1, const void* fc1_b,
                                const void* fc2, const void* fc2_b, const void* prev0,
                                const void* embed_scale, const void* wh_scale,
                                const void* fc1_scale, void* h_buf, void* x_buf,
                                void* hid_buf, void* out, void* h_out, void* sync_buf,
                                int n_steps, int batch, int hidden, int fc, int classes,
                                int hop, int greedy, int int8, unsigned int seed,
                                void* stamps, void* stream) {
  if (n_steps < 1 || hop < 1 || x_buf == nullptr || sync_buf == nullptr)
    return (int)cudaErrorInvalidValue;
  if (int8 && (embed_scale == nullptr || wh_scale == nullptr || fc1_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, fc, classes, int8, stamps != nullptr, &p);
  if (err != cudaSuccess) return (int)err;
  DecodeArgs a;
  a.cond = static_cast<const __nv_bfloat16*>(cond);
  a.embed = embed;
  a.wh = wh;
  a.bh = static_cast<const float*>(bh);
  a.fc1 = fc1;
  a.fc1_b = static_cast<const float*>(fc1_b);
  a.embed_scale = static_cast<const float*>(embed_scale);
  a.wh_scale = static_cast<const float*>(wh_scale);
  a.fc1_scale = static_cast<const float*>(fc1_scale);
  a.fc2 = static_cast<const __nv_bfloat16*>(fc2);
  a.fc2_b = static_cast<const float*>(fc2_b);
  a.prev0 = static_cast<const int*>(prev0);
  a.h0 = static_cast<const float*>(h_buf);
  a.x_buf = static_cast<unsigned char*>(x_buf);
  a.hid_buf = static_cast<__nv_bfloat16*>(hid_buf);
  a.out = static_cast<int*>(out);
  a.h_out = static_cast<float*>(h_out);
  a.n_steps = n_steps;
  a.batch = batch;
  a.hidden = hidden;
  a.fc = fc;
  a.classes = classes;
  a.hop = hop;
  a.greedy = greedy;
  a.seed = seed;
  a.units = p.units;
  a.fc_cols = p.fc_cols;
  a.stamps = static_cast<long long*>(stamps);
  a.sync = static_cast<unsigned int*>(sync_buf);
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(kBlockThreads), params,
                              p.layout.total, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Launches the decode on ``stream``. ``int8`` 0 decodes in bf16 (embed, wh,
// fc1 bf16; the scales are not read and may be null); 1 in int8 (embed,
// wh, fc1 int8 with their scales). ``h_buf`` (B, H) f32 holds h0;
// ``x_buf`` (2, B, row bytes) the exchanged h rows (bf16 or int8, zeroed by
// the caller: the padding beyond H stays zero); ``hid_buf`` (B, F padded
// to 32) bf16, zeroed; ``sync_buf`` one uint32, zeroed: the grid barrier's
// count. Allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch.
int vq_ar_decode_launch(const void* cond, const void* embed, const void* wh,
                        const void* bh, const void* fc1, const void* fc1_b,
                        const void* fc2, const void* fc2_b, const void* prev0,
                        const void* embed_scale, const void* wh_scale,
                        const void* fc1_scale, void* h_buf, void* x_buf,
                        void* hid_buf, void* out, void* h_out, void* sync_buf,
                        int n_steps, int batch, int hidden, int fc, int classes,
                        int hop, int greedy, int int8, unsigned int seed,
                        void* stream) {
  return vq_ar_decode_stamped_launch(cond, embed, wh, bh, fc1, fc1_b, fc2, fc2_b, prev0,
                                     embed_scale, wh_scale, fc1_scale, h_buf, x_buf, hid_buf,
                                     out, h_out, sync_buf, n_steps, batch, hidden, fc, classes,
                                     hop, greedy, int8, seed, nullptr, stream);
}

const char* vq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
