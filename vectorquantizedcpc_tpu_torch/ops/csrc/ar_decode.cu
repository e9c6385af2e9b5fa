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
// sample-to-sample dependency. The TPU kernel keeps every weight in one
// core's VMEM. One H100 block holds at most 227 KB of shared memory, so the
// weights are spread over the SMs instead:
//   - a persistent cooperative grid, one block per SM, loops over all steps;
//   - block j owns hidden units [j*U, (j+1)*U) and keeps their r/z/n columns
//     of wh and of embed_proj in shared memory for the whole decode;
//   - block j also keeps FC1 columns j, j+G, ... ; blocks 0..min(B, G)-1
//     keep all of FC2 and block g samples batch rows g, g+G, ...;
//   - three grid barriers per step: after the gate phase (new h), after FC1
//     (hidden activations), after FC2 + sample (the next step's prev).
// Batches of up to kMaxBatch rows: the gate and FC1 phases walk the rows in
// tiles of kTile, staging one tile's bf16(h) and prev at a time, so shared
// memory holds one tile's h, prev and hproj whatever the batch. At
// B <= kTile there is one tile, and the arithmetic is that of an 8-row
// kernel.
// Buffers exchanged between blocks are read with __ldcg and written with
// __stcg: L1 is not coherent across SMs. bf16: plain FMA loops. int8: the
// block's weight columns sit in shared memory as int8 (~26 KB instead of
// ~52 KB at the reference widths; FC2 stays bf16), the staged h tile is q(h)
// as int8 (K zero-padded to a multiple of 4), and each lane takes 4 K values
// per __dp4a into an int32, exact and in no particular order, scaled once.
// The gate phase also writes q(h_new) beside the f32 h, so that the FC1
// phase and the next gate phase stage 1 byte per element instead of 4; only
// step 0 quantizes the f32 h0.
// No mma, wgmma or TMA.
//
// Gumbel noise is a counter-based hash of (seed, t, b, class), so the plain
// PyTorch version (ar_decode.py:gumbel_bits) reproduces it bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;         // batch rows staged at once
constexpr int kMaxBatch = 128;   // rows of one launch (the JAX kernel's largest)
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
  float* h_buf;                // (2, B, H); slot 0 holds h0 on entry
  int8_t* hq_buf;              // (2, B, Hq) int8 mode: q(h), zero beyond H
  float* hid_buf;              // (B, F) FC1 output exchanged between blocks
  int* out;                    // (T, B) samples
  float* h_out;                // (B, H) final hidden state
  int n_steps, batch, hidden, fc, classes, hop, greedy;
  unsigned int seed;
  int units;    // hidden units per block
  int fc_cols;  // FC1 columns per block
};

struct Layout {
  size_t hproj, hid, red_v, red_i, prev, wh, emb, fc1, fc2, h, scale, total;
};

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// The K extent of one int8 row or column: H zero-padded to whole __dp4a words.
__host__ __device__ __forceinline__ int quant_k(int H) { return (H + 3) / 4 * 4; }

// Dynamic shared memory layout; the same on the host (size) and the card.
// int8 mode keeps wh, embed and fc1 as int8 and the h tile as q(h), their
// K extent padded to quant_k(H), and the block's columns' scales (wh and
// embed per local column, fc1 per FC1 column).
__host__ __device__ __forceinline__ Layout make_layout(int H, int F, int C,
                                                      int units, int fc_cols, bool int8) {
  const size_t w = int8 ? 1 : sizeof(__nv_bfloat16);
  const int K = int8 ? quant_k(H) : H;
  Layout L;
  size_t off = 0;
  L.hproj = take(&off, sizeof(float) * kTile * 3 * units);
  L.hid = take(&off, sizeof(float) * F);
  L.red_v = take(&off, sizeof(float) * kWarps);
  L.red_i = take(&off, sizeof(int) * kWarps);
  L.prev = take(&off, sizeof(int) * kTile);
  L.wh = take(&off, w * 3 * units * K);
  L.emb = take(&off, w * C * 3 * units);
  L.fc1 = take(&off, w * fc_cols * K);
  L.fc2 = take(&off, sizeof(__nv_bfloat16) * F * C);
  L.h = take(&off, w * kTile * K);
  L.scale = take(&off, int8 ? sizeof(float) * (6 * units + fc_cols) : 0);
  L.total = off;
  return L;
}

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// acc[b] = sum_k bf16(x[b, k]) * w[k] for the B <= kTile rows of a tile,
// over one warp, lanes striding k.
__device__ __forceinline__ void warp_dot_rows(
    const __nv_bfloat16* x, const __nv_bfloat16* w, int H, int B, int lane,
    float acc[kTile]) {
#pragma unroll
  for (int b = 0; b < kTile; ++b) acc[b] = 0.f;
  for (int k = lane; k < H; k += 32) {
    const float wv = __bfloat162float(w[k]);
#pragma unroll
    for (int b = 0; b < kTile; ++b)
      if (b < B) acc[b] = fmaf(__bfloat162float(x[b * H + k]), wv, acc[b]);
  }
#pragma unroll
  for (int b = 0; b < kTile; ++b)
    for (int o = 16; o > 0; o >>= 1)
      acc[b] += __shfl_xor_sync(kFull, acc[b], o);
}

// acc[b] = sum_k x[b, k] * w[k] in int32 for the B <= kTile int8 rows of a
// tile (rows Kq apart, Kq a multiple of 4), over one warp, lanes striding
// 4-byte words; exact, so the order does not matter.
__device__ __forceinline__ void warp_dot_rows_q(const int8_t* x, const int8_t* w, int Kq, int B,
                                                int lane, int acc[kTile]) {
  const int* x4 = reinterpret_cast<const int*>(x);
  const int* w4 = reinterpret_cast<const int*>(w);
  const int words = Kq / 4;
#pragma unroll
  for (int b = 0; b < kTile; ++b) acc[b] = 0;
  for (int k = lane; k < words; k += 32) {
    const int wv = w4[k];
#pragma unroll
    for (int b = 0; b < kTile; ++b)
      if (b < B) acc[b] = __dp4a(x4[b * words + k], wv, acc[b]);
  }
#pragma unroll
  for (int b = 0; b < kTile; ++b)
    for (int o = 16; o > 0; o >>= 1)
      acc[b] += __shfl_xor_sync(kFull, acc[b], o);
}

__device__ __forceinline__ int8_t quant_h(float h) {
  return (int8_t)__float2int_rn(h * 127.f);  // round half to even, as jnp.round
}

// rows x Kq int8 of q(h) into the tile ``hq_s``: from the q(h) buffer
// ``hq`` where it is given, else quantized from the f32 ``h`` (rows H
// apart), zero beyond H.
__device__ __forceinline__ void stage_q_rows(int8_t* hq_s, const int8_t* hq, const float* h,
                                             int rows, int H, int Kq) {
  if (hq != nullptr && Kq % 16 == 0) {  // 16-byte copies (the rows start 16-byte aligned)
    const int4* src = reinterpret_cast<const int4*>(hq);
    int4* dst = reinterpret_cast<int4*>(hq_s);
    for (int i = threadIdx.x; i < rows * Kq / 16; i += kThreads) dst[i] = __ldcg(src + i);
  } else if (hq != nullptr) {
    const int* src = reinterpret_cast<const int*>(hq);
    int* dst = reinterpret_cast<int*>(hq_s);
    for (int i = threadIdx.x; i < rows * Kq / 4; i += kThreads) dst[i] = __ldcg(src + i);
  } else {
    for (int i = threadIdx.x; i < rows * Kq; i += kThreads) {
      const int r = i / Kq, k = i - r * Kq;
      hq_s[i] = k < H ? quant_h(__ldcg(h + (size_t)r * H + k)) : (int8_t)0;
    }
  }
}

template <typename T>
__device__ __forceinline__ T zero_value() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1) ar_decode_kernel(DecodeArgs a) {
  using W = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];

  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, F = a.fc,
            C = a.classes;
  const int K = kInt8 ? quant_k(H) : H;  // extent of a weight column and an h row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, G = gridDim.x;
  const int u0 = blk * a.units;
  const int n_units = max(0, min(a.units, H - u0));
  const int n_cols = 3 * n_units;  // local column lc = gate * n_units + unit
  const int hp_stride = 3 * a.units;
  int n_fc = 0;
  while (n_fc < a.fc_cols && blk + n_fc * G < F) ++n_fc;

  const Layout L = make_layout(H, F, C, a.units, a.fc_cols, kInt8);
  float* hproj_s = reinterpret_cast<float*>(smem + L.hproj);
  float* hid_s = reinterpret_cast<float*>(smem + L.hid);
  float* red_v = reinterpret_cast<float*>(smem + L.red_v);
  int* red_i = reinterpret_cast<int*>(smem + L.red_i);
  int* prev_s = reinterpret_cast<int*>(smem + L.prev);
  W* wh_s = reinterpret_cast<W*>(smem + L.wh);
  W* emb_s = reinterpret_cast<W*>(smem + L.emb);
  W* fc1_s = reinterpret_cast<W*>(smem + L.fc1);
  __nv_bfloat16* fc2_s = reinterpret_cast<__nv_bfloat16*>(smem + L.fc2);
  W* h_s = reinterpret_cast<W*>(smem + L.h);
  float* wh_sc = reinterpret_cast<float*>(smem + L.scale);  // int8: [lc]
  float* emb_sc = wh_sc + 3 * a.units;                       // int8: [lc]
  float* fc1_sc = emb_sc + 3 * a.units;                      // int8: [j]
  const W* wh_g = static_cast<const W*>(a.wh);
  const W* emb_g = static_cast<const W*>(a.embed);
  const W* fc1_g = static_cast<const W*>(a.fc1);
  const W zero = zero_value<W>();

  // Resident weights, loaded once. wh and fc1 columns are stored
  // transposed (column-major) so that lanes striding k hit distinct banks;
  // K beyond H is zero.
  for (int i = tid; i < n_cols * K; i += kThreads) {
    const int k = i / n_cols, lc = i % n_cols;
    const int col = (lc / n_units) * H + u0 + lc % n_units;
    wh_s[lc * K + k] = k < H ? wh_g[(size_t)k * H3 + col] : zero;
  }
  for (int i = tid; i < C * n_cols; i += kThreads) {
    const int c = i / n_cols, lc = i % n_cols;
    const int col = (lc / n_units) * H + u0 + lc % n_units;
    emb_s[i] = emb_g[(size_t)c * H3 + col];
  }
  for (int i = tid; i < n_fc * K; i += kThreads) {
    const int k = i / n_fc, j = i % n_fc;
    fc1_s[j * K + k] = k < H ? fc1_g[(size_t)k * F + blk + j * G] : zero;
  }
  if (blk < B)  // this block samples rows blk, blk + G, ...
    for (int i = tid; i < F * C; i += kThreads) fc2_s[i] = a.fc2[i];
  if constexpr (kInt8) {
    for (int lc = tid; lc < n_cols; lc += kThreads) {
      const int col = (lc / n_units) * H + u0 + lc % n_units;
      wh_sc[lc] = a.wh_scale[col];
      emb_sc[lc] = a.embed_scale[col];
    }
    for (int j = tid; j < n_fc; j += kThreads) fc1_sc[j] = a.fc1_scale[blk + j * G];
  }
  __syncthreads();

  const uint32_t seed_key = mix32(a.seed);
  for (int t = 0; t < a.n_steps; ++t) {
    const int f = t / a.hop;
    const float* h_cur = a.h_buf + (size_t)(t & 1) * B * H;
    float* h_nxt = a.h_buf + (size_t)((t + 1) & 1) * B * H;
    const int8_t* hq_cur = kInt8 ? a.hq_buf + (size_t)(t & 1) * B * K : nullptr;
    int8_t* hq_nxt = kInt8 ? a.hq_buf + (size_t)((t + 1) & 1) * B * K : nullptr;

    // ---- Gate phase: this block's slice of the new hidden state. ----
    if (n_units > 0) {
      for (int r0 = 0; r0 < B; r0 += kTile) {
        const int rows = min(kTile, B - r0);
        if (r0 > 0) __syncthreads();  // the last tile's prev_s is read
        if constexpr (kInt8) {
          // q(h0) is not in the buffer: step 0 quantizes the f32 h.
          stage_q_rows(h_s, t > 0 ? hq_cur + (size_t)r0 * K : nullptr,
                       h_cur + (size_t)r0 * H, rows, H, K);
        } else {
          for (int i = tid; i < rows * H; i += kThreads)
            h_s[i] = __float2bfloat16(__ldcg(h_cur + (size_t)r0 * H + i));
        }
        if (tid < rows) {
          const int b = r0 + tid;
          const int p = t == 0 ? a.prev0[b] : __ldcg(a.out + (size_t)(t - 1) * B + b);
          prev_s[tid] = min(max(p, 0), C - 1);
        }
        __syncthreads();
        for (int lc = warp; lc < n_cols; lc += kWarps) {
          if constexpr (kInt8) {
            int acc[kTile];
            warp_dot_rows_q(h_s, wh_s + (size_t)lc * K, K, rows, lane, acc);
            if (lane == 0) {
              const float sc = wh_sc[lc];
#pragma unroll
              for (int b = 0; b < kTile; ++b)
                if (b < rows) hproj_s[b * hp_stride + lc] = __fmul_rn(__int2float_rn(acc[b]), sc);
            }
          } else {
            float acc[kTile];
            warp_dot_rows(h_s, wh_s + (size_t)lc * H, H, rows, lane, acc);
            if (lane == 0)
#pragma unroll
              for (int b = 0; b < kTile; ++b)
                if (b < rows) hproj_s[b * hp_stride + lc] = acc[b];
          }
        }
        __syncthreads();
        for (int i = tid; i < rows * n_units; i += kThreads) {
          const int rb = i / n_units, b = r0 + rb, u = i % n_units, j = u0 + u;
          const __nv_bfloat16* crow = a.cond + ((size_t)f * B + b) * H3;
          const W* erow = emb_s + (size_t)prev_s[rb] * n_cols;
          const float* hp = hproj_s + rb * hp_stride;
          float xr, xz, xn;
          if constexpr (kInt8) {
            xr = __fadd_rn(__fmul_rn((float)erow[u], emb_sc[u]), __bfloat162float(crow[j]));
            xz = __fadd_rn(__fmul_rn((float)erow[n_units + u], emb_sc[n_units + u]),
                           __bfloat162float(crow[H + j]));
            xn = __fadd_rn(__fmul_rn((float)erow[2 * n_units + u], emb_sc[2 * n_units + u]),
                           __bfloat162float(crow[2 * H + j]));
          } else {
            xr = __bfloat162float(erow[u]) + __bfloat162float(crow[j]);
            xz = __bfloat162float(erow[n_units + u]) + __bfloat162float(crow[H + j]);
            xn = __bfloat162float(erow[2 * n_units + u]) + __bfloat162float(crow[2 * H + j]);
          }
          const float hr = hp[u] + a.bh[j];
          const float hz = hp[n_units + u] + a.bh[H + j];
          const float hn = hp[2 * n_units + u] + a.bh[2 * H + j];
          const float r = 1.f / (1.f + expf(-(xr + hr)));
          const float z = 1.f / (1.f + expf(-(xz + hz)));
          const float n = tanhf(xn + r * hn);
          const float h_new = (1.f - z) * n + z * __ldcg(h_cur + b * H + j);
          __stcg(h_nxt + b * H + j, h_new);
          if constexpr (kInt8) hq_nxt[(size_t)b * K + j] = quant_h(h_new);
          if (t == a.n_steps - 1) a.h_out[b * H + j] = h_new;
        }
      }
    }
    grid.sync();

    // ---- FC1 phase: this block's FC1 columns for every row. ----
    if (n_fc > 0) {
      for (int r0 = 0; r0 < B; r0 += kTile) {
        const int rows = min(kTile, B - r0);
        if (r0 > 0) __syncthreads();  // the last tile's h_s is read
        if constexpr (kInt8) {
          stage_q_rows(h_s, hq_nxt + (size_t)r0 * K,
                       h_nxt + (size_t)r0 * H, rows, H, K);
        } else {
          for (int i = tid; i < rows * H; i += kThreads)
            h_s[i] = __float2bfloat16(__ldcg(h_nxt + (size_t)r0 * H + i));
        }
        __syncthreads();
        for (int j = warp; j < n_fc; j += kWarps) {
          const int col = blk + j * G;
          float acc[kTile];
          if constexpr (kInt8) {
            int acc_q[kTile];
            warp_dot_rows_q(h_s, fc1_s + (size_t)j * K, K, rows, lane, acc_q);
#pragma unroll
            for (int b = 0; b < kTile; ++b)
              acc[b] = __fmul_rn(__int2float_rn(acc_q[b]), fc1_sc[j]);
          } else {
            warp_dot_rows(h_s, fc1_s + (size_t)j * H, H, rows, lane, acc);
          }
          if (lane == 0)
#pragma unroll
            for (int b = 0; b < kTile; ++b)
              if (b < rows) {
                const float v = fmaxf(acc[b] + a.fc1_b[col], 0.f);
                __stcg(a.hid_buf + (r0 + b) * F + col,
                       __bfloat162float(__float2bfloat16(v)));
              }
        }
      }
    }
    grid.sync();

    // ---- FC2 + sample phase: block g takes batch rows g, g + G, .... ----
    for (int b = blk; b < B; b += G) {
      if (b > blk) __syncthreads();  // the last row's hid_s and red_* are read
      for (int i = tid; i < F; i += kThreads) hid_s[i] = __ldcg(a.hid_buf + b * F + i);
      __syncthreads();
      const uint32_t step_key = mix32(seed_key ^ (uint32_t)t);
      float best_v = -INFINITY;
      int best_i = 0x7fffffff;
      for (int c = tid; c < C; c += kThreads) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int k = 0;
        for (; k + 4 <= F; k += 4) {
          s0 = fmaf(hid_s[k], __bfloat162float(fc2_s[k * C + c]), s0);
          s1 = fmaf(hid_s[k + 1], __bfloat162float(fc2_s[(k + 1) * C + c]), s1);
          s2 = fmaf(hid_s[k + 2], __bfloat162float(fc2_s[(k + 2) * C + c]), s2);
          s3 = fmaf(hid_s[k + 3], __bfloat162float(fc2_s[(k + 3) * C + c]), s3);
        }
        for (; k < F; ++k) s0 = fmaf(hid_s[k], __bfloat162float(fc2_s[k * C + c]), s0);
        float score = ((s0 + s1) + (s2 + s3)) + a.fc2_b[c];
        if (!a.greedy) {
          const uint32_t bits = mix32(step_key ^ (uint32_t)(b * C + c));
          const float u = (float)(bits & 0xffffffu) * (1.0f / 16777216.0f) + 1e-9f;
          score = score - logf(-logf(u));
        }
        if (better(score, c, best_v, best_i)) {
          best_v = score;
          best_i = c;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best_v, o);
        const int oi = __shfl_xor_sync(kFull, best_i, o);
        if (better(ov, oi, best_v, best_i)) {
          best_v = ov;
          best_i = oi;
        }
      }
      if (lane == 0) {
        red_v[warp] = best_v;
        red_i[warp] = best_i;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kWarps; ++w)
          if (better(red_v[w], red_i[w], red_v[0], red_i[0])) {
            red_v[0] = red_v[w];
            red_i[0] = red_i[w];
          }
        __stcg(a.out + (size_t)t * B + b, red_i[0]);
      }
    }
    grid.sync();
  }
}

struct Plan {
  int grid, units, fc_cols;
  Layout layout;
  const void* kernel;
};

cudaError_t plan_launch(int batch, int hidden, int fc, int classes, int int8, Plan* p) {
  if (batch < 1 || batch > kMaxBatch || hidden < 1 || fc < 1 || classes < 1)
    return cudaErrorInvalidValue;
  int dev, sms, coop, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  p->units = (hidden + sms - 1) / sms;
  p->grid = (hidden + p->units - 1) / p->units;
  p->fc_cols = (fc + p->grid - 1) / p->grid;
  p->layout = make_layout(hidden, fc, classes, p->units, p->fc_cols, int8 != 0);
  p->kernel = int8 ? (const void*)ar_decode_kernel<true> : (const void*)ar_decode_kernel<false>;
  if (p->layout.total > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->layout.total);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->kernel, kThreads,
                                                      p->layout.total);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < p->grid) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Grid size, hidden units per block and dynamic shared memory bytes that a
// launch at these widths and in this mode (``int8`` 0: bf16) uses; returns
// a cudaError_t.
int vq_ar_decode_plan(int batch, int hidden, int fc, int classes, int int8, int* out3) {
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, fc, classes, int8, &p);
  if (err != cudaSuccess) return (int)err;
  out3[0] = p.grid;
  out3[1] = p.units;
  out3[2] = (int)p.layout.total;
  return 0;
}

// Launches the decode on ``stream``. ``int8`` 0 decodes in bf16 (embed, wh,
// fc1 bf16; the scales and ``hq_buf`` are not read and may be null); 1 in
// int8 (embed, wh, fc1 int8 with their scales; ``hq_buf`` (2, B, H rounded
// up to 4) int8, zero beyond H). Allocates nothing and does not
// synchronise. Returns cudaGetLastError() after the launch.
int vq_ar_decode_launch(const void* cond, const void* embed, const void* wh,
                        const void* bh, const void* fc1, const void* fc1_b,
                        const void* fc2, const void* fc2_b, const void* prev0,
                        const void* embed_scale, const void* wh_scale,
                        const void* fc1_scale, void* h_buf, void* hq_buf,
                        void* hid_buf, void* out, void* h_out, int n_steps,
                        int batch, int hidden, int fc, int classes, int hop,
                        int greedy, int int8, unsigned int seed,
                        void* stream) {
  if (n_steps < 1 || hop < 1) return (int)cudaErrorInvalidValue;
  if (int8 && (embed_scale == nullptr || wh_scale == nullptr || fc1_scale == nullptr ||
               hq_buf == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, fc, classes, int8, &p);
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
  a.h_buf = static_cast<float*>(h_buf);
  a.hq_buf = static_cast<int8_t*>(hq_buf);
  a.hid_buf = static_cast<float*>(hid_buf);
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
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(kThreads), params,
                              p.layout.total, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

const char* vq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
