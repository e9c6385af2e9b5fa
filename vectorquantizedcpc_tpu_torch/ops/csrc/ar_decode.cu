// Whole-utterance autoregressive vocoder decode in one cooperative launch.
//
// Replaces vectorquantizedcpc_tpu/ops/ar_decode.py:_decode_kernel (the bf16
// mode). Per 16 kHz sample and batch row:
//   xp     = embed_proj[prev] + cond_proj[t / hop]                 (f32)
//   hproj  = bf16(h) @ wh + bh                                     (f32 acc)
//   r, z   = sigmoid(xr + hr), sigmoid(xz + hz)
//   n      = tanh(xn + r * hn);  h = (1 - z) * n + z * h
//   logits = bf16(relu(bf16(h) @ fc1 + b1)) @ fc2 + b2
//   sample = argmax(logits [+ Gumbel noise]), lowest index on ties
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
// __stcg: L1 is not coherent across SMs. Plain FMA loops; no wgmma or TMA.
//
// Gumbel noise is a counter-based hash of (seed, t, b, class), so the plain
// PyTorch version (ar_decode.py:gumbel_bits) reproduces it bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;         // batch rows staged at once
constexpr int kMaxBatch = 128;   // rows of one launch (the JAX kernel's largest)
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const __nv_bfloat16* cond;   // (Tf, B, 3H) frame-rate input projection
  const __nv_bfloat16* embed;  // (C, 3H) pre-projected sample embedding
  const __nv_bfloat16* wh;     // (H, 3H)
  const float* bh;             // (3H,)
  const __nv_bfloat16* fc1;    // (H, F)
  const float* fc1_b;          // (F,)
  const __nv_bfloat16* fc2;    // (F, C)
  const float* fc2_b;          // (C,)
  const int* prev0;            // (B,) class entering the decode
  float* h_buf;                // (2, B, H); slot 0 holds h0 on entry
  float* hid_buf;              // (B, F) FC1 output exchanged between blocks
  int* out;                    // (T, B) samples
  float* h_out;                // (B, H) final hidden state
  int n_steps, batch, hidden, fc, classes, hop, greedy;
  unsigned int seed;
  int units;    // hidden units per block
  int fc_cols;  // FC1 columns per block
};

struct Layout {
  size_t hproj, hid, red_v, red_i, prev, wh, emb, fc1, fc2, h, total;
};

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// Dynamic shared memory layout; the same on the host (size) and the card.
__host__ __device__ __forceinline__ Layout make_layout(int H, int F, int C,
                                                      int units, int fc_cols) {
  Layout L;
  size_t off = 0;
  L.hproj = take(&off, sizeof(float) * kTile * 3 * units);
  L.hid = take(&off, sizeof(float) * F);
  L.red_v = take(&off, sizeof(float) * kWarps);
  L.red_i = take(&off, sizeof(int) * kWarps);
  L.prev = take(&off, sizeof(int) * kTile);
  L.wh = take(&off, sizeof(__nv_bfloat16) * 3 * units * H);
  L.emb = take(&off, sizeof(__nv_bfloat16) * C * 3 * units);
  L.fc1 = take(&off, sizeof(__nv_bfloat16) * fc_cols * H);
  L.fc2 = take(&off, sizeof(__nv_bfloat16) * F * C);
  L.h = take(&off, sizeof(__nv_bfloat16) * kTile * H);
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

__global__ void __launch_bounds__(kThreads, 1) ar_decode_kernel(DecodeArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];

  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, F = a.fc,
            C = a.classes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, G = gridDim.x;
  const int u0 = blk * a.units;
  const int n_units = max(0, min(a.units, H - u0));
  const int n_cols = 3 * n_units;  // local column lc = gate * n_units + unit
  const int hp_stride = 3 * a.units;
  int n_fc = 0;
  while (n_fc < a.fc_cols && blk + n_fc * G < F) ++n_fc;

  const Layout L = make_layout(H, F, C, a.units, a.fc_cols);
  float* hproj_s = reinterpret_cast<float*>(smem + L.hproj);
  float* hid_s = reinterpret_cast<float*>(smem + L.hid);
  float* red_v = reinterpret_cast<float*>(smem + L.red_v);
  int* red_i = reinterpret_cast<int*>(smem + L.red_i);
  int* prev_s = reinterpret_cast<int*>(smem + L.prev);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* emb_s = reinterpret_cast<__nv_bfloat16*>(smem + L.emb);
  __nv_bfloat16* fc1_s = reinterpret_cast<__nv_bfloat16*>(smem + L.fc1);
  __nv_bfloat16* fc2_s = reinterpret_cast<__nv_bfloat16*>(smem + L.fc2);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);

  // Resident weights, loaded once. wh and fc1 columns are stored
  // transposed (column-major) so that lanes striding k hit distinct banks.
  for (int i = tid; i < n_cols * H; i += kThreads) {
    const int k = i / n_cols, lc = i % n_cols;
    const int col = (lc / n_units) * H + u0 + lc % n_units;
    wh_s[lc * H + k] = a.wh[(size_t)k * H3 + col];
  }
  for (int i = tid; i < C * n_cols; i += kThreads) {
    const int c = i / n_cols, lc = i % n_cols;
    const int col = (lc / n_units) * H + u0 + lc % n_units;
    emb_s[i] = a.embed[(size_t)c * H3 + col];
  }
  for (int i = tid; i < n_fc * H; i += kThreads) {
    const int k = i / n_fc, j = i % n_fc;
    fc1_s[j * H + k] = a.fc1[(size_t)k * F + blk + j * G];
  }
  if (blk < B)  // this block samples rows blk, blk + G, ...
    for (int i = tid; i < F * C; i += kThreads) fc2_s[i] = a.fc2[i];
  __syncthreads();

  const uint32_t seed_key = mix32(a.seed);
  for (int t = 0; t < a.n_steps; ++t) {
    const int f = t / a.hop;
    const float* h_cur = a.h_buf + (size_t)(t & 1) * B * H;
    float* h_nxt = a.h_buf + (size_t)((t + 1) & 1) * B * H;

    // ---- Gate phase: this block's slice of the new hidden state. ----
    if (n_units > 0) {
      for (int r0 = 0; r0 < B; r0 += kTile) {
        const int rows = min(kTile, B - r0);
        if (r0 > 0) __syncthreads();  // the last tile's prev_s is read
        for (int i = tid; i < rows * H; i += kThreads)
          h_s[i] = __float2bfloat16(__ldcg(h_cur + (size_t)r0 * H + i));
        if (tid < rows) {
          const int b = r0 + tid;
          const int p = t == 0 ? a.prev0[b] : __ldcg(a.out + (size_t)(t - 1) * B + b);
          prev_s[tid] = min(max(p, 0), C - 1);
        }
        __syncthreads();
        for (int lc = warp; lc < n_cols; lc += kWarps) {
          float acc[kTile];
          warp_dot_rows(h_s, wh_s + (size_t)lc * H, H, rows, lane, acc);
          if (lane == 0)
#pragma unroll
            for (int b = 0; b < kTile; ++b)
              if (b < rows) hproj_s[b * hp_stride + lc] = acc[b];
        }
        __syncthreads();
        for (int i = tid; i < rows * n_units; i += kThreads) {
          const int rb = i / n_units, b = r0 + rb, u = i % n_units, j = u0 + u;
          const __nv_bfloat16* crow = a.cond + ((size_t)f * B + b) * H3;
          const __nv_bfloat16* erow = emb_s + (size_t)prev_s[rb] * n_cols;
          const float* hp = hproj_s + rb * hp_stride;
          const float xr = __bfloat162float(erow[u]) + __bfloat162float(crow[j]);
          const float xz = __bfloat162float(erow[n_units + u]) +
                           __bfloat162float(crow[H + j]);
          const float xn = __bfloat162float(erow[2 * n_units + u]) +
                           __bfloat162float(crow[2 * H + j]);
          const float hr = hp[u] + a.bh[j];
          const float hz = hp[n_units + u] + a.bh[H + j];
          const float hn = hp[2 * n_units + u] + a.bh[2 * H + j];
          const float r = 1.f / (1.f + expf(-(xr + hr)));
          const float z = 1.f / (1.f + expf(-(xz + hz)));
          const float n = tanhf(xn + r * hn);
          const float h_new = (1.f - z) * n + z * __ldcg(h_cur + b * H + j);
          __stcg(h_nxt + b * H + j, h_new);
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
        for (int i = tid; i < rows * H; i += kThreads)
          h_s[i] = __float2bfloat16(__ldcg(h_nxt + (size_t)r0 * H + i));
        __syncthreads();
        for (int j = warp; j < n_fc; j += kWarps) {
          const int col = blk + j * G;
          float acc[kTile];
          warp_dot_rows(h_s, fc1_s + (size_t)j * H, H, rows, lane, acc);
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
};

cudaError_t plan_launch(int batch, int hidden, int fc, int classes, Plan* p) {
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
  p->layout = make_layout(hidden, fc, classes, p->units, p->fc_cols);
  if (p->layout.total > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ar_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->layout.total);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ar_decode_kernel, kThreads, p->layout.total);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < p->grid) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Grid size, hidden units per block and dynamic shared memory bytes that a
// launch at these widths uses; returns a cudaError_t.
int vq_ar_decode_plan(int batch, int hidden, int fc, int classes, int* out3) {
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, fc, classes, &p);
  if (err != cudaSuccess) return (int)err;
  out3[0] = p.grid;
  out3[1] = p.units;
  out3[2] = (int)p.layout.total;
  return 0;
}

// Launches the decode on ``stream``. Allocates nothing and does not
// synchronise. Returns cudaGetLastError() after the launch.
int vq_ar_decode_launch(const void* cond, const void* embed, const void* wh,
                        const void* bh, const void* fc1, const void* fc1_b,
                        const void* fc2, const void* fc2_b, const void* prev0,
                        void* h_buf, void* hid_buf, void* out, void* h_out,
                        int n_steps, int batch, int hidden, int fc, int classes,
                        int hop, int greedy, unsigned int seed, void* stream) {
  if (n_steps < 1 || hop < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, fc, classes, &p);
  if (err != cudaSuccess) return (int)err;
  DecodeArgs a;
  a.cond = static_cast<const __nv_bfloat16*>(cond);
  a.embed = static_cast<const __nv_bfloat16*>(embed);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.fc1 = static_cast<const __nv_bfloat16*>(fc1);
  a.fc1_b = static_cast<const float*>(fc1_b);
  a.fc2 = static_cast<const __nv_bfloat16*>(fc2);
  a.fc2_b = static_cast<const float*>(fc2_b);
  a.prev0 = static_cast<const int*>(prev0);
  a.h_buf = static_cast<float*>(h_buf);
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
  cudaLaunchCooperativeKernel((void*)ar_decode_kernel, dim3(p.grid),
                              dim3(kThreads), params, p.layout.total,
                              static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

const char* vq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
