// GRU recurrence over a precomputed input projection, plain and masked.
//
// Replaces vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel in its
// no-residual variant (save_residuals=False, the no-grad forward) and
// vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel_masked. Per step t
// and batch row b (torch gate order r, z, n; bh inside the reset product):
//   hproj = bf16(h) @ wh + bh                                  (f32 acc)
//   r = sigmoid(xr + hr);  z = sigmoid(xz + hz);  n = tanh(xn + r * hn)
//   h_new = (1 - z) * n + z * h                                (f32)
//   masked: h_new = valid[t, b] ? h_new : h
//   hs[t, b] = bf16(h_new); h carries in f32.
//
// What bounds it on an H100: at the serving PreNet shape (B = 48 rows,
// T = 200, H = 128) the work is 2*B*T*H*3H = 0.94 GFLOP and the bytes are
// xproj + hs + wh, about 10 MB, so the roofline bound is the bytes, ~3 us.
// The kernel is latency-bound instead: T dependent steps, each a
// (rows, H) x (H, 3H) product followed by the gates, and only
// ceil(B / kRows) blocks have work. The TPU kernel keeps wh in one core's
// VMEM and walks time on its sequential grid; here one block owns kRows
// batch rows (ragged rows are independent, so no grid barrier is needed)
// and walks all T steps in a loop:
//   - wh (H x 3H bf16, 96 KB at H = 128) and bh are staged once into
//     dynamic shared memory; h lives there too, in f32 and as its bf16
//     rounding (stored as f32, k-major, so one step reads it as float4);
//   - per step, thread j computes hproj column j for all kRows rows (an
//     H-deep FMA loop, f32 accumulation); then threads split the kRows x H
//     gate elements; two __syncthreads() per step;
//   - each thread loads its gate inputs (xproj, valid) for the step before
//     the product, so the global-memory latency hides behind it.
// Plain FMA loops; no mma or wgmma. H is limited by shared memory
// (about 183 at kRows = 8); the launch refuses a larger H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;          // batch rows per block
constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 3;  // gate elements per thread: 8H / 3H < 3

struct ScanArgs {
  const __nv_bfloat16* xproj;  // (T, B, 3H) input projection x @ wx + bx
  const int* valid;            // (T, B); 0 freezes the carry (masked only)
  const __nv_bfloat16* wh;     // (H, 3H)
  const float* bh;             // (3H,)
  const float* h0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H) hidden states
  float* h_out;                // (B, H) final hidden state
  int steps, batch, hidden;
};

struct Layout {
  size_t wh, bh, h, hb, hproj, total;
};

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// Dynamic shared memory layout; the same on the host (size) and the card.
// gru_train.py:scan_smem_bytes mirrors it.
__host__ __device__ __forceinline__ Layout make_layout(int H) {
  Layout L;
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)H * 3 * H);
  L.bh = take(&off, sizeof(float) * 3 * H);
  L.h = take(&off, sizeof(float) * kRows * H);
  L.hb = take(&off, sizeof(float) * kRows * H);
  L.hproj = take(&off, sizeof(float) * kRows * 3 * H);
  L.total = off;
  return L;
}

__host__ __device__ __forceinline__ int block_threads(int H) {
  return (3 * H + 31) / 32 * 32;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <bool kMasked>
__global__ void __launch_bounds__(kMaxThreads)
    gru_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int n_elem = kRows * H;

  const Layout L = make_layout(H);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  float* bh_s = reinterpret_cast<float*>(smem + L.bh);
  float* h_s = reinterpret_cast<float*>(smem + L.h);    // [r][u]
  float* hb_s = reinterpret_cast<float*>(smem + L.hb);  // [u][r], bf16 values
  float* hp_s = reinterpret_cast<float*>(smem + L.hproj);  // [r][j]

  for (int i = tid; i < H * H3; i += nthreads) wh_s[i] = a.wh[i];
  for (int i = tid; i < H3; i += nthreads) bh_s[i] = a.bh[i];
  for (int i = tid; i < n_elem; i += nthreads) {
    const int r = i / H, u = i - r * H;
    const float v = r < rows ? a.h0[(size_t)(b0 + r) * H + u] : 0.f;
    h_s[i] = v;
    hb_s[u * kRows + r] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    // This step's gate inputs, loaded before the product hides their latency.
    float xr[kMaxPerThread], xz[kMaxPerThread], xn[kMaxPerThread];
    bool keep[kMaxPerThread];
#pragma unroll
    for (int e = 0; e < kMaxPerThread; ++e) {
      const int i = tid + e * nthreads;
      const int r = i / H, u = i - r * H;
      keep[e] = false;
      if (i < n_elem && r < rows) {
        const __nv_bfloat16* xrow = a.xproj + ((size_t)t * B + b0 + r) * H3;
        xr[e] = __bfloat162float(xrow[u]);
        xz[e] = __bfloat162float(xrow[H + u]);
        xn[e] = __bfloat162float(xrow[2 * H + u]);
        if (kMasked) keep[e] = a.valid[(size_t)t * B + b0 + r] == 0;
      }
    }

    // hproj[r, j] = bf16(h[r]) . wh[:, j] + bh[j], thread j for all rows.
    for (int j = tid; j < H3; j += nthreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < H; ++k) {
        const float w = __bfloat162float(wh_s[k * H3 + j]);
        const float4 lo = *reinterpret_cast<const float4*>(hb_s + k * kRows);
        const float4 hi = *reinterpret_cast<const float4*>(hb_s + k * kRows + 4);
        acc[0] = fmaf(lo.x, w, acc[0]);
        acc[1] = fmaf(lo.y, w, acc[1]);
        acc[2] = fmaf(lo.z, w, acc[2]);
        acc[3] = fmaf(lo.w, w, acc[3]);
        acc[4] = fmaf(hi.x, w, acc[4]);
        acc[5] = fmaf(hi.y, w, acc[5]);
        acc[6] = fmaf(hi.z, w, acc[6]);
        acc[7] = fmaf(hi.w, w, acc[7]);
      }
      const float bj = bh_s[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) hp_s[r * H3 + j] = acc[r] + bj;
    }
    __syncthreads();

    // Gates and the new carry.
#pragma unroll
    for (int e = 0; e < kMaxPerThread; ++e) {
      const int i = tid + e * nthreads;
      const int r = i / H, u = i - r * H;
      if (i < n_elem && r < rows) {
        const float* hp = hp_s + r * H3;
        const float rg = sigmoid(xr[e] + hp[u]);
        const float zg = sigmoid(xz[e] + hp[H + u]);
        const float ng = tanhf(xn[e] + rg * hp[2 * H + u]);
        const float h_old = h_s[i];
        const float h_new = keep[e] ? h_old : (1.f - zg) * ng + zg * h_old;
        const __nv_bfloat16 hb = __float2bfloat16(h_new);
        a.hs[((size_t)t * B + b0 + r) * H + u] = hb;
        h_s[i] = h_new;
        hb_s[u * kRows + r] = __bfloat162float(hb);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * H; i += nthreads)
    a.h_out[(size_t)b0 * H + i] = h_s[i];
}

template <bool kMasked>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  if (a.steps < 1 || a.batch < 1 || a.hidden < 1) return cudaErrorInvalidValue;
  const Layout L = make_layout(a.hidden);
  const int threads = block_threads(a.hidden);
  if (threads > kMaxThreads || kMaxPerThread * threads < kRows * a.hidden)
    return cudaErrorInvalidValue;
  int dev, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (L.total > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gru_scan_kernel<kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + kRows - 1) / kRows;
  gru_scan_kernel<kMasked><<<grid, threads, L.total, stream>>>(a);
  return cudaGetLastError();
}

ScanArgs make_args(const void* xproj, const void* valid, const void* wh,
                   const void* bh, const void* h0, void* hs, void* h_out,
                   int steps, int batch, int hidden) {
  ScanArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.valid = static_cast<const int*>(valid);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.h0 = static_cast<const float*>(h0);
  a.hs = static_cast<__nv_bfloat16*>(hs);
  a.h_out = static_cast<float*>(h_out);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  return a;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one block of a launch at width ``hidden`` uses.
int vq_gru_scan_smem_bytes(int hidden) {
  return (int)make_layout(hidden).total;
}

// Both launch on ``stream``, allocate nothing and do not synchronise; they
// return cudaGetLastError() after the launch.
int vq_gru_scan_launch(const void* xproj, const void* wh, const void* bh,
                       const void* h0, void* hs, void* h_out, int steps,
                       int batch, int hidden, void* stream) {
  return (int)launch<false>(
      make_args(xproj, nullptr, wh, bh, h0, hs, h_out, steps, batch, hidden),
      static_cast<cudaStream_t>(stream));
}

int vq_gru_scan_masked_launch(const void* xproj, const void* valid,
                              const void* wh, const void* bh, const void* h0,
                              void* hs, void* h_out, int steps, int batch,
                              int hidden, void* stream) {
  if (valid == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch<true>(
      make_args(xproj, valid, wh, bh, h0, hs, h_out, steps, batch, hidden),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
