// LSTM recurrence over a precomputed input projection (inference variant).
//
// Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_fwd_kernel with
// save_residuals=False (the encoder's context LSTM on the export path). Per
// step t and batch row b (torch gate order i, f, g, o):
//   gates = f32(xproj[t, b]) + bf16(h) @ wh                     (f32 acc)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   hs[t, b] = bf16(h); h and c carry in f32.
//
// What bounds it on an H100: at the export shape (B = 16, T = 256,
// H = 256) the work is 2*B*T*H*4H = 2.15 GFLOP and the bytes are xproj +
// hs + wh, about 11 MB, so the roofline bound is the bytes, ~3.3 us. The
// kernel is latency-bound instead: T dependent steps, each a (rows, H) x
// (H, 4H) product followed by the gates. wh (H x 4H bf16, 512 KB at
// H = 256) does not fit one block's 227 KB, so it is spread over a
// thread-block cluster:
//   - one cluster of kCluster CTAs per kRows batch rows (rows are
//     independent: no grid-wide barrier);
//   - CTA k owns hidden units [k U, (k + 1) U), U = H / kCluster, keeps
//     their 4U i/f/g/o columns of wh in shared memory for the whole
//     sequence (64 KB at H = 256), and keeps their c and h in registers,
//     one (row, unit) per thread;
//   - every CTA holds the whole bf16(h) tile (H x kRows, as f32, k-major so
//     a step reads it as float4), double-buffered; after each step each CTA
//     writes its units' slice into every CTA's next buffer through
//     distributed shared memory, then one cluster.sync() per step;
//   - the H-deep product is split in kSplit parts over the threads (thread
//     (s, j) sums k in part s of column j for all kRows rows), so that one
//     step's FMAs spread over H threads; the parts meet in shared memory.
// Eight CTAs of eight rows, not four of sixteen: one SM does 4U * kRows * H
// FMAs per step on its CUDA cores, and this split quarters that. Plain FMA
// loops; no mma, wgmma or TMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per cluster (the portable maximum)
constexpr int kRows = 8;     // batch rows per cluster
constexpr int kSplit = 2;    // parts of the H-deep product
constexpr int kMaxThreads = 1024;

struct LstmArgs {
  const __nv_bfloat16* xproj;  // (T, B, 4H) input projection x @ wx + b
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* h0;             // (B, H)
  const float* c0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H) hidden states
  float* h_out;                // (B, H) final hidden state
  float* c_out;                // (B, H) final cell state
  int steps, batch, hidden;
};

struct Layout {
  size_t wh, hb, part, total;
};

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// Dynamic shared memory layout; the same on the host (size) and the card.
// lstm_scan.py:scan_smem_bytes mirrors it.
__host__ __device__ __forceinline__ Layout make_layout(int H) {
  const int U = H / kCluster;
  Layout L;
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)H * 4 * U);
  L.hb = take(&off, sizeof(float) * 2 * (size_t)H * kRows);
  L.part = take(&off, sizeof(float) * kSplit * kRows * 4 * U);
  L.total = off;
  return L;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// blockDim.x == H == kSplit * 4U == kRows * U: each thread is one
// (part, column) of the product and one (row, unit) of the gates.
__global__ void __launch_bounds__(kMaxThreads) lstm_scan_kernel(LstmArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch;
  const int U = H / kCluster, C4 = 4 * U;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int u0 = rank * U;
  const int b0 = (blockIdx.x / kCluster) * kRows;

  const Layout L = make_layout(H);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);  // [k][j]
  float* hb_s = reinterpret_cast<float*>(smem + L.hb);      // [buf][k][r]
  float* part_s = reinterpret_cast<float*>(smem + L.part);  // [s][r][j]

  // Local column j = gate * U + u is wh's column gate * H + u0 + u.
  for (int i = tid; i < H * C4; i += blockDim.x) {
    const int k = i / C4, j = i - k * C4;
    wh_s[i] = a.wh[(size_t)k * H4 + (j / U) * H + u0 + j % U];
  }
  for (int i = tid; i < H * kRows; i += blockDim.x) {
    const int k = i / kRows, r = i - k * kRows;
    hb_s[i] = b0 + r < B ? bf16_round(a.h0[(size_t)(b0 + r) * H + k]) : 0.f;
  }

  // This thread's gate element and its carries.
  const int gr = tid / U, gu = tid - gr * U;
  const int b = b0 + gr, unit = u0 + gu;
  const bool live = b < B;
  float h = live ? a.h0[(size_t)b * H + unit] : 0.f;
  float c = live ? a.c0[(size_t)b * H + unit] : 0.f;
  // This thread's part of the product.
  const int mj = tid % C4, ms = tid / C4;
  const int k0 = ms * (H / kSplit), k1 = k0 + H / kSplit;

  cluster.sync();  // every CTA of the cluster runs before any remote write
  for (int t = 0; t < a.steps; ++t) {
    const float* h_cur = hb_s + (size_t)(t & 1) * H * kRows;
    float* h_nxt = hb_s + (size_t)((t + 1) & 1) * H * kRows;

    // This step's gate inputs, loaded before the product hides their latency.
    float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
    if (live) {
      const __nv_bfloat16* xrow = a.xproj + ((size_t)t * B + b) * H4 + unit;
      xi = __bfloat162float(xrow[0]);
      xf = __bfloat162float(xrow[H]);
      xg = __bfloat162float(xrow[2 * H]);
      xo = __bfloat162float(xrow[3 * H]);
    }

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float w = __bfloat162float(wh_s[k * C4 + mj]);
      const float4 lo = *reinterpret_cast<const float4*>(h_cur + k * kRows);
      const float4 hi = *reinterpret_cast<const float4*>(h_cur + k * kRows + 4);
      acc[0] = fmaf(lo.x, w, acc[0]);
      acc[1] = fmaf(lo.y, w, acc[1]);
      acc[2] = fmaf(lo.z, w, acc[2]);
      acc[3] = fmaf(lo.w, w, acc[3]);
      acc[4] = fmaf(hi.x, w, acc[4]);
      acc[5] = fmaf(hi.y, w, acc[5]);
      acc[6] = fmaf(hi.z, w, acc[6]);
      acc[7] = fmaf(hi.w, w, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) part_s[(ms * kRows + r) * C4 + mj] = acc[r];
    __syncthreads();

    float hp[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = g * U + gu;
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) s += part_s[(p * kRows + gr) * C4 + j];
      hp[g] = s;
    }
    const float ig = sigmoid(xi + hp[0]);
    const float fg = sigmoid(xf + hp[1]);
    const float gg = tanhf(xg + hp[2]);
    const float og = sigmoid(xo + hp[3]);
    c = fg * c + ig * gg;
    h = og * tanhf(c);
    const __nv_bfloat16 hb = __float2bfloat16(h);
    if (live) a.hs[((size_t)t * B + b) * H + unit] = hb;

    // bf16(h) of this (row, unit) into every CTA's next tile.
    const float hv = __bfloat162float(hb);
    const int at = unit * kRows + gr;
#pragma unroll
    for (int p = 0; p < kCluster; ++p) cluster.map_shared_rank(h_nxt, p)[at] = hv;
    cluster.sync();  // the next tile is complete everywhere; part_s is free
  }

  if (live) {
    a.h_out[(size_t)b * H + unit] = h;
    a.c_out[(size_t)b * H + unit] = c;
  }
}

static_assert(kRows == kCluster && kSplit * 4 == kCluster,
              "one thread per (part, column) and per (row, unit): H threads");

bool hidden_ok(int hidden) {
  return hidden >= kCluster && hidden % kCluster == 0 && hidden <= kMaxThreads;
}

cudaError_t launch(const LstmArgs& a, cudaStream_t stream) {
  if (a.steps < 1 || a.batch < 1 || !hidden_ok(a.hidden)) return cudaErrorInvalidValue;
  const Layout L = make_layout(a.hidden);
  int dev, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (L.total > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.batch + kRows - 1) / kRows * kCluster);
  cfg.blockDim = dim3(a.hidden);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_scan_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA of a launch at width ``hidden`` uses.
int vq_lstm_scan_smem_bytes(int hidden) {
  return hidden >= kCluster ? (int)make_layout(hidden).total : 0;
}

// Launches on ``stream``, allocates nothing and does not synchronise;
// returns cudaGetLastError() after the launch.
int vq_lstm_scan_launch(const void* xproj, const void* wh, const void* h0,
                        const void* c0, void* hs, void* h_out, void* c_out,
                        int steps, int batch, int hidden, void* stream) {
  LstmArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.hs = static_cast<__nv_bfloat16*>(hs);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  return (int)launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
