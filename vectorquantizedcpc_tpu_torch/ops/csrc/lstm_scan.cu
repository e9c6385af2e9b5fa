// LSTM recurrence over a precomputed input projection: forward (inference
// and training variants) and the reverse-time backward.
//
// Forward. Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_fwd_kernel.
// Per step t and batch row b (torch gate order i, f, g, o):
//   gates = f32(xproj[t, b]) + bf16(h) @ wh                     (f32 acc)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   hs[t, b] = bf16(h); h and c carry in f32.
// The training variant (template flag kSave, save_residuals=True there)
// also writes c_prev[t, b] (f32, the cell state entering step t) and the
// four activated gates acts[t, b] = bf16(sigmoid i, sigmoid f, tanh g,
// sigmoid o) for the backward; its hs, h_T and c_T are the inference
// variant's bits.
//
// Backward. Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_bwd_kernel.
// Walking t from T - 1 down to 0, with (dh, dc) carried in f32 from
// (dh_T, dc_T):
//   c = f * c_prev + i * g;  tc = tanh(c);  dh += f32(dhs[t])
//   do = dh * tc;  dc += dh * o * (1 - tc^2)
//   da = (dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o))
//   dgates[t] = bf16(da);  dh = bf16(da) @ bf16(wh)^T (f32 acc);  dc *= f
// and dh0, dc0 are the carries after step 0. dwh is one product outside.
//
// What bounds them on an H100: at the CPC training shape (B = 64, T = 70,
// H = 256) each moves ~25.8 MB (the training forward: xproj, acts, c_prev,
// hs, wh; the backward: acts, c_prev, dhs, dgates, wh), ~7.7 us at
// 3.35 TB/s; 2.35 GFLOP is 2.4 us at the bf16 tensor rate. Both are
// latency-bound instead: T dependent steps, each a (rows, H) x (H, 4H)
// product (the backward: (rows, 4H) x (4H, H)) followed by the gates. wh
// (H x 4H bf16, 512 KB at H = 256) does not fit one block's 227 KB, so it
// is spread over a thread-block cluster:
//   - one cluster of kCluster CTAs per kRows batch rows (rows are
//     independent: no grid-wide barrier);
//   - CTA k owns hidden units [k U, (k + 1) U), U = H / kCluster, and keeps
//     their c and h (backward: dc and dh) in registers, one (row, unit) per
//     thread;
//   - forward: the CTA keeps its units' 4U i/f/g/o columns of wh in shared
//     memory (64 KB at H = 256) and the whole bf16(h) tile (H x kRows, as
//     f32, k-major so a step reads it as float4), double-buffered; after
//     each step it writes its units' slice of bf16(h) into every CTA's next
//     buffer through distributed shared memory, then one cluster.sync();
//   - backward: the CTA keeps its units' U rows of wh (all 4H columns,
//     64 KB) and the whole bf16(da) tile (4H x kRows, as f32),
//     double-buffered; each step it writes its units' 4 gate columns of
//     bf16(da) into every CTA's next tile, one cluster.sync(), then the
//     4H-deep product gives its units' dh;
//   - the product is split in parts over the threads so that one step's
//     FMAs spread over H threads; the parts meet in shared memory.
// Per step and CTA both directions do kRows x U x 4H FMAs. Plain FMA loops;
// no mma, wgmma or TMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per cluster (the portable maximum)
constexpr int kRows = 8;     // batch rows per cluster
constexpr int kSplit = 2;    // forward: parts of the H-deep product
constexpr int kBwdSplit = kCluster;  // backward: parts of the 4H-deep product
constexpr int kMaxThreads = 1024;

struct LstmArgs {
  const __nv_bfloat16* xproj;  // (T, B, 4H) input projection x @ wx + b
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* h0;             // (B, H)
  const float* c0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H) hidden states
  __nv_bfloat16* acts;         // (T, B, 4H) activated gates (training variant)
  float* c_prev;               // (T, B, H) cell state entering each step (training)
  float* h_out;                // (B, H) final hidden state
  float* c_out;                // (B, H) final cell state
  int steps, batch, hidden;
};

struct LstmBwdArgs {
  const __nv_bfloat16* acts;   // (T, B, 4H)
  const float* c_prev;         // (T, B, H)
  const __nv_bfloat16* dhs;    // (T, B, H) cotangent of hs, bf16
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* dh_t;           // (B, H) cotangent of h_T
  const float* dc_t;           // (B, H) cotangent of c_T
  __nv_bfloat16* dgates;       // (T, B, 4H) pre-activation gate gradients
  float* dh0;                  // (B, H)
  float* dc0;                  // (B, H)
  int steps, batch, hidden;
};

struct Layout {
  size_t wh, tile, part, total;
};

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// Dynamic shared memory layout of the forward; the same on the host (size)
// and the card. lstm_scan.py:scan_smem_bytes mirrors it.
__host__ __device__ __forceinline__ Layout make_layout(int H) {
  const int U = H / kCluster;
  Layout L;
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)H * 4 * U);
  L.tile = take(&off, sizeof(float) * 2 * (size_t)H * kRows);
  L.part = take(&off, sizeof(float) * kSplit * kRows * 4 * U);
  L.total = off;
  return L;
}

// The backward's: U rows of wh, the double-buffered bf16(da) tile (4H x
// kRows, as f32) and the product's kBwdSplit parts.
// lstm_scan.py:bwd_smem_bytes mirrors it.
__host__ __device__ __forceinline__ Layout make_bwd_layout(int H) {
  const int U = H / kCluster;
  Layout L;
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)U * 4 * H);
  L.tile = take(&off, sizeof(float) * 2 * (size_t)4 * H * kRows);
  L.part = take(&off, sizeof(float) * kBwdSplit * kRows * U);
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
template <bool kSave>
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
  float* hb_s = reinterpret_cast<float*>(smem + L.tile);    // [buf][k][r]
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
      if (kSave) a.c_prev[((size_t)t * B + b) * H + unit] = c;
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
    if (live) {
      a.hs[((size_t)t * B + b) * H + unit] = hb;
      if (kSave) {
        __nv_bfloat16* arow = a.acts + ((size_t)t * B + b) * H4 + unit;
        arow[0] = __float2bfloat16(ig);
        arow[H] = __float2bfloat16(fg);
        arow[2 * H] = __float2bfloat16(gg);
        arow[3 * H] = __float2bfloat16(og);
      }
    }

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

// blockDim.x == H == kRows * U == kBwdSplit * U: each thread is one (row,
// unit) of the gate gradients and one (part, unit) of the product, which it
// sums over 4H / kBwdSplit gate columns for all kRows rows.
__global__ void __launch_bounds__(kMaxThreads) lstm_scan_bwd_kernel(LstmBwdArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch;
  const int U = H / kCluster;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int u0 = rank * U;
  const int b0 = (blockIdx.x / kCluster) * kRows;

  const Layout L = make_bwd_layout(H);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);  // [j][u]
  float* da_s = reinterpret_cast<float*>(smem + L.tile);    // [buf][j][r]
  float* part_s = reinterpret_cast<float*>(smem + L.part);  // [s][r][u]

  // Row u0 + u of wh, all 4H columns j, at wh_s[j * U + u].
  for (int i = tid; i < H4 * U; i += blockDim.x) {
    const int j = i / U, u = i - j * U;
    wh_s[i] = a.wh[(size_t)(u0 + u) * H4 + j];
  }

  // This thread's gate element and its carries.
  const int gr = tid / U, gu = tid - gr * U;
  const int b = b0 + gr, unit = u0 + gu;
  const bool live = b < B;
  float dh = live ? a.dh_t[(size_t)b * H + unit] : 0.f;
  float dc = live ? a.dc_t[(size_t)b * H + unit] : 0.f;
  // This thread's part of the product: gate columns [j0, j1) of unit pu.
  const int pu = tid % U, ps = tid / U;
  const int j0 = ps * (H4 / kBwdSplit), j1 = j0 + H4 / kBwdSplit;

  cluster.sync();  // every CTA of the cluster runs before any remote write
  for (int i = 0; i < a.steps; ++i) {
    const int t = a.steps - 1 - i;
    float* da_cur = da_s + (size_t)(i & 1) * H4 * kRows;

    float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f, cp = 0.f, dhs = 0.f;
    if (live) {
      const __nv_bfloat16* arow = a.acts + ((size_t)t * B + b) * H4 + unit;
      ai = __bfloat162float(arow[0]);
      af = __bfloat162float(arow[H]);
      ag = __bfloat162float(arow[2 * H]);
      ao = __bfloat162float(arow[3 * H]);
      cp = a.c_prev[((size_t)t * B + b) * H + unit];
      dhs = __bfloat162float(a.dhs[((size_t)t * B + b) * H + unit]);
    }
    const float cc = af * cp + ai * ag;  // recomputed, not stored
    const float tc = tanhf(cc);
    dh += dhs;
    const float d_o = dh * tc;
    dc += dh * ao * (1.f - tc * tc);
    const float da[4] = {
        dc * ag * ai * (1.f - ai),
        dc * cp * af * (1.f - af),
        dc * ai * (1.f - ag * ag),
        d_o * ao * (1.f - ao),
    };
    dc *= af;
    __nv_bfloat16* grow = a.dgates + ((size_t)t * B + b) * H4 + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const __nv_bfloat16 db = __float2bfloat16(da[g]);
      if (live) grow[g * H] = db;
      // bf16(da) of this (row, gate column) into every CTA's tile.
      const float dv = __bfloat162float(db);
      const int at = (g * H + unit) * kRows + gr;
#pragma unroll
      for (int p = 0; p < kCluster; ++p) cluster.map_shared_rank(da_cur, p)[at] = dv;
    }
    cluster.sync();  // this step's tile is complete everywhere

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float w = __bfloat162float(wh_s[j * U + pu]);
      const float4 lo = *reinterpret_cast<const float4*>(da_cur + j * kRows);
      const float4 hi = *reinterpret_cast<const float4*>(da_cur + j * kRows + 4);
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
    for (int r = 0; r < kRows; ++r) part_s[(ps * kRows + r) * U + pu] = acc[r];
    __syncthreads();

    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kBwdSplit; ++p) s += part_s[(p * kRows + gr) * U + gu];
    dh = s;
    // The next step's remote writes go to the other tile, which every CTA
    // finished reading before this step's cluster.sync(); part_s is read
    // again only after the next cluster.sync().
  }

  if (live) {
    a.dh0[(size_t)b * H + unit] = dh;
    a.dc0[(size_t)b * H + unit] = dc;
  }
}

static_assert(kRows == kCluster && kSplit * 4 == kCluster && kBwdSplit == kRows,
              "one thread per (part, column) and per (row, unit): H threads");

bool hidden_ok(int hidden) {
  return hidden >= kCluster && hidden % kCluster == 0 && hidden <= kMaxThreads;
}

template <typename Kernel, typename Args>
cudaError_t launch_cluster(Kernel kernel, const Args& a, size_t smem_bytes, cudaStream_t stream) {
  if (a.steps < 1 || a.batch < 1 || !hidden_ok(a.hidden)) return cudaErrorInvalidValue;
  int dev, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem_bytes > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.batch + kRows - 1) / kRows * kCluster);
  cfg.blockDim = dim3(a.hidden);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

LstmArgs fwd_args(const void* xproj, const void* wh, const void* h0, const void* c0, void* hs,
                  void* acts, void* c_prev, void* h_out, void* c_out, int steps, int batch,
                  int hidden) {
  LstmArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.hs = static_cast<__nv_bfloat16*>(hs);
  a.acts = static_cast<__nv_bfloat16*>(acts);
  a.c_prev = static_cast<float*>(c_prev);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  return a;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA of a forward launch at width ``hidden`` uses.
int vq_lstm_scan_smem_bytes(int hidden) {
  return hidden >= kCluster ? (int)make_layout(hidden).total : 0;
}

// The same for a backward launch.
int vq_lstm_scan_bwd_smem_bytes(int hidden) {
  return hidden >= kCluster ? (int)make_bwd_layout(hidden).total : 0;
}

// The launches below run on ``stream``, allocate nothing and do not
// synchronise; each returns cudaGetLastError() after the launch.

// Inference variant: hs, h_T, c_T.
int vq_lstm_scan_launch(const void* xproj, const void* wh, const void* h0,
                        const void* c0, void* hs, void* h_out, void* c_out,
                        int steps, int batch, int hidden, void* stream) {
  const LstmArgs a = fwd_args(xproj, wh, h0, c0, hs, nullptr, nullptr, h_out, c_out, steps,
                              batch, hidden);
  return (int)launch_cluster(lstm_scan_kernel<false>, a, make_layout(hidden).total,
                             static_cast<cudaStream_t>(stream));
}

// Training variant: also the residuals acts (T, B, 4H) bf16 and c_prev (T, B, H) f32.
int vq_lstm_scan_train_launch(const void* xproj, const void* wh, const void* h0,
                              const void* c0, void* hs, void* acts, void* c_prev,
                              void* h_out, void* c_out, int steps, int batch, int hidden,
                              void* stream) {
  const LstmArgs a = fwd_args(xproj, wh, h0, c0, hs, acts, c_prev, h_out, c_out, steps, batch,
                              hidden);
  return (int)launch_cluster(lstm_scan_kernel<true>, a, make_layout(hidden).total,
                             static_cast<cudaStream_t>(stream));
}

// Backward: dgates (T, B, 4H) bf16, dh0 and dc0 (B, H) f32.
int vq_lstm_scan_bwd_launch(const void* acts, const void* c_prev, const void* dhs,
                            const void* wh, const void* dh_t, const void* dc_t, void* dgates,
                            void* dh0, void* dc0, int steps, int batch, int hidden,
                            void* stream) {
  LstmBwdArgs a;
  a.acts = static_cast<const __nv_bfloat16*>(acts);
  a.c_prev = static_cast<const float*>(c_prev);
  a.dhs = static_cast<const __nv_bfloat16*>(dhs);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.dh_t = static_cast<const float*>(dh_t);
  a.dc_t = static_cast<const float*>(dc_t);
  a.dgates = static_cast<__nv_bfloat16*>(dgates);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  return (int)launch_cluster(lstm_scan_bwd_kernel, a, make_bwd_layout(hidden).total,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
