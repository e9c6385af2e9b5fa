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
// (rows, H) x (H, 3H) product followed by the gates. The TPU kernel keeps
// wh in one core's VMEM and walks time on its sequential grid; here one
// block owns kRows = 8 batch rows (ragged rows are independent, so no grid
// barrier is needed) and walks all T steps in a loop, with the product on
// the tensor cores and the step's state in registers:
//   - the product is transposed, hproj^T (3H x 8) = wh^T (3H x H) .
//     bf16(h)^T (H x 8), so that the block's 8 rows are the N = 8 of
//     mma.sync.m16n8k16 (bf16 in, f32 accumulation);
//   - warp w owns hidden units [16w, 16w + 16) and holds the r, z and n
//     rows of wh^T for them as A fragments for the whole scan: in
//     registers for the first kRegSteps 16-deep K steps (all of K up to
//     H = 128), in shared memory, in fragment order, beyond that. Each
//     thread's accumulators then hold r, z and n of the same (unit, row)
//     pairs, so the gates, the f32 carry and bh stay in registers;
//   - per step only bf16(h) crosses the warps: 8 rows of H bf16 in a
//     double-buffered shared tile, so one __syncthreads per step; the
//     next step copies the tile to hs in 16-byte stores after its product;
//   - the block's xproj rows (and mask) of step t + 2 are copied into a
//     3-stage shared ring by cp.async while step t runs, so the gates read
//     their inputs from shared memory and never wait on L2 or HBM.
// Units and K beyond H are zero-padded to the 16 of an mma tile. H is
// limited by the registers: ceil(H / 16) warps, each holding 96 registers
// of fragments; up to H = 128 (8 warps) a variant with up to 255 registers
// a thread, above it one of up to 168 (kMaxWarps = 12, H <= 192); the
// launch refuses a larger H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;       // batch rows per block: the mma's N
constexpr int kRegSteps = 8;   // K steps of wh^T whose A fragments stay in registers
constexpr int kMaxWarps = 12;  // one warp per 16 hidden units: H <= 192
constexpr int kPad = 8;        // bf16 after each row of the h tile (distinct banks)
constexpr int kStages = 3;     // xproj stages in shared memory: 2 steps copied ahead

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
  size_t hb, xs, vs, afrag, total;
};

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// Warps of a block, and 16-deep K steps of the product: both ceil(H / 16).
__host__ __device__ __forceinline__ int n_warps(int H) { return (H + 15) / 16; }

// Dynamic shared memory layout; the same on the host (size) and the card.
// gru_train.py:scan_plan mirrors it.
__host__ __device__ __forceinline__ Layout make_layout(int H) {
  const int warps = n_warps(H), ks = warps;
  const int extra = ks > kRegSteps ? ks - kRegSteps : 0;
  Layout L;
  size_t off = 0;
  L.hb = take(&off, sizeof(__nv_bfloat16) * 2 * kRows * (ks * 16 + kPad));
  L.xs = take(&off, sizeof(__nv_bfloat16) * kStages * kRows * (3 * H + kPad));
  L.vs = take(&off, sizeof(int) * kStages * kRows);
  L.afrag = take(&off, sizeof(uint4) * warps * 3 * extra * 32);
  L.total = off;
  return L;
}

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + expf(-x));  // 1 / (1 + e^-x), correctly rounded
}

// D += A (16 x 16, row-major) B (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_16816(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The bits of wh^T[gate * H + u][k] = wh[k][gate * H + u]; zero beyond H.
__device__ __forceinline__ uint32_t wh_bits(const __nv_bfloat16* wh, int H, int gate, int u,
                                            int k) {
  if (u >= H || k >= H) return 0u;
  return __bfloat16_as_ushort(wh[(size_t)k * 3 * H + gate * H + u]);
}

// This lane's A fragment of K step ``ks`` for the 16 units from ``u0`` of
// ``gate``: rows g and g + 8, K pairs 2q and 2q + 8 (low half: lower k).
__device__ __forceinline__ uint4 wh_fragment(const __nv_bfloat16* wh, int H, int gate, int u0,
                                             int ks, int g, int q) {
  const int k = ks * 16 + 2 * q;
  auto pair = [&](int u, int kk) {
    return wh_bits(wh, H, gate, u, kk) | (wh_bits(wh, H, gate, u, kk + 1) << 16);
  };
  return make_uint4(pair(u0 + g, k), pair(u0 + g + 8, k), pair(u0 + g, k + 8),
                    pair(u0 + g + 8, k + 8));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Starts copying the block's xproj rows (and mask) of step ``t`` into
// stage ``slot``, as one cp.async group (empty past the last step). Rows
// of 3H bf16 sit xstride apart; where 3H is not a whole number of 16-byte
// chunks the copy is a plain one, finished when this returns.
template <bool kMasked>
__device__ __forceinline__ void stage_step(const ScanArgs& a, int t, int b0, int rows,
                                           __nv_bfloat16* xs, int* vs, int slot) {
  const int H3 = 3 * a.hidden, xstride = H3 + kPad;
  if (t < a.steps) {
    const __nv_bfloat16* src = a.xproj + ((size_t)t * a.batch + b0) * H3;
    __nv_bfloat16* dst = xs + (size_t)slot * kRows * xstride;
    if (H3 % 8 == 0) {
      const int chunks = H3 / 8;
      for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
        const int r = i / chunks, c = i - r * chunks;
        cp_async16(dst + r * xstride + c * 8, src + (size_t)r * H3 + c * 8);
      }
    } else {
      for (int i = threadIdx.x; i < rows * H3; i += blockDim.x) {
        const int r = i / H3, c = i - r * H3;
        dst[r * xstride + c] = src[(size_t)r * H3 + c];
      }
    }
    if (kMasked && (int)threadIdx.x < rows)
      cp_async4(vs + slot * kRows + threadIdx.x, a.valid + (size_t)t * a.batch + b0 + threadIdx.x);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// hs[t] from a shared h tile: 16-byte stores where rows are whole chunks.
__device__ __forceinline__ void store_hs(const ScanArgs& a, int t, int b0, int rows,
                                         const __nv_bfloat16* tile, int S) {
  const int H = a.hidden;
  __nv_bfloat16* hs_t = a.hs + ((size_t)t * a.batch + b0) * H;
  if (H % 8 == 0) {
    const int chunks = H / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks;
      *reinterpret_cast<uint4*>(hs_t + (size_t)r * H + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * S + c * 8);
    }
  } else {
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H, u = i - r * H;
      hs_t[(size_t)r * H + u] = tile[r * S + u];
    }
  }
}

// kMaxW: the most warps the variant takes (8: every K step's fragments in
// registers; kMaxWarps: those past kRegSteps in shared memory).
template <bool kMasked, int kMaxW>
__global__ void __launch_bounds__(kMaxW * 32, 1) gru_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden;
  const int KS = n_warps(H), S = KS * 16 + kPad, xstride = 3 * H + kPad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int u0 = warp * 16;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.batch - b0);

  const Layout L = make_layout(H);
  __nv_bfloat16* hb_s = reinterpret_cast<__nv_bfloat16*>(smem + L.hb);  // [2][kRows][S]
  __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);  // [kStages][kRows][xstride]
  int* vs_s = reinterpret_cast<int*>(smem + L.vs);                      // [kStages][kRows]
  uint4* af_s = reinterpret_cast<uint4*>(smem + L.afrag);  // [warp][gate][ks - kRegSteps][lane]

  for (int t = 0; t < kStages - 1; ++t) stage_step<kMasked>(a, t, b0, rows, xs_s, vs_s, t);

  // A fragments of this warp's rows of wh^T, for the whole scan.
  uint32_t areg[3][kRegSteps][4];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int ks = 0; ks < kRegSteps; ++ks) {
      const uint4 f = ks < KS ? wh_fragment(a.wh, H, gate, u0, ks, g, q) : make_uint4(0, 0, 0, 0);
      areg[gate][ks][0] = f.x;
      areg[gate][ks][1] = f.y;
      areg[gate][ks][2] = f.z;
      areg[gate][ks][3] = f.w;
    }
  const int extra = kMaxW > kRegSteps && KS > kRegSteps ? KS - kRegSteps : 0;
  for (int gate = 0; gate < 3; ++gate)
    for (int e = 0; e < extra; ++e)
      af_s[((warp * 3 + gate) * extra + e) * 32 + lane] =
          wh_fragment(a.wh, H, gate, u0, kRegSteps + e, g, q);

  // This thread's four (unit, row) pairs: accumulator element e is unit
  // u0 + g + 8 * (e >> 1), row 2q + (e & 1).
  int unit[4], row[4];
  bool live[4];  // a real unit of a real row
  float h[4], bias[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    unit[e] = u0 + g + 8 * (e >> 1);
    row[e] = 2 * q + (e & 1);
    live[e] = unit[e] < H && row[e] < rows;
    h[e] = live[e] ? a.h0[(size_t)(b0 + row[e]) * H + unit[e]] : 0.f;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) bias[gate][e] = unit[e] < H ? a.bh[gate * H + unit[e]] : 0.f;
  }

  for (int i = threadIdx.x; i < 2 * kRows * S; i += blockDim.x) hb_s[i] = __float2bfloat16(0.f);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (unit[e] < H) hb_s[row[e] * S + unit[e]] = __float2bfloat16(h[e]);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));  // step 0 has landed
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    const __nv_bfloat16* hcur = hb_s + (t & 1) * kRows * S;
    __nv_bfloat16* hnxt = hb_s + ((t + 1) & 1) * kRows * S;
    const int slot = t % kStages;
    stage_step<kMasked>(a, t + kStages - 1, b0, rows, xs_s, vs_s, (t + kStages - 1) % kStages);

    // hproj^T for this warp's units: two accumulator chains per gate.
    const __nv_bfloat16* hrow = hcur + g * S + 2 * q;
    float acc[3][2][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gate][c][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kRegSteps; ++ks) {
      if (ks < KS) {
        const uint32_t b_lo = ld_pair(hrow + ks * 16), b_hi = ld_pair(hrow + ks * 16 + 8);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          mma_16816(acc[gate][ks & 1], areg[gate][ks][0], areg[gate][ks][1], areg[gate][ks][2],
                    areg[gate][ks][3], b_lo, b_hi);
      }
    }
    for (int e = 0; e < extra; ++e) {
      const int ks = kRegSteps + e;
      const uint32_t b_lo = ld_pair(hrow + ks * 16), b_hi = ld_pair(hrow + ks * 16 + 8);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const uint4 f = af_s[((warp * 3 + gate) * extra + e) * 32 + lane];
        mma_16816(acc[gate][ks & 1], f.x, f.y, f.z, f.w, b_lo, b_hi);
      }
    }
    // hs of the last step, off the path of this one (its tile is read-only now).
    if (t > 0) store_hs(a, t - 1, b0, rows, hcur, S);

    // Gates and the new carry, in registers; the inputs from this step's stage.
    const __nv_bfloat16* xs = xs_s + (size_t)slot * kRows * xstride;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16* xe = xs + row[e] * xstride + unit[e];
      const bool use = live[e];
      const float xr = use ? __bfloat162float(xe[0]) : 0.f;
      const float xz = use ? __bfloat162float(xe[H]) : 0.f;
      const float xn = use ? __bfloat162float(xe[2 * H]) : 0.f;
      const bool keep = kMasked && row[e] < rows && vs_s[slot * kRows + row[e]] == 0;
      const float hr = acc[0][0][e] + acc[0][1][e] + bias[0][e];
      const float hz = acc[1][0][e] + acc[1][1][e] + bias[1][e];
      const float hn = acc[2][0][e] + acc[2][1][e] + bias[2][e];
      const float rg = sigmoid(xr + hr);
      const float zg = sigmoid(xz + hz);
      const float ng = tanhf(xn + rg * hn);
      const float h_new = (1.f - zg) * ng + zg * h[e];
      h[e] = keep ? h[e] : h_new;
      if (unit[e] < H) hnxt[row[e] * S + unit[e]] = __float2bfloat16(h[e]);
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));  // step t + 1 has landed
    __syncthreads();
  }
  store_hs(a, a.steps - 1, b0, rows, hb_s + (a.steps & 1) * kRows * S, S);

#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (live[e]) a.h_out[(size_t)(b0 + row[e]) * H + unit[e]] = h[e];
}

template <bool kMasked>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  if (a.steps < 1 || a.batch < 1 || a.hidden < 1) return cudaErrorInvalidValue;
  const Layout L = make_layout(a.hidden);
  const int warps = n_warps(a.hidden);
  if (warps > kMaxWarps) return cudaErrorInvalidValue;
  int dev, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (L.total > (size_t)max_smem) return cudaErrorInvalidValue;
  const int grid = (a.batch + kRows - 1) / kRows;
  if (warps <= kRegSteps) {
    err = cudaFuncSetAttribute(gru_scan_kernel<kMasked, kRegSteps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
    gru_scan_kernel<kMasked, kRegSteps><<<grid, warps * 32, L.total, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(gru_scan_kernel<kMasked, kMaxWarps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
    gru_scan_kernel<kMasked, kMaxWarps><<<grid, warps * 32, L.total, stream>>>(a);
  }
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
