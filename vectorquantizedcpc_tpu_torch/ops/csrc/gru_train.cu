// GRU scan at any width over a cooperative grid: the training forward (with
// residuals), the same forward without them, and the reverse-time backward.
//
// Replaces vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel (training
// variant, save_residuals=True; and the no-grad variant wherever H is too
// wide for gru_scan.cu's one-block kernel) and
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
// 0.80 ms at the bf16 tensor-core peak. Both are latency-bound instead:
// 5,120 dependent steps, each a (B, H) x (H, 3H) product. The TPU kernel
// keeps wh (4.6 MiB) in one core's VMEM; one H100 block holds at most
// 227 KB, so wh is spread over the SMs:
//   - a persistent cooperative grid, one block per SM; block j owns hidden
//     units [j U, j U + U) (U = ceil(H / SMs): 128 blocks x 7 units);
//   - forward: the block keeps its 3U columns of wh in shared memory for
//     all steps. Each step it stages bf16(h) of the step before (hs[t - 1],
//     which every block wrote; bf16(h0) at t = 0) in tiles of 32 rows, forms
//     its columns of hproj with mma.sync (bf16 in, f32 accumulation; warps
//     split the H-deep sum and add their parts in shared memory), then the
//     gates of its units, and writes hs, acts, hn. One grid barrier per
//     step: hs[t] is the exchange buffer, so no buffer is reused;
//   - backward: the block keeps its U rows of wh. Each step it first makes
//     its units' dgx, dgh from the streamed residuals and its f32 carry,
//     then one grid barrier, then stages all of dgh[t] (B x 3H) in tiles of
//     16 rows and forms its units' dgh @ wh^T with mma.sync. That read of
//     B 3H 2 bytes per block per step (172 KB at B 32) from L2 is the price
//     of one barrier a step; owning columns instead would need a
//     cross-block reduction and a second barrier.
// Exchange reads use __ldcg (L1 is not coherent across SMs); the grid
// barrier orders them after the writes. Shared-memory rows are padded by 8
// bf16 so that fragment loads hit distinct banks; the K padding is zero.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdRows = 32;  // batch rows of one forward h tile
constexpr int kBwdRows = 16;  // batch rows of one backward dgh tile
constexpr int kPad = 8;       // bf16 elements after each shared-memory row

struct FwdArgs {
  const __nv_bfloat16* xproj;  // (T, B, 3H)
  const __nv_bfloat16* wh;     // (H, 3H)
  const float* bh;             // (3H,)
  const float* h0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H)
  __nv_bfloat16* acts;         // (T, B, 3H) residuals: r, z, n
  __nv_bfloat16* hn;           // (T, B, H) residual: the recurrent n term
  float* h_out;                // (B, H)
  int steps, batch, hidden, units;
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
  int steps, batch, hidden, units;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

// Product slots of 16 x 8 f32 partial sums: one per warp, or one per tile
// pair where there are more pairs than warps (no K split then).
__host__ __device__ __forceinline__ int n_slots(int tile_pairs) {
  return tile_pairs > kWarps ? tile_pairs : kWarps;
}

struct FwdLayout {
  size_t wh, h, part, carry, total;
  int kp, stride, np;
};

// Forward shared memory; the same on the host (size) and the card.
// gru_train.py:grid_smem_bytes mirrors it.
__host__ __device__ __forceinline__ FwdLayout fwd_layout(int B, int H, int U) {
  FwdLayout L;
  L.kp = round_up(H, 16);
  L.stride = L.kp + kPad;
  L.np = round_up(3 * U, 8);
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)L.np * L.stride);
  L.h = take(&off, sizeof(__nv_bfloat16) * (size_t)kFwdRows * L.stride);
  L.part = take(&off, sizeof(float) * 128 * n_slots(2 * (L.np / 8)));
  L.carry = take(&off, sizeof(float) * (size_t)B * U);
  L.total = off;
  return L;
}

struct BwdLayout {
  size_t wh, d, part, carry, dhz, total;
  int kp, stride, np;
};

__host__ __device__ __forceinline__ BwdLayout bwd_layout(int B, int H, int U) {
  BwdLayout L;
  L.kp = round_up(3 * H, 16);
  L.stride = L.kp + kPad;
  L.np = round_up(U, 8);
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)L.np * L.stride);
  L.d = take(&off, sizeof(__nv_bfloat16) * (size_t)kBwdRows * L.stride);
  L.part = take(&off, sizeof(float) * 128 * n_slots(L.np / 8));
  L.carry = take(&off, sizeof(float) * (size_t)B * U);
  L.dhz = take(&off, sizeof(float) * (size_t)B * U);
  L.total = off;
  return L;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16 x 16, row-major) B (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Partial products of a (mt_count*16 x kp) tile ``a_s`` and ``nt_count*8``
// columns ``b_s`` (column-major, ``stride`` apart), both in shared memory.
// Each warp takes (row tile, column tile, K part) triples and writes its 16 x 8
// sums to slot ((mt * nt_count + nt) * kparts + kpart) of ``part``; returns
// kparts. Rows and columns beyond the data give sums nobody reads.
__device__ __forceinline__ int tile_products(const __nv_bfloat16* a_s, const __nv_bfloat16* b_s,
                                             int stride, int kp, int mt_count, int nt_count,
                                             float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int pairs = mt_count * nt_count;
  const int kparts = pairs >= kWarps ? 1 : kWarps / pairs;
  const int ksteps = kp / 16;
  for (int task = warp; task < pairs * kparts; task += kWarps) {
    const int pair = task / kparts, kpart = task % kparts;
    const int mt = pair / nt_count, nt = pair % nt_count;
    const int k_lo = kpart * ksteps / kparts, k_hi = (kpart + 1) * ksteps / kparts;
    const __nv_bfloat16* a0 = a_s + (size_t)(mt * 16 + g) * stride + q * 2;
    const __nv_bfloat16* a1 = a0 + 8 * stride;
    const __nv_bfloat16* b0 = b_s + (size_t)(nt * 8 + g) * stride + q * 2;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = k_lo; ks < k_hi; ++ks) {
      const int k = ks * 16;
      const uint32_t a[4] = {ld_pair(a0 + k), ld_pair(a1 + k), ld_pair(a0 + k + 8),
                             ld_pair(a1 + k + 8)};
      const uint32_t b[2] = {ld_pair(b0 + k), ld_pair(b0 + k + 8)};
      mma_16816(c, a, b);
    }
    float* out = part + (size_t)task * 128;
    out[g * 8 + q * 2] = c[0];
    out[g * 8 + q * 2 + 1] = c[1];
    out[(g + 8) * 8 + q * 2] = c[2];
    out[(g + 8) * 8 + q * 2 + 1] = c[3];
  }
  return kparts;
}

// Sum of the K parts of output (row, col) of tile_products.
__device__ __forceinline__ float product_at(const float* part, int row, int col, int nt_count,
                                            int kparts) {
  const int pair = (row / 16) * nt_count + col / 8;
  const float* p = part + (size_t)pair * kparts * 128 + (row % 16) * 8 + col % 8;
  float s = 0.f;
  for (int k = 0; k < kparts; ++k) s += p[k * 128];
  return s;
}

// rows x n bf16 from global ``src`` (rows ``n`` apart, read through L2) into
// shared ``dst`` (rows ``stride`` apart); 16-byte copies where aligned.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                           int n, int stride) {
  if (n % 8 == 0) {
    const int chunks = n / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = i % chunks;
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)r * n) + c);
      *reinterpret_cast<uint4*>(dst + (size_t)r * stride + c * 8) = v;
    }
  } else {
    const unsigned short* bits = reinterpret_cast<const unsigned short*>(src);
    for (int i = threadIdx.x; i < rows * n; i += kThreads) {
      const int r = i / n, k = i % n;
      dst[(size_t)r * stride + k] = __ushort_as_bfloat16(__ldcg(bits + (size_t)r * n + k));
    }
  }
}

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1) gru_scan_grid_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, U = a.units;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int n_cols = 3 * nu;  // local column lc = gate * nu + unit
  const int nt_count = (n_cols + 7) / 8;

  const FwdLayout L = fwd_layout(B, H, U);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]

  // This block's columns of wh, column-major, zero beyond H and 3 nu (read
  // row by row, so that neighbouring threads read neighbouring columns).
  for (int i = tid; i < L.np * L.kp; i += kThreads) {
    const int k = i / L.np, lc = i % L.np;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (lc < n_cols && k < H) v = a.wh[(size_t)k * H3 + (lc / nu) * H + u0 + lc % nu];
    wh_s[(size_t)lc * L.stride + k] = v;
  }
  for (int i = tid; i < kFwdRows * (L.kp - H); i += kThreads) {
    const int r = i / (L.kp - H), k = H + i % (L.kp - H);
    h_s[(size_t)r * L.stride + k] = __float2bfloat16(0.f);
  }
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, u = i % nu;
    carry_s[b * U + u] = a.h0[(size_t)b * H + u0 + u];
  }

  for (int t = 0; t < a.steps; ++t) {
    for (int r0 = 0; r0 < B; r0 += kFwdRows) {
      const int rows = min(kFwdRows, B - r0);
      // This thread's first gate inputs, loaded ahead of the product.
      float x0[3] = {0.f, 0.f, 0.f};
      if (tid < rows * nu) {
        const int b = r0 + tid / nu, j = u0 + tid % nu;
        const __nv_bfloat16* xrow = a.xproj + ((size_t)t * B + b) * H3;
        x0[0] = __bfloat162float(xrow[j]);
        x0[1] = __bfloat162float(xrow[H + j]);
        x0[2] = __bfloat162float(xrow[2 * H + j]);
      }
      __syncthreads();  // the last tile's h_s and part_s are read
      if (t == 0) {
        for (int i = tid; i < rows * H; i += kThreads) {
          const int r = i / H, k = i % H;
          h_s[(size_t)r * L.stride + k] = __float2bfloat16(a.h0[(size_t)(r0 + r) * H + k]);
        }
      } else {
        stage_rows(h_s, a.hs + ((size_t)(t - 1) * B + r0) * H, rows, H, L.stride);
      }
      __syncthreads();
      const int mt_count = (rows + 15) / 16;
      const int kparts = tile_products(h_s, wh_s, L.stride, L.kp, mt_count, nt_count, part_s);
      __syncthreads();

      for (int i = tid; i < rows * nu; i += kThreads) {
        const int rb = i / nu, u = i % nu, b = r0 + rb, j = u0 + u;
        float xr = x0[0], xz = x0[1], xn = x0[2];
        if (i != tid) {
          const __nv_bfloat16* xrow = a.xproj + ((size_t)t * B + b) * H3;
          xr = __bfloat162float(xrow[j]);
          xz = __bfloat162float(xrow[H + j]);
          xn = __bfloat162float(xrow[2 * H + j]);
        }
        const float hr = product_at(part_s, rb, u, nt_count, kparts) + a.bh[j];
        const float hz = product_at(part_s, rb, nu + u, nt_count, kparts) + a.bh[H + j];
        const float hn = product_at(part_s, rb, 2 * nu + u, nt_count, kparts) + a.bh[2 * H + j];
        const float r = sigmoid(xr + hr);
        const float z = sigmoid(xz + hz);
        const float n = tanhf(xn + r * hn);
        const float h_new = (1.f - z) * n + z * carry_s[b * U + u];
        carry_s[b * U + u] = h_new;
        const size_t row = (size_t)t * B + b;
        a.hs[row * H + j] = __float2bfloat16(h_new);
        if (kSave) {
          a.acts[row * H3 + j] = __float2bfloat16(r);
          a.acts[row * H3 + H + j] = __float2bfloat16(z);
          a.acts[row * H3 + 2 * H + j] = __float2bfloat16(n);
          a.hn[row * H + j] = __float2bfloat16(hn);
        }
        if (t == a.steps - 1) a.h_out[(size_t)b * H + j] = h_new;
      }
    }
    grid.sync();  // hs[t] is complete for the next step
  }
}

__global__ void __launch_bounds__(kThreads, 1) gru_scan_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, U = a.units;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int nt_count = (nu + 7) / 8;

  const BwdLayout L = bwd_layout(B, H, U);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* d_s = reinterpret_cast<__nv_bfloat16*>(smem + L.d);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]
  float* dhz_s = reinterpret_cast<float*>(smem + L.dhz);      // dh z, [b][u]

  // This block's rows of wh (each a column of wh^T), zero beyond 3H and nu.
  for (int i = tid; i < L.np * L.kp; i += kThreads) {
    const int u = i / L.kp, g = i % L.kp;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (u < nu && g < H3) v = a.wh[(size_t)(u0 + u) * H3 + g];
    wh_s[(size_t)u * L.stride + g] = v;
  }
  for (int i = tid; i < kBwdRows * (L.kp - H3); i += kThreads) {
    const int r = i / (L.kp - H3), g = H3 + i % (L.kp - H3);
    d_s[(size_t)r * L.stride + g] = __float2bfloat16(0.f);
  }
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, u = i % nu;
    carry_s[b * U + u] = a.dh_t[(size_t)b * H + u0 + u];
  }
  __syncthreads();

  for (int t = a.steps - 1; t >= 0; --t) {
    // This block's units: the gate gradients from the residuals and carry.
    for (int i = tid; i < B * nu; i += kThreads) {
      const int b = i / nu, u = i % nu, j = u0 + u;
      const size_t row = (size_t)t * B + b;
      const float r = __bfloat162float(a.acts[row * H3 + j]);
      const float z = __bfloat162float(a.acts[row * H3 + H + j]);
      const float n = __bfloat162float(a.acts[row * H3 + 2 * H + j]);
      const float hn = __bfloat162float(a.hn[row * H + j]);
      const float h_prev = __bfloat162float(a.hprev[row * H + j]);
      const float dh = carry_s[b * U + u] + __bfloat162float(a.dhs[row * H + j]);
      const float dn = dh * (1.f - z);
      const float dz = dh * (h_prev - n);
      const float da_n = dn * (1.f - n * n);
      const float dr = da_n * hn;
      const float dhn = da_n * r;
      const float da_r = dr * r * (1.f - r);
      const float da_z = dz * z * (1.f - z);
      const __nv_bfloat16 bdr = __float2bfloat16(da_r), bdz = __float2bfloat16(da_z);
      a.dgx[row * H3 + j] = bdr;
      a.dgx[row * H3 + H + j] = bdz;
      a.dgx[row * H3 + 2 * H + j] = __float2bfloat16(da_n);
      a.dgh[row * H3 + j] = bdr;
      a.dgh[row * H3 + H + j] = bdz;
      a.dgh[row * H3 + 2 * H + j] = __float2bfloat16(dhn);
      dhz_s[b * U + u] = dh * z;
    }
    grid.sync();  // dgh[t] is complete

    // carry = dh z + dgh[t] @ wh^T for this block's units, 16 rows at a time.
    for (int r0 = 0; r0 < B; r0 += kBwdRows) {
      const int rows = min(kBwdRows, B - r0);
      __syncthreads();  // the last tile's d_s and part_s are read
      stage_rows(d_s, a.dgh + ((size_t)t * B + r0) * H3, rows, H3, L.stride);
      __syncthreads();
      const int kparts = tile_products(d_s, wh_s, L.stride, L.kp, 1, nt_count, part_s);
      __syncthreads();
      for (int i = tid; i < rows * nu; i += kThreads) {
        const int rb = i / nu, u = i % nu, b = r0 + rb;
        carry_s[b * U + u] = dhz_s[b * U + u] + product_at(part_s, rb, u, nt_count, kparts);
      }
    }
    __syncthreads();  // the carry is read by other threads next step
  }

  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, u = i % nu;
    a.dh0[(size_t)b * H + u0 + u] = carry_s[b * U + u];
  }
}

struct Plan {
  int grid, units;
  size_t fwd_smem, bwd_smem;
};

// Plans a launch at these widths and readies the kernels' shared memory.
// ``units`` 0 takes ceil(H / SMs); refuses what cannot be resident at once.
cudaError_t plan_launch(int batch, int hidden, int units, Plan* p) {
  if (batch < 1 || hidden < 1 || units < 0) return cudaErrorInvalidValue;
  int dev, sms, coop, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  p->units = units > 0 ? units : (hidden + sms - 1) / sms;
  p->grid = (hidden + p->units - 1) / p->units;
  p->fwd_smem = fwd_layout(batch, hidden, p->units).total;
  p->bwd_smem = bwd_layout(batch, hidden, p->units).total;
  if (p->fwd_smem > (size_t)max_smem || p->bwd_smem > (size_t)max_smem)
    return cudaErrorInvalidValue;
  const void* kernels[3] = {(const void*)gru_scan_grid_kernel<true>,
                            (const void*)gru_scan_grid_kernel<false>,
                            (const void*)gru_scan_bwd_kernel};
  const size_t smem[3] = {p->fwd_smem, p->fwd_smem, p->bwd_smem};
  for (int k = 0; k < 3; ++k) {
    err = cudaFuncSetAttribute(kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem[k]);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[k], kThreads, smem[k]);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < p->grid) return cudaErrorCooperativeLaunchTooLarge;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks, hidden units per block and the forward's and backward's dynamic
// shared memory bytes of a launch at these widths (``units`` 0: the
// default); returns a cudaError_t.
int vq_gru_grid_plan(int batch, int hidden, int units, int* out4) {
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, units, &p);
  if (err != cudaSuccess) return (int)err;
  out4[0] = p.grid;
  out4[1] = p.units;
  out4[2] = (int)p.fwd_smem;
  out4[3] = (int)p.bwd_smem;
  return 0;
}

// The forward on ``stream``; with ``save`` 0, ``acts`` and ``hn`` are not
// written (and may be null). Allocates nothing and does not synchronise;
// returns cudaGetLastError() after the launch.
int vq_gru_scan_grid_launch(const void* xproj, const void* wh, const void* bh, const void* h0,
                            void* hs, void* acts, void* hn, void* h_out, int steps, int batch,
                            int hidden, int save, void* stream) {
  if (steps < 1 || (save && (acts == nullptr || hn == nullptr))) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, 0, &p);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.wh = static_cast<const __nv_bfloat16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.h0 = static_cast<const float*>(h0);
  a.hs = static_cast<__nv_bfloat16*>(hs);
  a.acts = static_cast<__nv_bfloat16*>(acts);
  a.hn = static_cast<__nv_bfloat16*>(hn);
  a.h_out = static_cast<float*>(h_out);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.units = p.units;
  void* params[] = {&a};
  const void* kernel = save ? (const void*)gru_scan_grid_kernel<true>
                            : (const void*)gru_scan_grid_kernel<false>;
  cudaLaunchCooperativeKernel(kernel, dim3(p.grid), dim3(kThreads), params, p.fwd_smem,
                              static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The backward on ``stream``; the same contract as the forward's launch.
int vq_gru_scan_bwd_launch(const void* acts, const void* hn, const void* hprev, const void* dhs,
                           const void* wh, const void* dh_t, void* dgx, void* dgh, void* dh0,
                           int steps, int batch, int hidden, void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, 0, &p);
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
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.units = p.units;
  void* params[] = {&a};
  cudaLaunchCooperativeKernel((const void*)gru_scan_bwd_kernel, dim3(p.grid), dim3(kThreads),
                              params, p.bwd_smem, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // extern "C"
