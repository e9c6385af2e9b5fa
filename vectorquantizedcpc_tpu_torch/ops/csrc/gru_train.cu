// GRU scan at any width over a cooperative grid: the training forward (with
// residuals), the same forward without them, and the reverse-time backward.
//
// Replaces vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel (training
// variant, save_residuals=True; and the no-grad variant wherever H is too
// wide for gru_scan.cu's one-block kernel),
// vectorquantizedcpc_tpu/ops/gru_train.py:_fwd_kernel_masked where H is too
// wide for it (template flag kMask), and
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
// Where a block's columns (forward) or rows (backward) of wh and its staged
// tile do not fit 227 KB at their whole depth (on 132 SMs, H above about
// 1,520 forward and 1,150 backward), the plan picks a K chunk and the block
// stages, for each tile, its slice of wh and the tile chunk by chunk, adding
// up the chunks' products: wh is then read from L2 every step instead of
// once. Exchange reads use __ldcg (L1 is not coherent across SMs); the grid
// barrier orders them after the writes. Shared-memory rows are padded by 8
// bf16 so that fragment loads hit distinct banks; the K padding is zero.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace vq_grid;

struct FwdArgs {
  const __nv_bfloat16* xproj;  // (T, B, 3H)
  const int* valid;            // (T, B) masked variant: rows at 0 keep their carry
  const __nv_bfloat16* wh;     // (H, 3H)
  const float* bh;             // (3H,)
  const float* h0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H)
  __nv_bfloat16* acts;         // (T, B, 3H) residuals: r, z, n
  __nv_bfloat16* hn;           // (T, B, H) residual: the recurrent n term
  float* h_out;                // (B, H)
  int steps, batch, hidden, units;
  int chunk;                   // K extent staged at once (H: all of it)
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
  int chunk;                   // K extent staged at once (3H: all of it)
};

struct FwdLayout {
  size_t wh, h, part, carry, total;
  int kp, stride, np;
};

// Forward shared memory at K chunk ``kc`` (H: all of it); the same on the
// host (size) and the card. gru_train.py:grid_smem_bytes mirrors it.
__host__ __device__ __forceinline__ FwdLayout fwd_layout(int B, int H, int U, int kc) {
  FwdLayout L;
  L.kp = round_up(min(H, kc), 16);
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

__host__ __device__ __forceinline__ BwdLayout bwd_layout(int B, int H, int U, int kc) {
  BwdLayout L;
  L.kp = round_up(min(3 * H, kc), 16);
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

// kSave: also write the residuals acts and hn. kMask: rows whose valid[t, b]
// is 0 keep their carry at step t, and hs[t] holds bf16 of it (the serving
// PreNet's reverse direction, _fwd_kernel_masked). kStream: the plan's K
// chunk is below H, so wh is staged with each chunk of the tile; otherwise
// one pass over all of K with wh resident.
template <bool kSave, bool kMask, bool kStream>
__global__ void __launch_bounds__(kThreads, 1) gru_scan_grid_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, U = a.units;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int n_cols = 3 * nu;  // local column lc = gate * nu + unit
  const int nt_count = (n_cols + 7) / 8;
  const int n_chunks = kStream ? (H + a.chunk - 1) / a.chunk : 1;

  const FwdLayout L = fwd_layout(B, H, U, a.chunk);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]

  if (!kStream) {  // all of this block's columns, resident for every step
    stage_wh_cols(wh_s, a.wh, 3, H, u0, nu, L.np, L.stride, 0, H, L.kp);
    zero_cols(h_s, kFwdRows, H, L.kp, L.stride);
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
      const int mt_count = (rows + 15) / 16;
      int kparts = 0;
      for (int c = 0; c < n_chunks; ++c) {
        const int k0 = kStream ? c * a.chunk : 0;
        const int kn = kStream ? min(a.chunk, H - k0) : H;
        const int kp = kStream ? round_up(kn, 16) : L.kp;
        __syncthreads();  // the last tile's (or chunk's) h_s, wh_s and part_s are read
        if (t == 0) {
          for (int i = tid; i < rows * kn; i += kThreads) {
            const int r = i / kn, k = i % kn;
            h_s[(size_t)r * L.stride + k] =
                __float2bfloat16(a.h0[(size_t)(r0 + r) * H + k0 + k]);
          }
        } else {
          stage_rows(h_s, a.hs + ((size_t)(t - 1) * B + r0) * H + k0, rows, kn, H, L.stride);
        }
        if (kStream) {
          stage_wh_cols(wh_s, a.wh, 3, H, u0, nu, L.np, L.stride, k0, kn, kp);
          zero_cols(h_s, kFwdRows, kn, kp, L.stride);
        }
        __syncthreads();
        kparts =
            tile_products(h_s, wh_s, L.stride, kp, mt_count, nt_count, part_s, kStream && c > 0);
      }
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
        const float carry = carry_s[b * U + u];
        float h_new = (1.f - z) * n + z * carry;
        if (kMask && a.valid[(size_t)t * B + b] == 0) h_new = carry;
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

template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1) gru_scan_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, U = a.units;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int nt_count = (nu + 7) / 8;
  const int n_chunks = kStream ? (H3 + a.chunk - 1) / a.chunk : 1;

  const BwdLayout L = bwd_layout(B, H, U, a.chunk);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* d_s = reinterpret_cast<__nv_bfloat16*>(smem + L.d);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* carry_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]
  float* dhz_s = reinterpret_cast<float*>(smem + L.dhz);      // dh z, [b][u]

  if (!kStream) {  // all of this block's rows, resident for every step
    stage_wh_rows(wh_s, a.wh, H3, u0, nu, L.np, L.stride, 0, H3, L.kp);
    zero_cols(d_s, kBwdRows, H3, L.kp, L.stride);
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
      int kparts = 0;
      for (int c = 0; c < n_chunks; ++c) {
        const int k0 = kStream ? c * a.chunk : 0;
        const int kn = kStream ? min(a.chunk, H3 - k0) : H3;
        const int kp = kStream ? round_up(kn, 16) : L.kp;
        __syncthreads();  // the last tile's (or chunk's) d_s, wh_s and part_s are read
        stage_rows(d_s, a.dgh + ((size_t)t * B + r0) * H3 + k0, rows, kn, H3, L.stride);
        if (kStream) {
          stage_wh_rows(wh_s, a.wh, H3, u0, nu, L.np, L.stride, k0, kn, kp);
          zero_cols(d_s, kBwdRows, kn, kp, L.stride);
        }
        __syncthreads();
        kparts = tile_products(d_s, wh_s, L.stride, kp, 1, nt_count, part_s, kStream && c > 0);
      }
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
  int grid, units, fwd_chunk, bwd_chunk;
  size_t fwd_smem, bwd_smem;
};

// The forward kernel of a launch: with residuals (``save``), masked, or
// neither; streaming wh in K chunks or not.
const void* fwd_kernel(bool save, bool mask, bool stream) {
  if (stream)
    return save ? (const void*)gru_scan_grid_kernel<true, false, true>
           : mask ? (const void*)gru_scan_grid_kernel<false, true, true>
                  : (const void*)gru_scan_grid_kernel<false, false, true>;
  return save ? (const void*)gru_scan_grid_kernel<true, false, false>
         : mask ? (const void*)gru_scan_grid_kernel<false, true, false>
                : (const void*)gru_scan_grid_kernel<false, false, false>;
}

const void* bwd_kernel(bool stream) {
  return stream ? (const void*)gru_scan_bwd_kernel<true> : (const void*)gru_scan_bwd_kernel<false>;
}

// Plans a launch at these widths and readies the kernels' shared memory.
// ``units`` 0 takes ceil(H / SMs); each K chunk is all of K (H forward, 3H
// backward) where it fits, else the widest that does. Refuses a block that
// does not fit even a 16-deep chunk or a grid that cannot be resident.
cudaError_t plan_launch(int batch, int hidden, int units, Plan* p) {
  if (batch < 1 || hidden < 1 || units < 0) return cudaErrorInvalidValue;
  int sms, max_smem;
  cudaError_t err = device_limits(&sms, &max_smem);
  if (err != cudaSuccess) return err;
  p->units = units > 0 ? units : (hidden + sms - 1) / sms;
  p->grid = (hidden + p->units - 1) / p->units;
  const int U = p->units;
  p->fwd_chunk = fit_chunk(hidden, max_smem,
                           [&](int kc) { return fwd_layout(batch, hidden, U, kc).total; });
  p->bwd_chunk = fit_chunk(3 * hidden, max_smem,
                           [&](int kc) { return bwd_layout(batch, hidden, U, kc).total; });
  if (p->fwd_chunk == 0 || p->bwd_chunk == 0) return cudaErrorInvalidValue;
  p->fwd_smem = fwd_layout(batch, hidden, U, p->fwd_chunk).total;
  p->bwd_smem = bwd_layout(batch, hidden, U, p->bwd_chunk).total;
  const bool fwd_stream = p->fwd_chunk < hidden;
  const void* kernels[4] = {
      fwd_kernel(true, false, fwd_stream), fwd_kernel(false, false, fwd_stream),
      fwd_kernel(false, true, fwd_stream), bwd_kernel(p->bwd_chunk < 3 * hidden)};
  const size_t smem[4] = {p->fwd_smem, p->fwd_smem, p->fwd_smem, p->bwd_smem};
  for (int k = 0; k < 4; ++k) {
    err = ready_resident(kernels[k], smem[k], p->grid, sms);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks, hidden units per block, the forward's and backward's dynamic
// shared memory bytes and their K chunks of a launch at these widths
// (``units`` 0: the default); returns a cudaError_t.
int vq_gru_grid_plan(int batch, int hidden, int units, int* out6) {
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, units, &p);
  if (err != cudaSuccess) return (int)err;
  out6[0] = p.grid;
  out6[1] = p.units;
  out6[2] = (int)p.fwd_smem;
  out6[3] = (int)p.bwd_smem;
  out6[4] = p.fwd_chunk;
  out6[5] = p.bwd_chunk;
  return 0;
}

// The forward on ``stream``; with ``save`` 0, ``acts`` and ``hn`` are not
// written (and may be null); a non-null ``valid`` (T, B) int32 masks rows
// (and takes ``save`` 0). Allocates nothing and does not synchronise;
// returns cudaGetLastError() after the launch.
int vq_gru_scan_grid_launch(const void* xproj, const void* valid, const void* wh, const void* bh,
                            const void* h0, void* hs, void* acts, void* hn, void* h_out, int steps,
                            int batch, int hidden, int save, void* stream) {
  if (steps < 1 || (save && (acts == nullptr || hn == nullptr || valid != nullptr)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, 0, &p);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.xproj = static_cast<const __nv_bfloat16*>(xproj);
  a.valid = static_cast<const int*>(valid);
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
  a.chunk = p.fwd_chunk;
  void* params[] = {&a};
  const void* kernel = fwd_kernel(save, valid != nullptr, p.fwd_chunk < hidden);
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
  a.chunk = p.bwd_chunk;
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(bwd_kernel(p.bwd_chunk < 3 * hidden), dim3(p.grid), dim3(kThreads),
                              params, p.bwd_smem, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // extern "C"
