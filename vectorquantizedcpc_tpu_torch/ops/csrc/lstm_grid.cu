// LSTM scan at any width over a cooperative grid: the forward (inference and
// training variants) and the reverse-time backward, for the widths that
// lstm_scan.cu's cluster of 8 CTAs cannot hold (H not a multiple of 8,
// H > 432 forward, H > 352 backward; lstm_scan.py:scan_route picks).
//
// Forward. Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_fwd_kernel at
// those widths. Per step t and batch row b (torch gate order i, f, g, o):
//   gates = f32(xproj[t, b]) + bf16(h) @ wh                     (f32 acc)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   hs[t, b] = bf16(h); c carries in f32.
// The training variant (template flag kSave) also writes c_prev[t, b] (f32)
// and acts[t, b] = bf16(sigmoid i, sigmoid f, tanh g, sigmoid o); its hs,
// h_T and c_T are the inference variant's bits.
//
// Backward. Replaces vectorquantizedcpc_tpu/ops/lstm_scan.py:_bwd_kernel at
// those widths: lstm_scan.cu's arithmetic (dgates[t] = bf16(da), dh =
// bf16(da) @ wh^T, dc *= f), carried from (dh_T, dc_T) down to t = 0.
//
// What bounds them on an H100: at the CPC shape with a 512-wide context
// (B 64, T 70) each moves ~51 MB (~15 us at 3.35 TB/s) and does 9.4 GFLOP
// (~9.5 us at the bf16 tensor rate); both are latency-bound instead: T
// dependent steps, each a (B, H) x (H, 4H) product. wh (H x 4H bf16, 2 MB at
// H 512) is spread over the SMs, as gru_train.cu spreads the GRU's:
//   - a persistent cooperative grid, one block per SM; block j owns hidden
//     units [j U, j U + U) (U = ceil(H / SMs): 128 blocks x 4 units at 512);
//   - forward: the block keeps its units' 4U i/f/g/o columns of wh in shared
//     memory for all steps. Each step it stages all of bf16(h_{t-1}) from
//     hs[t - 1] (which every block wrote before the barrier; bf16(h0) at
//     t = 0) in tiles of 32 rows, forms its columns of the product with
//     mma.sync, then the gates of its units with their c carried in shared
//     memory. hs is the exchange buffer: one grid barrier per step;
//   - backward: the block keeps its U rows of wh. Each step it makes its
//     units' da from the streamed residuals and its f32 carries, writes
//     dgates[t], then one grid barrier, then stages all of dgates[t] (B x 4H
//     bf16) in tiles of 16 rows and forms its units' dh = dgates[t] @ wh^T.
// H need not be a multiple of anything: the K padding of the product is
// zero in shared memory. Where a block's columns (forward) or rows
// (backward) of wh and its staged tile do not fit 227 KB at their whole
// depth (on 132 SMs: H above 1,376 forward, above 1,056 backward), the plan
// picks a K chunk and the block stages, for each tile, its slice of wh and
// the tile chunk by chunk, adding up the chunks' products: wh is then read
// from L2 every step instead of once. The plan refuses only a grid that
// cannot be resident at once or a block whose carries leave no room for a
// 16-deep chunk. Exchange reads use __ldcg (L1 is not coherent across SMs);
// the grid barrier orders them after the writes.

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
  const __nv_bfloat16* xproj;  // (T, B, 4H) input projection x @ wx + b
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* h0;             // (B, H)
  const float* c0;             // (B, H)
  __nv_bfloat16* hs;           // (T, B, H), also the exchange buffer
  __nv_bfloat16* acts;         // (T, B, 4H) activated gates (training variant)
  float* c_prev;               // (T, B, H) cell state entering each step (training)
  float* h_out;                // (B, H)
  float* c_out;                // (B, H)
  int steps, batch, hidden, units;
  int chunk;                   // K extent staged at once (H: all of it)
};

struct BwdArgs {
  const __nv_bfloat16* acts;   // (T, B, 4H)
  const float* c_prev;         // (T, B, H)
  const __nv_bfloat16* dhs;    // (T, B, H)
  const __nv_bfloat16* wh;     // (H, 4H)
  const float* dh_t;           // (B, H)
  const float* dc_t;           // (B, H)
  __nv_bfloat16* dgates;       // (T, B, 4H), also the exchange buffer
  float* dh0;                  // (B, H)
  float* dc0;                  // (B, H)
  int steps, batch, hidden, units;
  int chunk;                   // K extent staged at once (4H: all of it)
};

struct Layout {
  size_t wh, tile, part, carry, carry2, total;  // carry2: the backward's only
  int kp, stride, np;
};

// Forward shared memory at K chunk ``kc`` (H: all of it); the same on the
// host (size) and the card. lstm_scan.py:grid_smem_bytes mirrors it.
__host__ __device__ __forceinline__ Layout fwd_layout(int B, int H, int U, int kc) {
  Layout L = {};
  L.kp = round_up(min(H, kc), 16);
  L.stride = L.kp + kPad;
  L.np = round_up(4 * U, 8);
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)L.np * L.stride);
  L.tile = take(&off, sizeof(__nv_bfloat16) * (size_t)kFwdRows * L.stride);
  L.part = take(&off, sizeof(float) * 128 * n_slots(2 * (L.np / 8)));
  L.carry = take(&off, sizeof(float) * (size_t)B * U);  // c
  L.total = off;
  return L;
}

// Backward: U rows of wh (each a column of wh^T), the dgates tile, the parts,
// the dh and dc carries.
__host__ __device__ __forceinline__ Layout bwd_layout(int B, int H, int U, int kc) {
  Layout L = {};
  L.kp = round_up(min(4 * H, kc), 16);
  L.stride = L.kp + kPad;
  L.np = round_up(U, 8);
  size_t off = 0;
  L.wh = take(&off, sizeof(__nv_bfloat16) * (size_t)L.np * L.stride);
  L.tile = take(&off, sizeof(__nv_bfloat16) * (size_t)kBwdRows * L.stride);
  L.part = take(&off, sizeof(float) * 128 * n_slots(L.np / 8));
  L.carry = take(&off, sizeof(float) * (size_t)B * U);   // dh
  L.carry2 = take(&off, sizeof(float) * (size_t)B * U);  // dc
  L.total = off;
  return L;
}

// kStream: the plan's K chunk is below H, so wh is staged with each chunk
// of the tile; otherwise one pass over all of K with wh resident.
template <bool kSave, bool kStream>
__global__ void __launch_bounds__(kThreads, 1) lstm_scan_grid_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch, U = a.units;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int n_cols = 4 * nu;  // local column lc = gate * nu + unit
  const int nt_count = (n_cols + 7) / 8;
  const int n_chunks = kStream ? (H + a.chunk - 1) / a.chunk : 1;

  const Layout L = fwd_layout(B, H, U, a.chunk);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.tile);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* c_s = reinterpret_cast<float*>(smem + L.carry);  // [b][u]

  if (!kStream) {  // all of this block's columns, resident for every step
    stage_wh_cols(wh_s, a.wh, 4, H, u0, nu, L.np, L.stride, 0, H, L.kp);
    zero_cols(h_s, kFwdRows, H, L.kp, L.stride);
  }
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, u = i % nu;
    c_s[b * U + u] = a.c0[(size_t)b * H + u0 + u];
  }

  for (int t = 0; t < a.steps; ++t) {
    for (int r0 = 0; r0 < B; r0 += kFwdRows) {
      const int rows = min(kFwdRows, B - r0);
      // This thread's first gate inputs, loaded ahead of the product.
      float x0[4] = {0.f, 0.f, 0.f, 0.f};
      if (tid < rows * nu) {
        const int b = r0 + tid / nu, j = u0 + tid % nu;
        const __nv_bfloat16* xrow = a.xproj + ((size_t)t * B + b) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) x0[g] = __bfloat162float(xrow[g * H]);
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
          stage_wh_cols(wh_s, a.wh, 4, H, u0, nu, L.np, L.stride, k0, kn, kp);
          zero_cols(h_s, kFwdRows, kn, kp, L.stride);
        }
        __syncthreads();
        kparts =
            tile_products(h_s, wh_s, L.stride, kp, mt_count, nt_count, part_s, kStream && c > 0);
      }
      __syncthreads();

      for (int i = tid; i < rows * nu; i += kThreads) {
        const int rb = i / nu, u = i % nu, b = r0 + rb, j = u0 + u;
        const size_t row = (size_t)t * B + b;
        float x[4] = {x0[0], x0[1], x0[2], x0[3]};
        if (i != tid) {
#pragma unroll
          for (int g = 0; g < 4; ++g) x[g] = __bfloat162float(a.xproj[row * H4 + g * H + j]);
        }
        float hp[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) hp[g] = product_at(part_s, rb, g * nu + u, nt_count, kparts);
        const float ig = sigmoid(x[0] + hp[0]);
        const float fg = sigmoid(x[1] + hp[1]);
        const float gg = tanhf(x[2] + hp[2]);
        const float og = sigmoid(x[3] + hp[3]);
        const float c_old = c_s[b * U + u];
        const float c = fg * c_old + ig * gg;
        const float h = og * tanhf(c);
        c_s[b * U + u] = c;
        a.hs[row * H + j] = __float2bfloat16(h);
        if (kSave) {
          a.c_prev[row * H + j] = c_old;
          __nv_bfloat16* arow = a.acts + row * H4 + j;
          arow[0] = __float2bfloat16(ig);
          arow[H] = __float2bfloat16(fg);
          arow[2 * H] = __float2bfloat16(gg);
          arow[3 * H] = __float2bfloat16(og);
        }
        if (t == a.steps - 1) {
          a.h_out[(size_t)b * H + j] = h;
          a.c_out[(size_t)b * H + j] = c;
        }
      }
    }
    grid.sync();  // hs[t] is complete for the next step
  }
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1) lstm_scan_grid_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch, U = a.units;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int nt_count = (nu + 7) / 8;
  const int n_chunks = kStream ? (H4 + a.chunk - 1) / a.chunk : 1;

  const Layout L = bwd_layout(B, H, U, a.chunk);
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  __nv_bfloat16* d_s = reinterpret_cast<__nv_bfloat16*>(smem + L.tile);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* dh_s = reinterpret_cast<float*>(smem + L.carry);   // [b][u]
  float* dc_s = reinterpret_cast<float*>(smem + L.carry2);  // [b][u]

  if (!kStream) {  // all of this block's rows, resident for every step
    stage_wh_rows(wh_s, a.wh, H4, u0, nu, L.np, L.stride, 0, H4, L.kp);
    zero_cols(d_s, kBwdRows, H4, L.kp, L.stride);
  }
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, u = i % nu;
    dh_s[b * U + u] = a.dh_t[(size_t)b * H + u0 + u];
    dc_s[b * U + u] = a.dc_t[(size_t)b * H + u0 + u];
  }
  __syncthreads();

  for (int t = a.steps - 1; t >= 0; --t) {
    // This block's units: the gate gradients from the residuals and carries.
    for (int i = tid; i < B * nu; i += kThreads) {
      const int b = i / nu, u = i % nu, j = u0 + u;
      const size_t row = (size_t)t * B + b;
      const __nv_bfloat16* arow = a.acts + row * H4 + j;
      const float ai = __bfloat162float(arow[0]);
      const float af = __bfloat162float(arow[H]);
      const float ag = __bfloat162float(arow[2 * H]);
      const float ao = __bfloat162float(arow[3 * H]);
      const float cp = a.c_prev[row * H + j];
      const float dh = dh_s[b * U + u] + __bfloat162float(a.dhs[row * H + j]);
      const float cc = af * cp + ai * ag;  // recomputed, not stored
      const float tc = tanhf(cc);
      const float d_o = dh * tc;
      float dc = dc_s[b * U + u] + dh * ao * (1.f - tc * tc);
      const float da[4] = {
          dc * ag * ai * (1.f - ai),
          dc * cp * af * (1.f - af),
          dc * ai * (1.f - ag * ag),
          d_o * ao * (1.f - ao),
      };
      dc_s[b * U + u] = dc * af;
      __nv_bfloat16* grow = a.dgates + row * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) grow[g * H] = __float2bfloat16(da[g]);
    }
    grid.sync();  // dgates[t] is complete

    // dh = dgates[t] @ wh^T for this block's units, 16 rows at a time.
    for (int r0 = 0; r0 < B; r0 += kBwdRows) {
      const int rows = min(kBwdRows, B - r0);
      int kparts = 0;
      for (int c = 0; c < n_chunks; ++c) {
        const int k0 = kStream ? c * a.chunk : 0;
        const int kn = kStream ? min(a.chunk, H4 - k0) : H4;
        const int kp = kStream ? round_up(kn, 16) : L.kp;
        __syncthreads();  // the last tile's (or chunk's) d_s, wh_s and part_s are read
        stage_rows(d_s, a.dgates + ((size_t)t * B + r0) * H4 + k0, rows, kn, H4, L.stride);
        if (kStream) {
          stage_wh_rows(wh_s, a.wh, H4, u0, nu, L.np, L.stride, k0, kn, kp);
          zero_cols(d_s, kBwdRows, kn, kp, L.stride);
        }
        __syncthreads();
        kparts = tile_products(d_s, wh_s, L.stride, kp, 1, nt_count, part_s, kStream && c > 0);
      }
      __syncthreads();
      for (int i = tid; i < rows * nu; i += kThreads) {
        const int rb = i / nu, u = i % nu, b = r0 + rb;
        dh_s[b * U + u] = product_at(part_s, rb, u, nt_count, kparts);
      }
    }
    __syncthreads();  // the carries are read by other threads next step
  }

  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, u = i % nu;
    a.dh0[(size_t)b * H + u0 + u] = dh_s[b * U + u];
    a.dc0[(size_t)b * H + u0 + u] = dc_s[b * U + u];
  }
}

struct Plan {
  int grid, units, chunk;
  size_t smem;
};

template <bool kSave>
const void* fwd_kernel(bool stream) {
  return stream ? (const void*)lstm_scan_grid_kernel<kSave, true>
                : (const void*)lstm_scan_grid_kernel<kSave, false>;
}

const void* bwd_kernel(bool stream) {
  return stream ? (const void*)lstm_scan_grid_bwd_kernel<true>
                : (const void*)lstm_scan_grid_bwd_kernel<false>;
}

// Plans a forward (``backward`` 0) or backward launch at these widths and
// readies its kernels' shared memory. ``units`` 0 takes ceil(H / SMs); the
// K chunk is all of K (H forward, 4H backward) where it fits, else the
// widest that does. Refuses a block that does not fit even a 16-deep chunk
// or a grid that cannot be resident.
cudaError_t plan_launch(int batch, int hidden, int units, int backward, Plan* p) {
  if (batch < 1 || hidden < 1 || units < 0) return cudaErrorInvalidValue;
  int sms, max_smem;
  cudaError_t err = device_limits(&sms, &max_smem);
  if (err != cudaSuccess) return err;
  p->units = units > 0 ? units : (hidden + sms - 1) / sms;
  p->grid = (hidden + p->units - 1) / p->units;
  const int U = p->units;
  auto fwd_size = [&](int kc) { return fwd_layout(batch, hidden, U, kc).total; };
  auto bwd_size = [&](int kc) { return bwd_layout(batch, hidden, U, kc).total; };
  p->chunk = backward ? fit_chunk(4 * hidden, max_smem, bwd_size)
                      : fit_chunk(hidden, max_smem, fwd_size);
  if (p->chunk == 0) return cudaErrorInvalidValue;
  p->smem = backward ? bwd_layout(batch, hidden, U, p->chunk).total
                     : fwd_layout(batch, hidden, U, p->chunk).total;
  if (backward)
    return ready_resident(bwd_kernel(p->chunk < 4 * hidden), p->smem, p->grid, sms);
  err = ready_resident(fwd_kernel<true>(p->chunk < hidden), p->smem, p->grid, sms);
  if (err != cudaSuccess) return err;
  return ready_resident(fwd_kernel<false>(p->chunk < hidden), p->smem, p->grid, sms);
}

}  // namespace

extern "C" {

// Blocks, hidden units per block, dynamic shared memory bytes and K chunk
// of a forward (``backward`` 0) or backward launch at these widths
// (``units`` 0: the default); returns a cudaError_t.
int vq_lstm_grid_plan(int batch, int hidden, int units, int backward, int* out4) {
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, units, backward, &p);
  if (err != cudaSuccess) return (int)err;
  out4[0] = p.grid;
  out4[1] = p.units;
  out4[2] = (int)p.smem;
  out4[3] = p.chunk;
  return 0;
}

// The forward on ``stream``; with ``save`` 0, ``acts`` and ``c_prev`` are
// not written (and may be null). Allocates nothing and does not
// synchronise; returns cudaGetLastError() after the launch.
int vq_lstm_scan_grid_launch(const void* xproj, const void* wh, const void* h0, const void* c0,
                             void* hs, void* acts, void* c_prev, void* h_out, void* c_out,
                             int steps, int batch, int hidden, int save, void* stream) {
  if (steps < 1 || (save && (acts == nullptr || c_prev == nullptr)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, 0, 0, &p);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
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
  a.units = p.units;
  a.chunk = p.chunk;
  void* params[] = {&a};
  const bool streamed = p.chunk < hidden;
  const void* kernel = save ? fwd_kernel<true>(streamed) : fwd_kernel<false>(streamed);
  cudaLaunchCooperativeKernel(kernel, dim3(p.grid), dim3(kThreads), params, p.smem,
                              static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The backward on ``stream``; the same contract as the forward's launch.
int vq_lstm_scan_grid_bwd_launch(const void* acts, const void* c_prev, const void* dhs,
                                 const void* wh, const void* dh_t, const void* dc_t, void* dgates,
                                 void* dh0, void* dc0, int steps, int batch, int hidden,
                                 void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, 0, 1, &p);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a;
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
  a.units = p.units;
  a.chunk = p.chunk;
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(bwd_kernel(p.chunk < 4 * hidden), dim3(p.grid), dim3(kThreads),
                              params, p.smem, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // extern "C"
