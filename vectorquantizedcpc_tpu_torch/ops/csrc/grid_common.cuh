// Building blocks of the cooperative-grid scans (gru_train.cu, lstm_grid.cu).
//
// A block of kThreads threads holds a slice of a recurrent weight in shared
// memory, stages a tile of bf16 rows from device memory and forms their
// product with that slice by mma.sync (bf16 in, f32 accumulation), warps
// splitting the K range and adding their parts in shared memory.
// Shared-memory rows are padded by kPad bf16 so that fragment loads hit
// distinct banks; the K padding is zero. Where the slice and the tile do not
// fit at their whole depth, the plan picks a K chunk (fit_chunk) and the
// kernel stages the tile and the slice chunk by chunk, adding each chunk's
// products to the last (lstm_grid.cu). The row-group scans of gru_train.cu
// take their own tiles; they share the plan's helpers, the barrier count
// (count_arrive / count_wait), the two-step mma (mma_k32) and the
// per-phase clock stamps of their measurement variants (PhaseStamps).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vq_grid {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdRows = 32;  // batch rows of one forward h tile
constexpr int kBwdRows = 16;  // batch rows of one backward gate-gradient tile
constexpr int kPad = 8;       // bf16 elements after each shared-memory row

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
// sums to slot ((mt * nt_count + nt) * kparts + kpart) of ``part``, or adds
// them to what the slot holds (``accumulate``: a later K chunk); returns
// kparts. Rows and columns beyond the data give sums nobody reads.
__device__ __forceinline__ int tile_products(const __nv_bfloat16* a_s, const __nv_bfloat16* b_s,
                                             int stride, int kp, int mt_count, int nt_count,
                                             float* part, bool accumulate = false) {
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
    if (accumulate) {
      c[0] += out[g * 8 + q * 2];
      c[1] += out[g * 8 + q * 2 + 1];
      c[2] += out[(g + 8) * 8 + q * 2];
      c[3] += out[(g + 8) * 8 + q * 2 + 1];
    }
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

// rows x n bf16 from global ``src`` (rows ``ld`` apart, read through L2)
// into shared ``dst`` (rows ``stride`` apart); 16-byte copies where n and
// ld are multiples of 8 (``src`` is then 16-byte aligned: a buffer's start
// plus a multiple of 16 elements).
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                           int n, int ld, int stride) {
  if (n % 8 == 0 && ld % 8 == 0) {
    const int chunks = n / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = i % chunks;
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)r * ld) + c);
      *reinterpret_cast<uint4*>(dst + (size_t)r * stride + c * 8) = v;
    }
  } else {
    const unsigned short* bits = reinterpret_cast<const unsigned short*>(src);
    for (int i = threadIdx.x; i < rows * n; i += kThreads) {
      const int r = i / n, k = i % n;
      dst[(size_t)r * stride + k] = __ushort_as_bfloat16(__ldcg(bits + (size_t)r * ld + k));
    }
  }
}

// A block's columns of a recurrent weight ``wh`` (H, gates H) for K rows
// [k0, k0 + kn): column lc = gate * nu + unit of its nu units from u0,
// column-major ``stride`` apart, zero beyond kn (up to kp) and beyond
// gates nu columns (up to np). Read row by row, so that neighbouring
// threads read neighbouring columns.
__device__ __forceinline__ void stage_wh_cols(__nv_bfloat16* dst, const __nv_bfloat16* wh,
                                              int gates, int H, int u0, int nu, int np, int stride,
                                              int k0, int kn, int kp) {
  const int n_cols = gates * nu;
  for (int i = threadIdx.x; i < np * kp; i += kThreads) {
    const int k = i / np, lc = i % np;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (lc < n_cols && k < kn) v = wh[(size_t)(k0 + k) * gates * H + (lc / nu) * H + u0 + lc % nu];
    dst[(size_t)lc * stride + k] = v;
  }
}

// A block's nu rows of ``wh`` from u0 (each a column of wh^T), rows
// ``width`` long, for K columns [k0, k0 + kn), ``stride`` apart, zero
// beyond kn (up to kp) and beyond nu rows (up to np).
__device__ __forceinline__ void stage_wh_rows(__nv_bfloat16* dst, const __nv_bfloat16* wh,
                                              int width, int u0, int nu, int np, int stride,
                                              int k0, int kn, int kp) {
  for (int i = threadIdx.x; i < np * kp; i += kThreads) {
    const int u = i / kp, g = i % kp;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (u < nu && g < kn) v = wh[(size_t)(u0 + u) * width + k0 + g];
    dst[(size_t)u * stride + g] = v;
  }
}

// Zeroes columns [from, to) of ``rows`` shared rows ``stride`` apart: the K
// padding of a chunk that ends before its 16-deep step does.
__device__ __forceinline__ void zero_cols(__nv_bfloat16* dst, int rows, int from, int to,
                                          int stride) {
  const int n = to - from;
  for (int i = threadIdx.x; i < rows * n; i += kThreads)
    dst[(size_t)(i / n) * stride + from + i % n] = __float2bfloat16(0.f);
}

// The K extent a block stages at once: all of ``k`` where ``size(k)`` (the
// block's shared memory at that extent) fits ``max_smem``, else the widest
// multiple of 16 below ``k`` that fits; 0 where none does.
template <class Size>
inline int fit_chunk(int k, size_t max_smem, Size size) {
  if (size(k) <= max_smem) return k;
  for (int c = (k - 1) / 16 * 16; c >= 16; c -= 16)
    if (size(c) <= max_smem) return c;
  return 0;
}

// Readies ``kernel`` for ``smem`` bytes of dynamic shared memory and checks
// that ``grid`` blocks of kThreads can be resident at once on ``sms`` SMs.
inline cudaError_t ready_resident(const void* kernel, size_t smem, int grid, int sms) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  return per_sm * sms < grid ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// The same for blocks of ``threads`` threads.
inline cudaError_t ready_resident(const void* kernel, size_t smem, int grid, int sms, int threads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  return per_sm * sms < grid ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// The device's SM count, whether it launches cooperative grids, and its
// opt-in shared memory per block.
inline cudaError_t device_limits(int* sms, int* max_smem) {
  int dev, coop;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

// A barrier of some blocks on a count that only grows (the launch is
// cooperative, so every block is resident): once the block's writes are
// done, its thread 0 adds 1 with release semantics; count_wait polls, with
// acquire loads, until the count reaches ``target`` (the blocks that share
// the count times the barriers passed so far). In two halves, so that a
// block can do work that needs no other block's writes between them.
__device__ __forceinline__ void count_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
}

__device__ __forceinline__ void count_wait(const unsigned int* count, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// Per-phase clock64 counts of thread 0 of two blocks (block 0 and the
// grid's last block) of a stamped scan: the cycles since the last mark go
// to the phase that ends at the next one. Row layout: globaltimer and
// clock64 at the first step's start, the same at the last step's end, then
// n_steps x kPhases cycle counts (ops/ar_decode.py:summarize_stamps).
template <int kPhases>
struct PhaseStamps {
  long long* row = nullptr;
  long long last = 0, acc[kPhases];

  __device__ void open(long long* buf, int n_steps) {
    const int blk = blockIdx.x, last_blk = gridDim.x - 1;
    const int sel = blk == 0 ? 0 : (blk == last_blk ? 1 : -1);
    if (buf == nullptr || sel < 0 || threadIdx.x != 0) return;
    row = buf + (size_t)sel * (4 + (size_t)n_steps * kPhases);
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    row[0] = (long long)ns;
    last = row[1] = clock64();
  }
  __device__ void begin_step() {
    if (row != nullptr)
      for (int p = 0; p < kPhases; ++p) acc[p] = 0;
  }
  __device__ void mark(int phase) {
    if (row == nullptr) return;
    const long long now = clock64();
    acc[phase] += now - last;
    last = now;
  }
  __device__ void end_step(int s) {
    if (row == nullptr) return;
    for (int p = 0; p < kPhases; ++p) row[4 + (size_t)s * kPhases + p] = acc[p];
  }
  __device__ void close() {
    if (row == nullptr) return;
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    row[2] = (long long)ns;
    row[3] = clock64();
  }
};

// Makes a stamped kernel wait for ``v`` (a load's result) before its next
// mark: a predicate on the value cannot be set before the value is there.
__device__ __forceinline__ void settle(uint32_t v) {
  asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %0, 0x5eed5eed;\n @p nanosleep.u32 1;\n}\n"
               ::"r"(v));
}
__device__ __forceinline__ void settle(float v) { settle(__float_as_uint(v)); }

// Two mma steps over one 32-deep K block (the row-group scans of
// gru_train.cu): ``lo`` / ``hi`` hold A rows g / g + 8 and ``b`` the B
// column g, 16 bytes each at the lane's K offset (8 bf16 from 8 q). Words
// x, y feed the first step (K halves a0 / a2 and b0 / b1), z, w the
// second; the same permutation of K on both sides leaves the sum as it is.
__device__ __forceinline__ void mma_k32(float c0[4], float c1[4], const uint4& lo, const uint4& hi,
                                        const uint4& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0[0]), "+f"(c0[1]), "+f"(c0[2]), "+f"(c0[3])
      : "r"(lo.x), "r"(hi.x), "r"(lo.y), "r"(hi.y), "r"(b.x), "r"(b.y));
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c1[0]), "+f"(c1[1]), "+f"(c1[2]), "+f"(c1[3])
      : "r"(lo.z), "r"(hi.z), "r"(lo.w), "r"(hi.w), "r"(b.z), "r"(b.w));
}

}  // namespace vq_grid
