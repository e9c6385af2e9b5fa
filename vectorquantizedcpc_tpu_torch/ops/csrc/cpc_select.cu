// CPC negative scoring and selection: forward and backward.
//
// Replaces vectorquantizedcpc_tpu/ops/cpc_select.py:_fwd_kernel and
// _bwd_kernel. For each prediction step k, speaker s, anchor utterance u
// and anchor time l (all f32):
//   f_pos[k, s, u, l]    = wc[k, s, u, l] . z_shift[k, s, u, l]
//   f_neg[k, s, u, n, l] = wc[k, s, u, l] . z_shift[k, s, v, m]
//       with v = utt_index[k, u, n], m = seq_index[k, s, u, n, l];
// and the backward
//   d_wc[u, l] = d_fpos[u, l] z_shift[u, l] + sum_n d_fneg[u, n, l] z_shift[v, m]
//   d_zs[v, m] = d_fpos[v, m] wc[v, m] + sum over (u, n, l) selecting (v, m)
//                of d_fneg[u, n, l] wc[u, l].
//
// The TPU kernels build a dense (U L x L) similarity tile per anchor
// utterance, because the MXU favours dense products and its gathers were
// slow. The function needs only (N + 1) L dots of length Z per (k, s, u):
// 57 MFLOP at the training shape (K 6, S 8, U 8, N 17, L 64, Z 64). On an
// H100 its bound is its bytes (forward ~16 MB, ~4.8 us at 3.35 TB/s;
// backward ~28.6 MB, ~8.5 us); a gather reads each candidate row of 256
// bytes from shared memory, 113 MB forward and twice that backward, so the
// shared-memory pipe is the limit. So:
//   - a (k, s)'s rows go to a few blocks of 1,024 threads (as many as fill
//     the SMs once: 2 per (k, s) forward, 1 per (k, s) and kind backward,
//     at the training shape), each of which stages the (k, s) tile once, by
//     a bulk copy (cp.async.bulk) on an mbarrier, rows padded to a multiple
//     of 4 floats; while the copy is in flight it lists its rows'
//     candidates (row, and backward d) in shared memory. Where the tile
//     does not fit, or a block reads fewer rows than it holds, rows come
//     through the L1 cache;
//   - 8 lanes take one row: lane g reads 16-byte pieces g, g + 8, ... of
//     it, so each quarter warp reads 128 contiguous bytes, one shared-memory
//     wavefront whatever the row; Z past 32 x 8 pieces is taken in passes.
//     Staged rows are read by ld.shared (a pointer that may be shared or
//     device memory compiles to slower generic loads);
//   - forward: a group of 8 lanes per anchor, its wc pieces in registers;
//     each lane sums its pieces of 8 candidates by FMA, then 7 shuffles
//     reduce the 8 dots at once, lane j keeping dot j: f_pos and every f_neg
//     go through the same tree of additions, so a negative that lands on the
//     positive's own frame, or on an equal vector, ties with it bit for bit;
//   - backward, one launch and no atomics on floats: every row of d_wc and
//     d_zs has one writer, a group of 8 lanes that adds d x row (one FMA an
//     element) over its sources in a fixed order. A d_wc row's are its
//     anchor's candidates, the positive first. A d_zs block first inverts
//     the selection of its (k, s) in the tile's room: a bit mask of the
//     times l of each (row m, pair (u, n)) (integer atomicOr), a scan over
//     each utterance's pairs in order, and every source placed in
//     ascending (u, n, l) with the positive before u = v's negatives
//     (cpc_select_bwd_reference's index_add_ order); then it stages the wc
//     tile. d_zs is the same bits on every launch.
// Indices out of range give NaN scores (forward) and no contribution
// (backward) rather than reading outside the tile.
//
// The kStamps variants (vq_cpc_select_stamped_launch,
// vq_cpc_select_bwd_stamped_launch) also record, on thread 0 of block 0
// and of the last block, the clock64 cycles of each phase (Phase,
// BwdPhase) over the launch; no entry point of the package launches them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "grid_common.cuh"

namespace {

using vq_grid::PhaseStamps;
using vq_grid::settle;

constexpr int kGroup = 8;           // lanes that take one row
constexpr int kBar = 16;            // shared-memory bytes of the staging mbarrier
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Phases of the stamped variants (ops/cpc_select.py:FWD_STAMP_PHASES,
// BWD_STAMP_PHASES).
enum Phase { kTile, kLoads, kSums, kStores, kPhases };
enum BwdPhase {
  kListPairs, kListMasks, kListCounts, kListPlaces,  // a d_zs block's list build
  kBwdTile, kBwdLoads, kBwdSums, kBwdStores, kBwdPhases
};

// What a launch stages; ops/cpc_select.py:select_plan mirrors it.
struct Plan {
  int pieces;     // 16-byte pieces per lane per pass over Z (2, 4 or 8)
  int threads;    // of a block
  int parts;      // forward blocks per (k, s)
  int wc_blocks;  // backward d_wc blocks, each a range of the K S U L rows
  int zp;         // row stride of a staged tile: Z rounded up to 4 floats
  int fwd_tile;   // 1: the forward stages the tile of its (k, s)
  int fwd_smem;
  int bwd_tile;   // 1: the backward stages the z_shift (d_wc) or wc (d_zs) tile
  int bwd_lists;  // 1: a d_zs block builds its lists in shared memory
  int scratch;    // bytes of the lists' bit masks and places (in the room, or the workspace)
  int room;       // shared-memory bytes before the entries: the tile, or the lists' scratch
  int bwd_smem;
  int zs_parts;   // backward d_zs blocks per (k, s): 2 where the SMs and rows allow, else 1
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int);

struct FwdArgs {
  const float* wc;  // (KS, U, L, Z)
  const float* zs;  // (KS, U, L, Z) z_shift
  const int* utt;   // (K, U, N)
  const int* seq;   // (KS, U, N, L)
  float* f_neg;     // (KS, U, N, L)
  float* f_pos;     // (KS, U, L)
  int ks, s_count, u, n, l, z, zp, tile;
  int parts;          // blocks per (k, s)
  long long* stamps;  // kStamps: (2, 4 + kPhases)
};

struct BwdArgs {
  const float* d_fneg;  // (KS, U, N, L)
  const float* d_fpos;  // (KS, U, L)
  const float* wc;
  const float* zs;
  const int* utt;
  const int* seq;
  float* d_wc;          // (KS, U, L, Z)
  float* d_zs;          // (KS, U, L, Z)
  char* work;           // a region per d_zs block: scratch, then entries, where not in shared memory
  long long work_block; // bytes of a region
  int ks, s_count, u, n, l, z, zp;
  int wc_blocks;        // d_wc blocks, each a range of the K S U L rows
  int zs_parts;         // d_zs blocks per (k, s)
  int tile, lists, scratch, room;  // Plan's bwd_tile, bwd_lists, scratch, room
  long long* stamps;    // kStamps: (2, 4 + kBwdPhases)
};

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the phase, expecting ``tx`` bytes of bulk copies.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar, uint32_t tx) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               ::"r"(smem_addr(bar)), "r"(tx)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ``bytes`` (a multiple of 16, both ends 16-byte aligned) from device
// memory into shared memory, completing on ``bar``; issued by one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  constexpr uint32_t kPiece = 1u << 15;
  for (uint32_t off = 0; off < bytes; off += kPiece) {
    const uint32_t n = bytes - off < kPiece ? bytes - off : kPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Shared-memory loads by shared address: the kernels pick between a staged
// copy and device memory at run time, and a pointer that may be either
// compiles to generic loads, slower than these.
__device__ __forceinline__ float4 lds128(uint32_t at) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(at));
  return v;
}
__device__ __forceinline__ int2 lds64(uint32_t at) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(at));
  return v;
}

// Stages ``rows`` rows of ``z`` floats at ``src`` into ``tile`` with a row
// stride of ``zp`` (zeros after z): a bulk copy where the rows need no
// padding and ``src`` is 16-byte aligned, the block's threads otherwise.
// The block runs ``meanwhile()`` while the copy is in flight. Called by the
// whole block, ``bar`` initialised; returns once the data is there.
template <typename F>
__device__ void stage(float* tile, const float* src, int rows, int z, int zp,
                      unsigned long long* bar, uint32_t& parity, F meanwhile) {
  const size_t tile_bytes = (size_t)rows * zp * sizeof(float);
  const bool bulk = z == zp && aligned16(src);
  if (threadIdx.x == 0) {
    mbar_arrive(bar, bulk ? (uint32_t)tile_bytes : 0u);
    if (bulk) bulk_load(tile, src, (uint32_t)tile_bytes, bar);
  }
  if (!bulk) {
    for (size_t i = threadIdx.x; i < (size_t)rows * zp; i += blockDim.x) {
      const size_t r = i / zp, c = i - r * zp;
      tile[i] = c < (size_t)z ? src[r * z + c] : 0.f;
    }
  }
  meanwhile();
  mbar_wait(bar, parity);
  parity ^= 1u;
  __syncthreads();
}

// Four floats at ``p``: one 16-byte load where ``vec``, else those below
// ``rem`` one by one and zeros after.
__device__ __forceinline__ float4 load4(const float* p, int rem, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(rem > 0 ? p[0] : 0.f, rem > 1 ? p[1] : 0.f, rem > 2 ? p[2] : 0.f,
                     rem > 3 ? p[3] : 0.f);
}

__device__ __forceinline__ void store4(float* p, const float4& x, int rem, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = x;
    return;
  }
  if (rem > 0) p[0] = x.x;
  if (rem > 1) p[1] = x.y;
  if (rem > 2) p[2] = x.z;
  if (rem > 3) p[3] = x.w;
}

// The lane's pieces of a row's pass [z0, z0 + zc): piece i is the 4 floats
// at 4 (g + 8 i).
template <int kP>
__device__ __forceinline__ void load_pieces(float4 (&w)[kP], const float* row, int zc, int g,
                                            bool vec) {
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int z = 4 * (g + kGroup * i);
    w[i] = z < zc ? load4(row + z, zc - z, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The 8 lanes of a group hold partial sums p[0..7] of 8 dots; returns, on
// lane g, the full sum of dot g. Three xor steps that halve the dots a
// lane keeps (4, 2, 1 shuffles): every dot's sum is the same tree of
// additions over the 8 lanes' partials (each step adds the partials of
// lanes 4, 2, then 1 apart; a + b and b + a are the same bits), so equal
// inputs give equal sums wherever a dot sits. Called by the whole warp.
__device__ __forceinline__ float reduce_scatter8(const float (&p)[kGroup], int g) {
  const bool hi4 = g & 4, hi2 = g & 2, hi1 = g & 1;
  float k4[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float keep = hi4 ? p[4 + q] : p[q], send = hi4 ? p[q] : p[4 + q];
    k4[q] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  float k2[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float keep = hi2 ? k4[2 + q] : k4[q], send = hi2 ? k4[q] : k4[2 + q];
    k2[q] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  const float keep = hi1 ? k2[1] : k2[0], send = hi1 ? k2[0] : k2[1];
  return keep + __shfl_xor_sync(kFull, send, 1);
}

// The lane's partial of w . row over the pass: its pieces by FMA in order.
template <int kP>
__device__ __forceinline__ float lane_dot(const float4 (&w)[kP], const float* row, int zc, int g,
                                          bool vec) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int z = 4 * (g + kGroup * i);
    if (z < zc) {
      const float4 x = load4(row + z, zc - z, vec);
      acc = fmaf(w[i].x, x.x, acc);
      acc = fmaf(w[i].y, x.y, acc);
      acc = fmaf(w[i].z, x.z, acc);
      acc = fmaf(w[i].w, x.w, acc);
    }
  }
  return acc;
}

// lane_dot on a staged row at shared address ``at``.
template <int kP>
__device__ __forceinline__ float lane_dot_s(const float4 (&w)[kP], uint32_t at, int zc, int g) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int z = 4 * (g + kGroup * i);
    if (z < zc) {
      const float4 x = lds128(at + 4 * z);
      acc = fmaf(w[i].x, x.x, acc);
      acc = fmaf(w[i].y, x.y, acc);
      acc = fmaf(w[i].z, x.z, acc);
      acc = fmaf(w[i].w, x.w, acc);
    }
  }
  return acc;
}

// Block b of ``parts`` x units takes part b % parts of unit b / parts: rows
// [size part / parts, size (part + 1) / parts).
__device__ __forceinline__ void block_part(int b, int parts, int size, int& unit, int& t0,
                                           int& t1) {
  unit = b / parts;
  const int part = b - unit * parts;
  t0 = (int)((long long)size * part / parts);
  t1 = (int)((long long)size * (part + 1) / parts);
}

// Forward: block (ks, part) scores a part of the (k, s)'s anchors, a group
// of 8 lanes per anchor; kP pieces per lane per pass over Z. While the
// tile stages, the block lists its anchors' candidate rows in shared
// memory (``idx``: (anchor, j), j = 0 the positive; -1 for an index out of
// range).
template <int kP, int kThreads, bool kStamps>
__global__ void __launch_bounds__(kThreads, 1) select_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* tile = reinterpret_cast<float*>(smem + kBar);
  const int U = a.u, N = a.n, L = a.l, Z = a.z, UL = U * L, UNL = U * N * L;
  int* idx = reinterpret_cast<int*>(smem + kBar + (a.tile ? (size_t)UL * a.zp * 4 : 0));
  constexpr int kGroups = kThreads / kGroup;
  const int group = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  const int gbase = threadIdx.x % 32 - g;  // the group's first lane
  const bool one_pass = Z <= 32 * kP;
  PhaseStamps<kPhases> st;
  if constexpr (kStamps) {
    st.open(a.stamps, 1);
    st.begin_step();
  }
  int ks, an0, an1;
  block_part(blockIdx.x, a.parts, UL, ks, an0, an1);
  const int k = ks / a.s_count, count_a = an1 - an0;
  const float* rows = a.zs + (size_t)ks * UL * Z;
  const bool vec_wc = Z % 4 == 0 && aligned16(a.wc), vec = Z % 4 == 0 && aligned16(a.zs);
  // Round 0's wc pieces load while the tile does.
  float4 w[kP];
  if (one_pass && an0 + group < an1)
    load_pieces(w, a.wc + ((size_t)ks * UL + an0 + group) * Z, Z, g, vec_wc);
  auto list_rows = [&] {
    for (int i = threadIdx.x; i < count_a * (N + 1); i += blockDim.x) {
      const int j = i / count_a, an = an0 + i - j * count_a, u = an / L, l = an - u * L;
      int row = an;
      if (j > 0) {
        const int v = __ldg(a.utt + ((size_t)k * U + u) * N + j - 1);
        const int m = __ldg(a.seq + (size_t)ks * UNL + ((size_t)u * N + j - 1) * L + l);
        row = v >= 0 && v < U && m >= 0 && m < L ? v * L + m : -1;
      }
      idx[(an - an0) * (N + 1) + j] = row;
    }
  };
  // The tile pays where the block's dots read at least as many rows as it holds.
  const bool tiled = a.tile && (long long)count_a * (N + 1) >= UL;
  if (tiled) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
    uint32_t parity = 0;
    stage(tile, rows, UL, Z, a.zp, bar, parity, list_rows);
  } else {
    list_rows();
    __syncthreads();
  }
  const uint32_t tile_at = smem_addr(tile);
  if constexpr (kStamps) st.mark(kTile);
  // The same number of rounds for every group, so each warp reaches the
  // shuffles together (a group past the block's anchors reads nothing).
  const int rounds = (count_a + kGroups - 1) / kGroups;
  // Lane g holds candidate j0 + g's row; the next 8's (of this round, or
  // the next round's first 8) load while this 8's dots run.
  auto row_of = [&](int rr, int j) {
    const int i = group + rr * kGroups;
    return i < count_a && j <= N ? idx[i * (N + 1) + j] : -1;
  };
  int next_row = row_of(0, g);
  for (int r = 0; r < rounds; ++r) {
    const int an_r = an0 + group + r * kGroups;
    const bool live = an_r < an1;
    const int an = live ? an_r : an0, u = an / L, l = an - u * L;
    const float* wrow = a.wc + ((size_t)ks * UL + an) * Z;
    if (r > 0 && one_pass && live) load_pieces(w, wrow, Z, g, vec_wc);
    for (int j0 = 0; j0 <= N; j0 += kGroup) {
      const int j = j0 + g, count = min(kGroup, N + 1 - j0);
      const int my_row = next_row;
      next_row = j0 + kGroup <= N ? row_of(r, j + kGroup) : row_of(r + 1, g);
      if constexpr (kStamps) {
        if (one_pass) settle(w[0].x);
        settle((uint32_t)my_row);
        st.mark(kLoads);
      }
      float mine = 0.f;
      for (int z0 = 0; z0 < Z; z0 += 32 * kP) {
        const int zc = min(32 * kP, Z - z0);
        if (!one_pass && live) load_pieces(w, wrow + z0, zc, g, vec_wc);
        float part[kGroup];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int row = __shfl_sync(kFull, my_row, gbase + jj);
          part[jj] = !(live && jj < count && row >= 0) ? 0.f
                     : tiled ? lane_dot_s(w, tile_at + 4 * (row * a.zp + z0), zc, g)
                             : lane_dot(w, rows + (size_t)row * Z + z0, zc, g, vec);
        }
        const float f = reduce_scatter8(part, g);
        mine = z0 == 0 ? f : mine + f;
      }
      if constexpr (kStamps) {
        settle(mine);
        st.mark(kSums);
      }
      if (live && g < count)
        *(j == 0 ? a.f_pos + (size_t)ks * UL + an
                 : a.f_neg + (((size_t)ks * U + u) * N + j - 1) * L + l) = my_row < 0 ? NAN : mine;
      if constexpr (kStamps) st.mark(kStores);
    }
  }
  if constexpr (kStamps) {
    st.end_step(0);
    st.close();
  }
}

__device__ __forceinline__ void fma4(float4& acc, float d, const float4& x) {
  acc.x = fmaf(d, x.x, acc.x);
  acc.y = fmaf(d, x.y, acc.y);
  acc.z = fmaf(d, x.z, acc.z);
  acc.w = fmaf(d, x.w, acc.w);
}

// acc += d x (the lane's pieces of ``row``), one FMA an element: the row
// in device memory, or (``at``) staged.
template <int kP>
__device__ __forceinline__ void axpy_pieces(float4 (&acc)[kP], float d, const float* row, int zc,
                                            int g, bool vec) {
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int z = 4 * (g + kGroup * i);
    if (z < zc) fma4(acc[i], d, load4(row + z, zc - z, vec));
  }
}

template <int kP>
__device__ __forceinline__ void axpy_pieces_s(float4 (&acc)[kP], float d, uint32_t at, int zc,
                                              int g) {
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int z = 4 * (g + kGroup * i);
    if (z < zc) fma4(acc[i], d, lds128(at + 4 * z));
  }
}

template <int kP>
__device__ __forceinline__ void store_pieces(float* out, const float4 (&acc)[kP], int zc, int g,
                                             bool vec) {
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int z = 4 * (g + kGroup * i);
    if (z < zc) store4(out + z, acc[i], zc - z, vec);
  }
}

// An exclusive scan of data[0, n) in place; the whole block calls it.
__device__ void block_scan(int* data, int n) {
  __shared__ int warp_sum[32];
  const int per = (n + blockDim.x - 1) / blockDim.x, lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per), lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += data[i];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < (int)blockDim.x / 32 ? warp_sum[lane] : 0;
    int w = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w - x;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int x = data[i];
    data[i] = run;
    run += x;
  }
  __syncthreads();
}

// Where a d_zs block builds its (k, s)'s lists: the bit masks and places
// (the scratch) and the entries, all in shared memory or all in its
// workspace region (build_lists is instantiated for each, so that the
// shared one compiles to shared-memory instructions); the index lists in
// shared memory.
struct Lists {
  unsigned* mask;  // (L, MS): per (row m, pair p), the times l selecting m, 32 a word
  int* off;        // (L, OS): the pair's first place among row m's sources
  int* offpos;     // (U L): the positive's place among its row's sources
  int2* ents;      // (U L (N + 1)): (wc row, d) of every source, row by row
  int* start;      // (U L): each row's first entry
  int* count;      // (U L): its sources
  int* utt;        // (U N): utt_index[k]
  int* row0;       // (U N): the pair's first wc row, u L
  int* pairs;      // (U N): the pairs (u N + n), by utterance selected, ascending
  int* vstart;     // (U + 1): each utterance's first pair in ``pairs``
  int* nfirst;     // (U): its pairs with an anchor utterance below it
};

constexpr int kBatch = 10;  // loads a thread has in flight in the list build: U N L <= 10,240 in one

// The d_zs lists of (k, s) ``ks``: each row (v, m)'s sources in ascending
// (u, n, l), the positive before u = v's negatives (the plain version's
// index_add_ order), as (wc row, d). A (row m, pair) bit mask of times
// (atomicOr: the same bits in any order) counts each pair's sources of row
// m and ranks them by time; a scan over v's pairs in order (a warp per
// row, a lane per pair) places each pair's run, and every source then
// writes its own entry. Masks and places lie row major, an odd number of
// words apart, so the lanes of a row's scan meet few bank conflicts.
// Indices out of range add nothing. The whole block calls it.
template <bool kStamps>
__device__ __forceinline__ void build_lists(const BwdArgs& a, int ks, const Lists& t,
                                            PhaseStamps<kBwdPhases>& st) {
  const int U = a.u, N = a.n, L = a.l, UN = U * N, UL = U * L, W = (L + 31) / 32;
  const int MS = (UN * W) | 1, OS = UN | 1;
  const int k = ks / a.s_count, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32, unl = UN * L;
  const unsigned lt = (1u << lane) - 1u;
  const int* seq = a.seq + (size_t)ks * unl;
  const float* dn = a.d_fneg + (size_t)ks * unl;
  const float* dp = a.d_fpos + (size_t)ks * UL;
  unsigned* __restrict__ mask = t.mask;
  int* __restrict__ off = t.off;
  int2* __restrict__ ents = t.ents;
  int* __restrict__ utt = t.utt;
  int* __restrict__ pairs = t.pairs;
  int* __restrict__ vstart = t.vstart;
  int* __restrict__ nfirst = t.nfirst;
  for (int p = threadIdx.x; p < UN; p += blockDim.x) {
    utt[p] = __ldg(a.utt + (size_t)k * UN + p);
    t.row0[p] = p / N * L;
  }
  for (int i = threadIdx.x; i < L * MS; i += blockDim.x) mask[i] = 0u;
  __syncthreads();
  // Utterance v's pairs, a warp each, after those of the utterances below
  // it; its nfirst[v] pairs with an anchor utterance below v come first.
  for (int v = warp; v < U; v += warps) {
    int below = 0, nf = 0;
    for (int p0 = 0; p0 < UN; p0 += 32) {
      const int p = p0 + lane, uv = p < UN ? utt[p] : -1;
      below += __popc(__ballot_sync(kFull, uv >= 0 && uv < v));
      nf += __popc(__ballot_sync(kFull, uv == v && p < v * N));
    }
    int np = below;
    for (int p0 = 0; p0 < UN; p0 += 32) {
      const int p = p0 + lane;
      const bool mine = p < UN && utt[p] == v;
      const unsigned bm = __ballot_sync(kFull, mine);
      if (mine) pairs[np + __popc(bm & lt)] = p;
      np += __popc(bm);
    }
    if (lane == 0) {
      vstart[v] = below;
      nfirst[v] = nf;
      if (v == U - 1) vstart[U] = np;
    }
  }
  if constexpr (kStamps) st.mark(kListPairs);
  // The masks: kBatch sources' indices in flight per thread.
  for (int e0 = threadIdx.x; e0 < unl; e0 += kBatch * blockDim.x) {
    int m[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * blockDim.x;
      m[b] = e < unl ? __ldg(seq + e) : -1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * blockDim.x, p = e / L, l = e - p * L;
      if (m[b] >= 0 && m[b] < L && utt[p] >= 0 && utt[p] < U)
        atomicOr(mask + (size_t)m[b] * MS + p * W + l / 32, 1u << (l % 32));
    }
  }
  __syncthreads();
  if constexpr (kStamps) st.mark(kListMasks);
  // Row (v, m), a thread each, runs over v's pairs in order, kRun pairs'
  // loads at a time: each pair's first place among the row's sources, the
  // positive's place before pair nfirst[v] taking one.
  constexpr int kRun = 8;
  for (int r = threadIdx.x; r < UL; r += blockDim.x) {
    const int v = r / L, m = r - v * L, i0 = vstart[v], np = vstart[v + 1] - i0, nf = nfirst[v];
    const unsigned* mrow = mask + (size_t)m * MS;
    int* orow = off + (size_t)m * OS;
    int run = 0, pos = 0;
    for (int i = 0; i < np; i += kRun) {
      int p[kRun], c[kRun];
#pragma unroll
      for (int q = 0; q < kRun; ++q) p[q] = i + q < np ? pairs[i0 + i + q] : 0;
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        c[q] = 0;
        for (int w = 0; w < W; ++w) c[q] += i + q < np ? __popc(mrow[p[q] * W + w]) : 0;
      }
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        if (i + q >= np) break;
        if (i + q == nf) pos = run++;
        orow[p[q]] = run;
        run += c[q];
      }
    }
    if (nf == np) pos = run++;
    t.start[r] = run;
    t.count[r] = run;
    t.offpos[r] = pos;
  }
  __syncthreads();
  block_scan(t.start, UL);
  if constexpr (kStamps) st.mark(kListCounts);
  // Each source's entry: its row's start, its pair's first place, and the
  // times before it in the pair's mask; kBatch sources' loads in flight.
  for (int r = threadIdx.x; r < UL; r += blockDim.x)
    ents[t.start[r] + t.offpos[r]] = make_int2(r, __float_as_int(__ldg(dp + r)));
  for (int e0 = threadIdx.x; e0 < unl; e0 += kBatch * blockDim.x) {
    int m[kBatch];
    float d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * blockDim.x;
      m[b] = e < unl ? __ldg(seq + e) : -1;
      d[b] = e < unl ? __ldg(dn + e) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * blockDim.x, p = e / L, l = e - p * L;
      if (m[b] < 0 || m[b] >= L || utt[p] < 0 || utt[p] >= U) continue;
      const unsigned* mk = mask + (size_t)m[b] * MS + p * W;
      int rank = __popc(mk[l / 32] & ((1u << (l % 32)) - 1u));
      for (int w = 0; w < l / 32; ++w) rank += __popc(mk[w]);
      ents[t.start[utt[p] * L + m[b]] + off[(size_t)m[b] * OS + p] + rank] =
          make_int2(t.row0[p] + l, __float_as_int(d[b]));
    }
  }
  __syncthreads();
  if constexpr (kStamps) st.mark(kListPlaces);
}

// Backward: block (kind, ks, part) sums a part of the rows of d_zs (kind
// 1, the first blocks) or d_wc (kind 0) of a (k, s), a group of 8 lanes
// per row, one writer per row. A d_zs block first builds its (k, s)'s
// lists (in the tile's room where they fit), then stages the wc tile; a
// d_wc block lists its rows' candidates while the z_shift tile stages.
template <int kP, int kThreads, bool kStamps>
__global__ void __launch_bounds__(kThreads, 1) select_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* tile = reinterpret_cast<float*>(smem + kBar);
  const int U = a.u, N = a.n, L = a.l, Z = a.z, UL = U * L, UN = U * N;
  constexpr int kGroups = kThreads / kGroup;
  const int group = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  const int gbase = threadIdx.x % 32 - g;
  PhaseStamps<kBwdPhases> st;
  if constexpr (kStamps) {
    st.open(a.stamps, 1);
    st.begin_step();
  }
  // Blocks [0, KS zs_parts) sum d_zs rows, a part of one (k, s) each; the
  // wc_blocks after them split the K S U L rows of d_wc in equal ranges,
  // one or a few (k, s) segments each.
  const int wc0 = a.ks * a.zs_parts;
  const bool of_zs = (int)blockIdx.x < wc0;
  int ks, t0, t1;
  long long seg = 0, end = 0;
  if (of_zs) {
    block_part(blockIdx.x, a.zs_parts, UL, ks, t0, t1);
  } else {
    const long long total = (long long)a.ks * UL;
    seg = total * (blockIdx.x - wc0) / a.wc_blocks;
    end = total * (blockIdx.x - wc0 + 1) / a.wc_blocks;
  }
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  uint32_t parity = 0;
  // The small lists after the room and the entries.
  int* small = reinterpret_cast<int*>(smem + kBar + a.room +
                                      (a.lists ? (size_t)UL * (N + 1) * sizeof(int2) : 0));
  Lists t;
  t.start = small;
  t.count = t.start + UL;
  t.utt = t.count + UL;
  t.row0 = t.utt + UN;
  t.pairs = t.row0 + UN;
  t.vstart = t.pairs + UN;
  t.nfirst = t.vstart + U + 1;
  // The scratch: (L, MS) mask words, (L, OS) places, U L positive places.
  const size_t words = (size_t)L * ((UN * ((L + 31) / 32)) | 1), places = (size_t)L * (UN | 1);
  const uint32_t ents_at = smem_addr(smem + kBar + a.room);
  if (of_zs) {
    if (a.lists) {  // in shared memory, the entries after the room
      t.mask = reinterpret_cast<unsigned*>(smem + kBar);
      t.off = reinterpret_cast<int*>(t.mask + words);
      t.offpos = t.off + places;
      t.ents = reinterpret_cast<int2*>(smem + kBar + a.room);
      build_lists<kStamps>(a, ks, t, st);
    } else {  // in the block's workspace region
      char* scratch = a.work + (size_t)blockIdx.x * a.work_block;
      t.mask = reinterpret_cast<unsigned*>(scratch);
      t.off = reinterpret_cast<int*>(t.mask + words);
      t.offpos = t.off + places;
      t.ents = reinterpret_cast<int2*>(scratch + a.scratch);
      build_lists<kStamps>(a, ks, t, st);
    }
  }
  // A d_zs block's one segment, or a d_wc block's (k, s) segments in turn.
  for (bool first = true; of_zs ? first : seg < end; first = false) {
  if (!of_zs) {
    ks = (int)(seg / UL);
    t0 = (int)(seg - (long long)ks * UL);
    t1 = (int)min((long long)UL, end - (long long)ks * UL);
    seg += t1 - t0;
    if (!first) __syncthreads();  // every thread is done with the last segment's tile and list
  }
  const int k = ks / a.s_count;
  // d_wc rows gather z_shift rows; d_zs rows gather wc rows.
  const float* rows = (of_zs ? a.wc : a.zs) + (size_t)ks * UL * Z;
  float* out = (of_zs ? a.d_zs : a.d_wc) + (size_t)ks * UL * Z;
  const bool vec = Z % 4 == 0 && aligned16(rows);
  // d_wc rows, where the entries' room is in shared memory: their
  // candidates' (z_shift row, d), the positive first, listed there while
  // the tile stages (row -1 for an index out of range).
  const int cnt = t1 - t0;
  const bool wc_listed = !of_zs && a.lists;
  int2* wents = reinterpret_cast<int2*>(smem + kBar + a.room);
  auto list_wc = [&] {
    if (!wc_listed) return;
    for (int i = threadIdx.x; i < cnt * (N + 1); i += blockDim.x) {
      const int j = i / cnt, tt = t0 + i - j * cnt, u = tt / L, l = tt - u * L;
      int row = tt;
      float d;
      if (j == 0) {
        d = __ldg(a.d_fpos + (size_t)ks * UL + tt);
      } else {
        const size_t at = (((size_t)ks * U + u) * N + j - 1) * L + l;
        const int v = __ldg(a.utt + ((size_t)k * U + u) * N + j - 1), m = __ldg(a.seq + at);
        d = __ldg(a.d_fneg + at);
        row = v >= 0 && v < U && m >= 0 && m < L ? v * L + m : -1;
      }
      wents[(tt - t0) * (N + 1) + j] = make_int2(row, __float_as_int(d));
    }
  };
  const bool tiled = a.tile && (long long)cnt * (N + 1) >= UL;
  if (tiled) {
    stage(tile, rows, UL, Z, a.zp, bar, parity, list_wc);
  } else {
    list_wc();
    __syncthreads();
  }
  const uint32_t tile_at = smem_addr(tile);
  // acc += d x row z0.. of row ``row``, staged or in device memory.
  auto axpy = [&](float4 (&acc)[kP], float d, int row, int z0, int zc) {
    if (tiled)
      axpy_pieces_s<kP>(acc, d, tile_at + 4 * (row * a.zp + z0), zc, g);
    else
      axpy_pieces<kP>(acc, d, rows + (size_t)row * Z + z0, zc, g, vec);
  };
  if constexpr (kStamps) st.mark(kBwdTile);
  const bool vec_out = Z % 4 == 0 && aligned16(out);
  // d_wc: the same number of rounds for every group (the candidates'
  // broadcasts are whole-warp shuffles); d_zs: each group on its own.
  const int rounds = (t1 - t0 + kGroups - 1) / kGroups;
  const bool one_pass = Z <= 32 * kP;
  // d_wc: candidate j's (row, d) of round rr's row; the next 8's (of this
  // round, or the next round's first 8) load while this 8's add.
  auto cand = [&](int rr, int j, int& row, float& d) {
    const int tr = t0 + group + rr * kGroups;
    row = -1;
    d = 0.f;
    if (tr >= t1 || j > N) return;
    if (j == 0) {
      row = tr;
      d = __ldg(a.d_fpos + (size_t)ks * UL + tr);
      return;
    }
    const int u = tr / L, l = tr - u * L;
    const size_t at = (((size_t)ks * U + u) * N + j - 1) * L + l;
    const int v = __ldg(a.utt + ((size_t)k * U + u) * N + j - 1), m = __ldg(a.seq + at);
    d = __ldg(a.d_fneg + at);
    if (v >= 0 && v < U && m >= 0 && m < L) row = v * L + m;
  };
  int next_row = -1;
  float next_d = 0.f;
  bool have_next = false;
  for (int r = 0; r < rounds; ++r) {
    const int t_r = t0 + group + r * kGroups;
    const bool live = t_r < t1;
    const int row_t = live ? t_r : t0;
    for (int z0 = 0; z0 < Z; z0 += 32 * kP) {
      const int zc = min(32 * kP, Z - z0);
      float4 acc[kP];
#pragma unroll
      for (int i = 0; i < kP; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (wc_listed) {
        if (live) {  // two entries' loads in flight, added in order
          const int2* ee = wents + (row_t - t0) * (N + 1);
          int j = 0;
          for (; j < N; j += 2) {
            const int2 p = ee[j], q = ee[j + 1];
            if constexpr (kStamps) {
              settle((uint32_t)q.y);
              st.mark(kBwdLoads);
            }
            if (p.x >= 0) axpy(acc, __int_as_float(p.y), p.x, z0, zc);
            if (q.x >= 0) axpy(acc, __int_as_float(q.y), q.x, z0, zc);
            if constexpr (kStamps) {
              settle(acc[0].x);
              st.mark(kBwdSums);
            }
          }
          if (j == N && ee[j].x >= 0)
            axpy(acc, __int_as_float(ee[j].y), ee[j].x, z0, zc);
        }
      } else if (!of_zs) {
        if (!have_next) cand(r, g, next_row, next_d);
        for (int j0 = 0; j0 <= N; j0 += kGroup) {
          const int count = min(kGroup, N + 1 - j0);
          const int my_row = next_row;
          const float my_d = next_d;
          have_next = true;
          if (j0 + kGroup <= N)
            cand(r, j0 + kGroup + g, next_row, next_d);
          else if (one_pass && r + 1 < rounds)
            cand(r + 1, g, next_row, next_d);
          else
            have_next = false;
          if constexpr (kStamps) {
            settle(my_d);
            st.mark(kBwdLoads);
          }
#pragma unroll
          for (int jj = 0; jj < kGroup; ++jj) {
            const int row = __shfl_sync(kFull, my_row, gbase + jj);
            const float d = __shfl_sync(kFull, my_d, gbase + jj);
            if (live && jj < count && row >= 0) axpy(acc, d, row, z0, zc);
          }
          if constexpr (kStamps) {
            settle(acc[0].x);
            st.mark(kBwdSums);
          }
        }
      } else if (live) {
        // Two entries' loads in flight, added in order.
        const int e1 = t.start[row_t] + t.count[row_t];
        int e = t.start[row_t];
        for (; e + 1 < e1; e += 2) {
          const int2 p = a.lists ? lds64(ents_at + 8 * e) : t.ents[e];
          const int2 q = a.lists ? lds64(ents_at + 8 * e + 8) : t.ents[e + 1];
          if constexpr (kStamps) {
            settle((uint32_t)q.y);
            st.mark(kBwdLoads);
          }
          axpy(acc, __int_as_float(p.y), p.x, z0, zc);
          axpy(acc, __int_as_float(q.y), q.x, z0, zc);
          if constexpr (kStamps) {
            settle(acc[0].x);
            st.mark(kBwdSums);
          }
        }
        if (e < e1) {
          const int2 p = a.lists ? lds64(ents_at + 8 * e) : t.ents[e];
          axpy(acc, __int_as_float(p.y), p.x, z0, zc);
        }
      }
      if (live) store_pieces(out + (size_t)row_t * Z + z0, acc, zc, g, vec_out);
      if constexpr (kStamps) st.mark(kBwdStores);
    }
  }
  }
  if constexpr (kStamps) {
    st.end_step(0);
    st.close();
  }
}

// ------------------------------------------------------------------ host

struct DeviceInfo {
  int sms = 0, smem = 0;
};
DeviceInfo g_device[kMaxDevices];

// The card's SM count and shared memory per block, read once per device.
const DeviceInfo* device_info(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return nullptr;
  DeviceInfo& d = g_device[dev];
  if (d.sms == 0) {
    int sms = 0, smem = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return nullptr;
    d.smem = smem;
    d.sms = sms;
  }
  return &d;
}

bool shape_ok(int ks, int s_count, int u, int n, int l, int z) {
  return ks >= 1 && s_count >= 1 && ks % s_count == 0 && u >= 1 && n >= 0 && l >= 1 && z >= 1 &&
         (long long)ks * u * l * (n + 1) < (1ll << 31);
}

Plan make_plan(int ks, int u, int n, int l, int z, int sms, int smem) {
  Plan p;
  p.pieces = z <= 64 ? 2 : (z <= 128 ? 4 : 8);
  p.threads = p.pieces == 2 ? 1024 : 512;  // 64 registers a thread hold 2 pieces, not 4
  // Blocks per (k, s): as many as fill the SMs once, and no more than the
  // rows take rounds of the groups.
  const long long ul = (long long)u * l, w = (l + 31) / 32;
  const long long rounds = (ul + p.threads / kGroup - 1) / (p.threads / kGroup);
  // The forward lists a block's anchors' candidates in shared memory:
  // enough blocks that those lists fit.
  const long long per_anchor = 4ll * (n + 1), fit = (smem - kBar - 16) / per_anchor;
  p.parts = (int)std::max({1ll, std::min((long long)sms / ks, rounds), (ul + fit - 1) / fit});
  p.zp = (z + 3) / 4 * 4;
  const long long tile = ul * p.zp * 4, entries = ul * (n + 1) * 8;
  const long long idx = ((ul + p.parts - 1) / p.parts * per_anchor + 15) / 16 * 16;
  p.fwd_tile = kBar + tile + idx <= smem;
  p.fwd_smem = (int)(kBar + (p.fwd_tile ? tile : 0) + idx);
  // The backward's index lists (start, count, utt, pairs, vstart, nfirst).
  const long long small = (4 * (2 * ul + 3ll * u * n + 2ll * u + 1) + 15) / 16 * 16;
  const long long un = (long long)u * n;
  const long long scratch = (4 * l * (((un * w) | 1) + (un | 1)) + ul * 4 + 15) / 16 * 16;
  p.scratch = (int)std::min(scratch, (long long)INT32_MAX);
  const long long bwd_limit = smem - 4 * 32;  // block_scan's static words
  p.bwd_tile = kBar + tile + small <= bwd_limit;
  const long long tile_room = p.bwd_tile ? tile : 0;
  p.bwd_lists = kBar + std::max(tile_room, scratch) + entries + small <= bwd_limit;
  p.room = (int)(p.bwd_lists ? std::max(tile_room, scratch) : tile_room);
  p.bwd_smem = (int)(kBar + p.room + (p.bwd_lists ? entries : 0) + small);
  // Each d_zs block builds its (k, s)'s lists, then sums a part of its
  // rows: two parts where 2.5 blocks per (k, s) fit the SMs once, the d_wc
  // blocks (the SMs left) then taking a range of rows each; else one.
  p.zs_parts = p.bwd_lists && rounds >= 2 && 5ll * ks <= 2ll * sms ? 2 : 1;
  const long long wc = p.zs_parts == 2 ? sms - 2ll * ks : std::max((long long)ks, sms - (long long)ks);
  p.wc_blocks = (int)std::max(1ll, std::min(wc, ks * rounds));
  return p;
}

// The backward's workspace: a region per d_zs block where its lists do
// not fit shared memory, else none.
long long work_block(const Plan& p, int u, int n, int l) {
  return p.bwd_lists ? 0 : (long long)p.scratch + (long long)u * l * (n + 1) * 8;
}

// Launches ``kKernel``, raising its dynamic shared-memory limit to the
// card's once per device where ``smem`` needs it.
template <auto kKernel, typename Args>
cudaError_t launch(int blocks, int threads, int smem, cudaStream_t stream, int dev, const Args& a) {
  static unsigned long long raised = 0;  // one bit per device
  if (smem > 48 * 1024 && !((raised >> dev) & 1ull)) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kKernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 device_info(dev)->smem - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  kKernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kSt>
cudaError_t launch_fwd(const Plan& p, const FwdArgs& a, cudaStream_t s, int dev) {
  switch (p.pieces) {
    case 2: return launch<select_fwd_kernel<2, 1024, kSt>>(p.parts * a.ks, 1024, p.fwd_smem, s, dev, a);
    case 4: return launch<select_fwd_kernel<4, 512, kSt>>(p.parts * a.ks, 512, p.fwd_smem, s, dev, a);
    default: return launch<select_fwd_kernel<8, 512, kSt>>(p.parts * a.ks, 512, p.fwd_smem, s, dev, a);
  }
}

template <bool kSt>
cudaError_t launch_bwd(const Plan& p, const BwdArgs& a, cudaStream_t s, int dev) {
  const int blocks = p.zs_parts * a.ks + p.wc_blocks;
  switch (p.pieces) {
    case 2: return launch<select_bwd_kernel<2, 1024, kSt>>(blocks, 1024, p.bwd_smem, s, dev, a);
    case 4: return launch<select_bwd_kernel<4, 512, kSt>>(blocks, 512, p.bwd_smem, s, dev, a);
    default: return launch<select_bwd_kernel<8, 512, kSt>>(blocks, 512, p.bwd_smem, s, dev, a);
  }
}

int run_fwd(const void* wc, const void* zs, const void* utt, const void* seq, void* f_neg,
            void* f_pos, int ks, int s_count, int u, int n, int l, int z, int dev, void* stamps,
            void* stream) {
  const DeviceInfo* info = device_info(dev);
  if (!shape_ok(ks, s_count, u, n, l, z) || info == nullptr) return cudaErrorInvalidValue;
  const Plan p = make_plan(ks, u, n, l, z, info->sms, info->smem);
  FwdArgs a{static_cast<const float*>(wc), static_cast<const float*>(zs),
            static_cast<const int*>(utt), static_cast<const int*>(seq),
            static_cast<float*>(f_neg), static_cast<float*>(f_pos), ks, s_count, u, n, l, z, p.zp,
            p.fwd_tile, p.parts, static_cast<long long*>(stamps)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(stamps ? launch_fwd<true>(p, a, s, dev) : launch_fwd<false>(p, a, s, dev));
}

// ``workspace``: work_block bytes for each of the KS x zs_parts d_zs
// blocks (none where the lists fit shared memory).
int run_bwd(const void* d_fneg, const void* d_fpos, const void* wc, const void* zs,
            const void* utt, const void* seq, void* d_wc, void* d_zs, void* workspace, int ks,
            int s_count, int u, int n, int l, int z, int dev, void* stamps, void* stream) {
  const DeviceInfo* info = device_info(dev);
  if (!shape_ok(ks, s_count, u, n, l, z) || info == nullptr) return cudaErrorInvalidValue;
  const Plan p = make_plan(ks, u, n, l, z, info->sms, info->smem);
  if (!p.bwd_lists && workspace == nullptr) return cudaErrorInvalidValue;
  BwdArgs a{static_cast<const float*>(d_fneg), static_cast<const float*>(d_fpos),
            static_cast<const float*>(wc), static_cast<const float*>(zs),
            static_cast<const int*>(utt), static_cast<const int*>(seq), static_cast<float*>(d_wc),
            static_cast<float*>(d_zs), static_cast<char*>(workspace), work_block(p, u, n, l), ks,
            s_count, u, n, l, z, p.zp, p.wc_blocks, p.zs_parts, p.bwd_tile, p.bwd_lists, p.scratch,
            p.room,
            static_cast<long long*>(stamps)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(stamps ? launch_bwd<true>(p, a, s, dev) : launch_bwd<false>(p, a, s, dev));
}

}  // namespace

extern "C" {

// The launch plan at this shape on device ``dev``: kPlanFields ints into
// ``out`` (Plan's fields in order); returns 0, or a CUDA error.
int vq_cpc_select_plan(int ks, int s_count, int u_count, int n_count, int l_count, int z_dim,
                       int dev, int* out) {
  const DeviceInfo* info = device_info(dev);
  if (!shape_ok(ks, s_count, u_count, n_count, l_count, z_dim) || info == nullptr)
    return cudaErrorInvalidValue;
  const Plan p = make_plan(ks, u_count, n_count, l_count, z_dim, info->sms, info->smem);
  const int* f = reinterpret_cast<const int*>(&p);
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
  return 0;
}

// The launches below run on ``stream`` on device ``dev`` (the current
// one), allocate nothing and do not synchronise; each returns
// cudaGetLastError() after its launch. The stamped variants take
// ``stamps`` before ``dev``, int64 zeroed: (2, 4 + kPhases) forward,
// (2, 4 + kBwdPhases) backward.

int vq_cpc_select_launch(const void* wc, const void* zs, const void* utt, const void* seq,
                         void* f_neg, void* f_pos, int ks, int s_count, int u_count,
                         int n_count, int l_count, int z_dim, int dev, void* stream) {
  return run_fwd(wc, zs, utt, seq, f_neg, f_pos, ks, s_count, u_count, n_count, l_count, z_dim,
                 dev, nullptr, stream);
}

int vq_cpc_select_stamped_launch(const void* wc, const void* zs, const void* utt,
                                 const void* seq, void* f_neg, void* f_pos, int ks, int s_count,
                                 int u_count, int n_count, int l_count, int z_dim, void* stamps,
                                 int dev, void* stream) {
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return run_fwd(wc, zs, utt, seq, f_neg, f_pos, ks, s_count, u_count, n_count, l_count, z_dim,
                 dev, stamps, stream);
}

// Bytes of the backward's workspace at this shape on device ``dev`` (0:
// none needed), or -1.
long long vq_cpc_select_bwd_workspace(int ks, int s_count, int u_count, int n_count, int l_count,
                                      int z_dim, int dev) {
  const DeviceInfo* info = device_info(dev);
  if (!shape_ok(ks, s_count, u_count, n_count, l_count, z_dim) || info == nullptr) return -1;
  const Plan p = make_plan(ks, u_count, n_count, l_count, z_dim, info->sms, info->smem);
  return work_block(p, u_count, n_count, l_count) * ks * p.zs_parts;
}

// ``workspace``: vq_cpc_select_bwd_workspace() bytes, any contents.
int vq_cpc_select_bwd_launch(const void* d_fneg, const void* d_fpos, const void* wc,
                             const void* zs, const void* utt, const void* seq, void* d_wc,
                             void* d_zs, void* workspace, int ks, int s_count, int u_count,
                             int n_count, int l_count, int z_dim, int dev, void* stream) {
  return run_bwd(d_fneg, d_fpos, wc, zs, utt, seq, d_wc, d_zs, workspace, ks, s_count, u_count,
                 n_count, l_count, z_dim, dev, nullptr, stream);
}

int vq_cpc_select_bwd_stamped_launch(const void* d_fneg, const void* d_fpos, const void* wc,
                                     const void* zs, const void* utt, const void* seq,
                                     void* d_wc, void* d_zs, void* workspace, int ks,
                                     int s_count, int u_count, int n_count, int l_count,
                                     int z_dim, void* stamps, int dev, void* stream) {
  if (stamps == nullptr) return cudaErrorInvalidValue;
  return run_bwd(d_fneg, d_fpos, wc, zs, utt, seq, d_wc, d_zs, workspace, ks, s_count, u_count,
                 n_count, l_count, z_dim, dev, stamps, stream);
}

}  // extern "C"
