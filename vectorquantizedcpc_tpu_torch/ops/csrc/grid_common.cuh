// Building blocks of the row-group scans over a cooperative grid (the GRU's
// in gru_train.cu, the LSTM's in lstm_grid.cu), and the per-phase clock
// stamps, the barrier count and the two-step mma that the decode kernels
// (ar_decode.cu, dual_decode.cu, through decode_common.cuh) share with them.
//
// A row-group scan rests on the batch rows being independent sequences: row
// b's step needs only row b's h. The grid is split into row groups, each of
// R rows (8 where the batch allows: the mma's N) with its own blocks; block j
// of a group owns hidden units [j U, j U + U). A block keeps its slice of
// the recurrent weight wh (H, G H) in shared memory as the A operand of
// mma.sync (bf16 in, f32 sums): in the forward its G U columns (K = H), in
// the backward its U rows (K = G H). Each step its warps read the group's R
// rows of the B operand (bf16 h, or the gate gradients) straight from L2
// into B fragments, 16 bytes a lane, all in flight at once, each warp over
// its part of K (chunk_product); the parts are added in a fixed order
// (part_at). Each thread then owns (row, unit) pairs (Pair) and carries
// their f32 state in registers. The forward hands h on as tagged 32-bit
// words (no barrier, tag_of); the backward joins its group's blocks by one
// release / acquire count a step (count_arrive, count_wait). plan_grid
// picks the groups (the most whose blocks hold their slice of wh whole;
// else the fewest, with the widest K chunk that fits, staged with each
// chunk of every step), for G gates (GRU 3, LSTM 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vq_grid {

constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kTile = 8;           // batch rows of an mma N tile
constexpr int kKBlock = 32;        // K of one 16-byte load a lane: two mma steps
constexpr int kMaxPairs = 2;       // (row, unit) pairs a thread carries in registers
constexpr int kRegPairs = kMaxPairs * kBlockThreads;  // a block's pairs held in registers
constexpr int kSyncStride = 32;  // uint32 words between two groups' barrier counts (backward)
constexpr int kMaxGroups = 256;  // groups a barrier buffer holds (grid_plan.py:SYNC_WORDS)
// A 16 x 8 tile of partial sums: 8 rows (the N tile's batch rows) of 16 A
// rows, 20 floats apart, so that the fragments' scalar stores hit distinct
// banks. The tasks' tiles of one A tile follow each other (kPartTile
// floats apart: the K parts of an output sit at fixed offsets from it),
// and the A tiles follow at 16 floats modulo 32, so that a warp's loads of
// neighbouring outputs across two A tiles hit distinct banks too.
constexpr int kPartRow = 20, kPartTile = 8 * kPartRow + 16;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Returns the offset of a region of ``bytes`` at ``*off`` and moves past it.
__host__ __device__ __forceinline__ size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off += (bytes + 15) & ~size_t(15);
  return at;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Shared row stride of the A operand: row bytes plus a pad that puts
// neighbouring rows 64 bytes apart modulo 128.
__host__ __device__ __forceinline__ int a_stride(int row_bytes) {
  return row_bytes + (192 - row_bytes % 128) % 128;
}

// Floats between the partial sums of two A tiles of a product of ``rows``
// rows: a kPartTile tile per task (a warp, or an N tile where there are
// more of them than warps), plus 16 where that keeps A tiles 16 modulo 32.
__host__ __device__ __forceinline__ int part_tile_row(int rows) {
  const int tasks = max(kBlockWarps, cdiv(rows, kTile));
  return tasks * kPartTile + (tasks % 2 == 0 ? 16 : 0);
}

struct Layout {
  size_t w, part, bias, state, total;
  int kp, stride, mts;
  int tile_row;  // floats between the partial sums of two A tiles
};

// Shared memory of a block whose A operand has ``m_rows`` rows of K extent
// ``kc`` (of K), for groups of ``rows`` rows: the A rows and one zero row;
// a 16 x 8 f32 tile of partial sums per A tile and product task (one per
// warp, or one per N tile where there are more N tiles than warps);
// ``n_bias`` f32; ``n_state`` f32 per pair past the kRegPairs that the
// threads carry in registers. The same on the host (size) and the card;
// gru_train.py:grid_layout_bytes and lstm_scan.py:grid_layout_bytes
// mirror it (ops/grid_plan.py).
__host__ __device__ __forceinline__ Layout block_layout(int K, int m_rows, int kc, int rows,
                                                        int n_bias, int pairs, int n_state) {
  Layout L;
  L.kp = round_up(min(K, kc), kKBlock);
  L.stride = a_stride(2 * L.kp);
  L.mts = cdiv(m_rows, 16);
  L.tile_row = part_tile_row(rows);
  size_t off = 0;
  L.w = take(&off, (size_t)(m_rows + 1) * L.stride);
  L.part = take(&off, sizeof(float) * L.tile_row * L.mts);
  L.bias = take(&off, sizeof(float) * n_bias);
  L.state = take(&off, sizeof(float) * n_state * max(0, pairs - kRegPairs));
  L.total = off;
  return L;
}

// Forward of G gates: G U columns of wh over K = H, ``bias`` (the GRU's
// bh) G U f32 biases, one carry per pair past the registers.
__host__ __device__ __forceinline__ Layout fwd_layout(int G, bool bias, int H, int U, int kc,
                                                      int rows) {
  return block_layout(H, G * U, kc, rows, bias ? G * U : 0, rows * U, 1);
}

// Backward: U rows of wh over K = G H, two carries per pair past the
// registers.
__host__ __device__ __forceinline__ Layout bwd_layout(int G, int H, int U, int kc, int rows) {
  return block_layout(G * H, U, kc, rows, 0, rows * U, 2);
}

// This block's share of the work: rows [r0, r0 + nr) of its group and
// hidden units [u0, u0 + nu).
struct Share {
  int r0, nr, u0, nu;
};

__device__ __forceinline__ Share block_share(int B, int H, int rows, int blocks, int units) {
  const int group = blockIdx.x / blocks, j = blockIdx.x % blocks;
  Share s;
  s.r0 = group * rows;
  s.nr = min(rows, B - s.r0);
  s.u0 = j * units;
  s.nu = min(units, H - s.u0);
  return s;
}

// 8 bf16 of ``row`` at K offset k (a lane's share of a K block), zero at
// and beyond K: one 16-byte __ldcg where ``vec`` (the row's offset and K
// multiples of 8), else element by element.
__device__ __forceinline__ uint4 load_k8(const __nv_bfloat16* row, int k, int K, bool vec) {
  if (vec) return k < K ? __ldcg(reinterpret_cast<const uint4*>(row + k)) : make_uint4(0, 0, 0, 0);
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t lo = k + 2 * p < K ? __ldcg(bits + k + 2 * p) : 0u;
    const uint32_t hi = k + 2 * p + 1 < K ? __ldcg(bits + k + 2 * p + 1) : 0u;
    w[p] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 ld_relaxed_v4(const unsigned int* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned int ld_relaxed(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned int* p, unsigned int v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The forward's exchange: h of step t travels as 32-bit words, bf16(h) in
// the low half and the tag (t + 2) mod 2^16 in the high half, in one of
// two slots (t mod 2; h0 is step -1, in slot 1). A reader of step t's h
// polls its words until every tag is t + 2: the data carries its own
// readiness, so no barrier sits between the blocks. No tag is 0, the
// zeroed buffer's. A slot is written again two steps later, by a block
// that has read the step in between from every block of its group, which
// each wrote it only after reading this slot: no word is overwritten
// before its readers are done.
__device__ __forceinline__ unsigned int tag_of(int t) { return (unsigned int)(t + 2) & 0xffffu; }

// 8 exchange words of ``row`` from K offset k (a lane's share of a K
// block; zero at and beyond K), as issued loads: two 16-byte relaxed
// loads where ``vec`` (H a multiple of 4), else word by word.
struct Tagged8 {
  uint4 lo, hi;
};

__device__ __forceinline__ void issue_tagged(Tagged8& w, const unsigned int* row, int k, int K,
                                             bool vec) {
  if (vec) {
    w.lo = k < K ? ld_relaxed_v4(row + k) : make_uint4(0, 0, 0, 0);
    w.hi = k + 4 < K ? ld_relaxed_v4(row + k + 4) : make_uint4(0, 0, 0, 0);
    return;
  }
  unsigned int v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = k + j < K ? ld_relaxed(row + k + j) : 0u;
  w.lo = make_uint4(v[0], v[1], v[2], v[3]);
  w.hi = make_uint4(v[4], v[5], v[6], v[7]);
}

// Whether each of the 8 words at and below K carries ``want``.
__device__ __forceinline__ bool tagged_ready(const Tagged8& w, int k, int K, unsigned int want) {
  const unsigned int v[8] = {w.lo.x, w.lo.y, w.lo.z, w.lo.w, w.hi.x, w.hi.y, w.hi.z, w.hi.w};
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) ok &= k + j >= K || (v[j] >> 16) == want;
  return ok;
}

// The bf16 halves of 8 words, packed as a B fragment's 16 bytes (zero at
// and beyond K).
__device__ __forceinline__ uint4 tagged_pack(const Tagged8& w, int k, int K) {
  const unsigned int v[8] = {w.lo.x, w.lo.y, w.lo.z, w.lo.w, w.hi.x, w.hi.y, w.hi.z, w.hi.w};
  unsigned int b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = k + j < K ? v[j] & 0xffffu : 0u;
  return make_uint4(b[0] | (b[1] << 16), b[2] | (b[3] << 16), b[4] | (b[5] << 16),
                    b[6] | (b[7] << 16));
}

// The group's rows that a product reads (its B operand), ``ld`` apart, K
// of them: bf16 rows from ``bf`` (a backward's gate gradients), or tagged
// exchange words from ``tagged`` that must carry ``want`` (a forward's h).
struct Rows {
  const __nv_bfloat16* bf;
  const unsigned int* tagged;
  int ld, K;
  unsigned int want;
  bool vec;
};

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

// Two mma steps over one 32-deep K block: ``lo`` / ``hi`` hold A rows g /
// g + 8 and ``b`` the B column g, 16 bytes each at the lane's K offset (8
// bf16 from 8 q). Words x, y feed the first step (K halves a0 / a2 and b0 /
// b1), z, w the second; the same permutation of K on both sides leaves the
// sum as it is.
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

// One K chunk [k0, k0 + kn) of the block's product: the A rows in shared
// memory (``w_s``, ``stride`` bytes apart, local K from 0, row ``zrow``
// zero) times the group's ``nr`` rows of ``src``. Warps take (N tile, K
// part) tasks: N tile nt of the group's rows, K blocks of the chunk split
// kparts ways. Each task writes its 16 x 8 f32 sums per A tile mt to
// ``part`` at mt tile_row + task kPartTile, or adds them to what is there
// (``accumulate``: a later chunk). kTagged: ``src`` holds tagged words
// (each kernel has one kind of source, so it carries the code of one). The
// stamped variant marks ``load_phase`` once the first loads of the first
// chunk are there.
template <int MT, int LOADS, bool kTagged, bool kStamps, int kPhases>
__device__ __forceinline__ void chunk_product(const unsigned char* w_s, int stride, int zrow,
                                              int mts, const Rows& src, int nr, int k0, int kn,
                                              float* part, int tile_row, bool accumulate,
                                              PhaseStamps<kPhases>& st, int load_phase) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int nts = cdiv(nr, kTile);
  const int kparts = nts >= kBlockWarps ? 1 : kBlockWarps / nts;
  const int kbs = cdiv(kn, kKBlock);
  for (int task = warp; task < nts * kparts; task += kBlockWarps) {
    const int nt = task / kparts, kpart = task % kparts;
    const int kb_lo = kpart * kbs / kparts, kb_hi = (kpart + 1) * kbs / kparts;
    const int n = nt * kTile + g;
    const bool row_ok = n < nr;
    for (int mt0 = 0; mt0 < mts; mt0 += MT) {
      float c[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][0][e] = c[mt][1][e] = 0.f;
      for (int kb0 = kb_lo; kb0 < kb_hi; kb0 += LOADS) {
        uint4 bv[LOADS];
        if constexpr (kTagged) {  // all loads in flight, then poll the late ones
          Tagged8 w[LOADS];
          const unsigned int* row = src.tagged + (size_t)n * src.ld;
#pragma unroll
          for (int i = 0; i < LOADS; ++i) {
            const int k = k0 + (kb0 + i) * kKBlock + q * 8;
            w[i].lo = w[i].hi = make_uint4(0, 0, 0, 0);
            if (row_ok && kb0 + i < kb_hi) issue_tagged(w[i], row, k, src.K, src.vec);
          }
#pragma unroll
          for (int i = 0; i < LOADS; ++i) {
            const int k = k0 + (kb0 + i) * kKBlock + q * 8;
            if (row_ok && kb0 + i < kb_hi)
              while (!tagged_ready(w[i], k, src.K, src.want)) issue_tagged(w[i], row, k, src.K, src.vec);
            bv[i] = tagged_pack(w[i], k, src.K);
          }
        } else {
#pragma unroll
          for (int i = 0; i < LOADS; ++i) {
            const int k = k0 + (kb0 + i) * kKBlock + q * 8;
            bv[i] = make_uint4(0, 0, 0, 0);
            if (row_ok && kb0 + i < kb_hi) bv[i] = load_k8(src.bf + (size_t)n * src.ld, k, src.K, src.vec);
          }
        }
        if constexpr (kStamps) {
          if (k0 == 0 && mt0 == 0 && kb0 == kb_lo) {
            uint32_t all = 0;
#pragma unroll
            for (int i = 0; i < LOADS; ++i) all ^= bv[i].x ^ bv[i].w;
            settle(all);
            st.mark(load_phase);
          }
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          if (kb0 + i < kb_hi) {
            const int off = (kb0 + i) * kKBlock * 2 + q * 16;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (mt0 + mt < mts) {
                const int r_lo = min((mt0 + mt) * 16 + g, zrow);
                const int r_hi = min((mt0 + mt) * 16 + g + 8, zrow);
                const uint4 lo = *reinterpret_cast<const uint4*>(w_s + (size_t)r_lo * stride + off);
                const uint4 hi = *reinterpret_cast<const uint4*>(w_s + (size_t)r_hi * stride + off);
                mma_k32(c[mt][0], c[mt][1], lo, hi, bv[i]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt0 + mt < mts) {  // c[e]: A row g (+8 for e >= 2), batch row 2q (+1 for odd e)
          float* tile = part + (size_t)(mt0 + mt) * tile_row + task * kPartTile;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* at = tile + (2 * q + (e & 1)) * kPartRow + g + 8 * (e >> 1);
            const float v = c[mt][0][e] + c[mt][1][e];
            *at = accumulate ? *at + v : v;
          }
        }
      }
    }
  }
}

// Where the product's output (group row rb, A row m) has its first K part.
__device__ __forceinline__ int part_base(int tile_row, int kparts, int rb, int m) {
  return (m / 16) * tile_row + (rb / kTile) * kparts * kPartTile + (rb % kTile) * kPartRow + m % 16;
}

// An output's K parts, kPartTile apart from ``base``, added in order.
__device__ __forceinline__ float part_at(const float* part, int base, int kparts) {
  float v[kBlockWarps];
#pragma unroll
  for (int k = 0; k < kBlockWarps; ++k) v[k] = k < kparts ? part[base + k * kPartTile] : 0.f;
  float s = v[0];
#pragma unroll
  for (int k = 1; k < kBlockWarps; ++k) s += v[k];
  return s;
}

// A (row, unit) pair's offsets that no step changes: of its element in the
// (B, H) and (B, G H) arrays of one step, and of its product outputs'
// first K parts (forward: one per gate; backward: the first).
template <int G>
struct Pair {
  int row, rh, rhg, part[G];  // row: its batch row
};

template <int G>
__device__ __forceinline__ Pair<G> make_pair(int p, int r0, int u0, int nu, int H, int tile_row,
                                             int kparts, int gates) {
  const int rb = p / nu, u = p % nu;
  Pair<G> q;
  q.row = r0 + rb;
  q.rh = (r0 + rb) * H + u0 + u;
  q.rhg = (r0 + rb) * G * H + u0 + u;
#pragma unroll
  for (int gate = 0; gate < G; ++gate)
    q.part[gate] = gate < gates ? part_base(tile_row, kparts, rb, gate * nu + u) : 0;
  return q;
}

__device__ __forceinline__ int group_kparts(int nr) {
  const int nts = cdiv(nr, kTile);
  return nts >= kBlockWarps ? 1 : kBlockWarps / nts;
}

// V consecutive units of one gate at one K row of wh, one load of 2V bytes.
template <int V>
struct Units {
  __nv_bfloat16 v[V];
};

// The block's G nu columns of wh (H, G H) for K rows [k0, k0 + kn) as A
// rows (row lc = gate * nu + unit), zero from kn to kp; row G nu all zero.
// Each load takes V units of one gate at one K row (V = 8 or 4 where H, u0,
// nu and wh's address allow; else 1), several loads in flight a thread.
template <int G, int V>
__device__ __forceinline__ void stage_fwd_units(unsigned char* w_s, int stride,
                                                const __nv_bfloat16* wh, int H, int u0, int nu,
                                                int k0, int kn, int kp) {
  const int groups = nu / V, per_k = G * groups;
#pragma unroll 4
  for (int i = threadIdx.x; i < kp * per_k; i += kBlockThreads) {
    const int k = i / per_k, r = i % per_k, gate = r / groups, u = (r % groups) * V;
    Units<V> w;
    if (k < kn) {
      w = *reinterpret_cast<const Units<V>*>(wh + (size_t)(k0 + k) * G * H + gate * H + u0 + u);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) w.v[j] = __float2bfloat16(0.f);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      reinterpret_cast<__nv_bfloat16*>(w_s + (size_t)(gate * nu + u + j) * stride)[k] = w.v[j];
  }
  for (int k = threadIdx.x; k < kp; k += kBlockThreads)
    reinterpret_cast<__nv_bfloat16*>(w_s + (size_t)G * nu * stride)[k] = __float2bfloat16(0.f);
}

template <int G>
__device__ __forceinline__ void stage_fwd_rows(unsigned char* w_s, int stride,
                                               const __nv_bfloat16* wh, int H, int u0, int nu,
                                               int k0, int kn, int kp) {
  const bool aligned = reinterpret_cast<uintptr_t>(wh) % 16 == 0;
  if (aligned && H % 8 == 0 && u0 % 8 == 0 && nu % 8 == 0)
    stage_fwd_units<G, 8>(w_s, stride, wh, H, u0, nu, k0, kn, kp);
  else if (aligned && H % 4 == 0 && u0 % 4 == 0 && nu % 4 == 0)
    stage_fwd_units<G, 4>(w_s, stride, wh, H, u0, nu, k0, kn, kp);
  else
    stage_fwd_units<G, 1>(w_s, stride, wh, H, u0, nu, k0, kn, kp);
}

// The block's nu rows of wh (each ``width`` = G H long) for K columns [k0,
// k0 + kn) as A rows, zero from kn to kp; row nu all zero. 16-byte copies
// where ``width`` and k0 are multiples of 8 (kn then is too).
__device__ __forceinline__ void stage_bwd_rows(unsigned char* w_s, int stride,
                                               const __nv_bfloat16* wh, int width, int u0, int nu,
                                               int k0, int kn, int kp) {
  if (width % 8 == 0 && k0 % 8 == 0) {
    const int chunks = kp / 8;
    for (int i = threadIdx.x; i < (nu + 1) * chunks; i += kBlockThreads) {
      const int u = i / chunks, k = (i % chunks) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (u < nu && k < kn)
        v = __ldg(reinterpret_cast<const uint4*>(wh + (size_t)(u0 + u) * width + k0 + k));
      *reinterpret_cast<uint4*>(w_s + (size_t)u * stride + 2 * k) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < (nu + 1) * kp; i += kBlockThreads) {
    const int u = i / kp, k = i % kp;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (u < nu && k < kn) v = wh[(size_t)(u0 + u) * width + k0 + k];
    reinterpret_cast<__nv_bfloat16*>(w_s + (size_t)u * stride)[k] = v;
  }
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
// that ``grid`` blocks of ``threads`` can be resident at once on ``sms`` SMs.
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

// One direction's launch: ``groups`` row groups of ``rows`` rows (the last
// may hold fewer), each of ``blocks`` blocks of ``units`` hidden units;
// K staged in chunks of ``chunk`` (all of K: wh resident).
struct DirPlan {
  int groups, rows, blocks, units, chunk;
  size_t smem;
};

// Plans one direction (K = H forward, G H backward) at these widths:
// the most row groups (rows a multiple of 8) whose blocks hold their slice
// of wh whole; where none do, the fewest groups, with the widest K chunk
// that fits. Each group takes an equal share of the SMs and splits H over
// it (``units`` 0: as few units per block as that share allows). Refuses a
// grid that cannot be resident or a block that does not fit even a 16-deep
// chunk. ops/grid_plan.py:group_plan mirrors it.
template <class Size>
cudaError_t plan_direction(int batch, int hidden, int units, int K, int sms, int max_smem,
                           Size size, DirPlan* p) {
  bool have = false;
  DirPlan fewest{};
  for (int rows = kTile; rows < batch + kTile; rows += kTile) {
    const int groups = cdiv(batch, rows);
    if (groups > sms || groups > kMaxGroups) continue;
    const int share = sms / groups;
    const int U = units > 0 ? units : cdiv(hidden, share);
    const int blocks = cdiv(hidden, U);
    if (blocks > share) continue;
    if (size(U, K, rows) <= (size_t)max_smem) {
      *p = {groups, rows, blocks, U, K, size(U, K, rows)};
      return cudaSuccess;
    }
    if (!have || groups < fewest.groups) fewest = {groups, rows, blocks, U, 0, 0};
    have = true;
  }
  if (!have) return units > 0 ? cudaErrorCooperativeLaunchTooLarge : cudaErrorInvalidValue;
  const int U = fewest.units, rows = fewest.rows;
  fewest.chunk = fit_chunk(K, max_smem, [&](int kc) { return size(U, kc, rows); });
  if (fewest.chunk == 0) return cudaErrorInvalidValue;
  fewest.smem = size(U, fewest.chunk, rows);
  *p = fewest;
  return cudaSuccess;
}

struct GridPlan {
  DirPlan fwd, bwd;
  int sms;
};

// Both directions of a scan of G gates (``bias``: the forward holds G U
// biases) on this device.
inline cudaError_t plan_grid(int G, bool bias, int batch, int hidden, int units, GridPlan* p) {
  if (batch < 1 || hidden < 1 || units < 0) return cudaErrorInvalidValue;
  int max_smem;
  cudaError_t err = device_limits(&p->sms, &max_smem);
  if (err != cudaSuccess) return err;
  err = plan_direction(
      batch, hidden, units, hidden, p->sms, max_smem,
      [&](int U, int kc, int rows) { return fwd_layout(G, bias, hidden, U, kc, rows).total; },
      &p->fwd);
  if (err != cudaSuccess) return err;
  return plan_direction(
      batch, hidden, units, G * hidden, p->sms, max_smem,
      [&](int U, int kc, int rows) { return bwd_layout(G, hidden, U, kc, rows).total; }, &p->bwd);
}

// The plan's twelve numbers, the forward's and then the backward's: row
// groups, rows per group, blocks per group, hidden units per block,
// dynamic shared memory bytes, K chunk.
inline void plan_numbers(const GridPlan& p, int* out12) {
  const DirPlan* dirs[2] = {&p.fwd, &p.bwd};
  for (int d = 0; d < 2; ++d) {
    const int* v[] = {&dirs[d]->groups, &dirs[d]->rows, &dirs[d]->blocks, &dirs[d]->units};
    for (int i = 0; i < 4; ++i) out12[6 * d + i] = *v[i];
    out12[6 * d + 4] = (int)dirs[d]->smem;
    out12[6 * d + 5] = dirs[d]->chunk;
  }
}

// Readies ``kernel`` for a direction's plan and launches it on ``stream``.
inline cudaError_t launch_grid(const void* kernel, const DirPlan& d, int sms, void* args,
                               void* stream) {
  cudaError_t err = ready_resident(kernel, d.smem, d.groups * d.blocks, sms, kBlockThreads);
  if (err != cudaSuccess) return err;
  void* params[] = {args};
  cudaLaunchCooperativeKernel(kernel, dim3(d.groups * d.blocks), dim3(kBlockThreads), params,
                              d.smem, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

}  // namespace vq_grid
