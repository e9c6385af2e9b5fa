// GRU scan at any width over a cooperative grid of row groups: the training
// forward (with residuals), the same forward without them, and the
// reverse-time backward.
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
// 0.80 ms at the bf16 tensor-core peak. Neither roofline is what bounds
// them: 5,120 dependent steps are, each a hand-off of h (or dgh) between
// the blocks through L2 and a product of the block's slice of wh, which is
// read from shared memory every step (the TPU kernel keeps wh, 4.6 MiB, in
// one core's VMEM; one H100 block holds at most 227 KB, so wh is spread
// over the SMs).
//
// The design rests on the batch rows being independent sequences: row b's
// step needs only row b's h. So the grid is split into row groups, each of
// R rows (8 where the batch allows: the mma's N) with its own blocks. At B
// 32, H 896 on 132 SMs that is 4 groups x 32 blocks x 28 hidden units.
// Block j of a group owns units [j U, j U + U):
//   - forward: it keeps its 3U columns of wh (147 KB at U 28) in shared
//     memory as the A operand for the whole scan. Each step its warps read
//     the group's R rows of bf16(h) of the step before (bf16(h0) at t = 0)
//     straight from L2 into mma.sync B fragments, 16 bytes a lane, all in
//     flight at once, and form hproj^T = wh^T bf16(h)^T (m16n8k16, bf16 in,
//     f32 sums), each warp over its part of K; the parts are added in a
//     fixed order. Each thread then owns (row, unit) pairs: it carries their
//     f32 h in registers, makes their gates and writes hs, acts, hn;
//   - backward: it keeps its U rows of wh (each 3H long, the A operand of
//     dgh @ wh^T). Each step each thread first makes its pairs' dgx, dgh
//     from the residuals and its f32 carry, then, after its group's
//     barrier, the warps read the group's rows of dgh[t] from L2 into B
//     fragments and form the carry's product the same way;
//   - the forward hands h on without a barrier: h travels as 32-bit words,
//     bf16(h) and a tag of its step, in two slots that alternate by step
//     (``xchg``), and a reader polls its words until every tag is the
//     step's. That takes one L2 round trip after the last writer's store,
//     where a count barrier (release add, acquire polls) and then the data
//     took two to three. A block overwrites a slot two steps later, after
//     reading the step in between from every block of its group, each of
//     which wrote it after reading the slot: no word is overwritten before
//     its readers are done. The backward keeps a barrier per step and
//     group (a release / acquire count that only grows): its exchange is
//     three times as wide, and tagged words that double it cost more time
//     in L2 than the barrier (PERF.md);
//   - what needs no other block's data sits after the block's own stores
//     (in the backward, between arriving at the barrier and waiting): the
//     next step's xproj (forward) and six residuals (backward), loaded a
//     step ahead into registers and left in bf16 until used.
// Per step each block reads R rows of h or dgh from L2 (28 KB of words /
// 42 KB at R 8), against all B rows in a one-group layout: 4x fewer rows
// through L2 at B 32, and each barrier joins a quarter of the blocks. The
// price is a 4x wider slice of wh per block; the plan takes fewer, wider
// groups where that slice would not fit, and where not even one group's
// does (on 132 SMs at B 32, H above about 2,100), the blocks stage their
// slice of wh with each K chunk of every step, adding up the chunks'
// products in shared memory. K is loaded 16 bytes a lane and the A operand uses the same
// permutation of K, so one load feeds two mma steps; A rows sit 64 bytes
// apart modulo 128, so the 16-byte shared loads of a warp hit distinct
// banks. Exchange reads bypass L1 (not coherent across SMs).
//
// The kStamps variants (vq_gru_scan_grid_stamped_launch,
// vq_gru_scan_bwd_stamped_launch) also record, on thread 0 of block 0 and
// of the grid's last block, the clock64 cycles of each phase of every step
// (FwdPhase, BwdPhase); no entry point of the package launches them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

using namespace vq_grid;

constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kTile = 8;           // batch rows of an mma N tile
constexpr int kKBlock = 32;        // K of one 16-byte load a lane: two mma steps
constexpr int kMaxPairs = 2;       // (row, unit) pairs a thread carries in registers
constexpr int kRegPairs = kMaxPairs * kBlockThreads;  // a block's pairs held in registers
constexpr int kSyncStride = 32;  // uint32 words between two groups' barrier counts (backward)
constexpr int kMaxGroups = 256;  // groups the barrier buffer holds (gru_train.py:SYNC_WORDS)
constexpr int kFwdMt = 6, kFwdLoads = 4;   // A tiles of one pass, K blocks in flight
constexpr int kBwdMt = 2, kBwdLoads = 12;
// A 16 x 8 tile of partial sums: 8 rows (the N tile's batch rows) of 16 A
// rows, 20 floats apart, so that the fragments' scalar stores hit distinct
// banks. The tasks' tiles of one A tile follow each other (kPartTile
// floats apart: the K parts of an output sit at fixed offsets from it),
// and the A tiles follow at 16 floats modulo 32, so that a warp's loads of
// neighbouring outputs across two A tiles hit distinct banks too.
constexpr int kPartRow = 20, kPartTile = 8 * kPartRow + 16;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared row stride of the A operand: row bytes plus a pad that puts
// neighbouring rows 64 bytes apart modulo 128.
__host__ __device__ __forceinline__ int a_stride(int row_bytes) {
  return row_bytes + (192 - row_bytes % 128) % 128;
}

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
  unsigned int* xchg;          // (2, B, H) tagged h words (bf16 | tag << 16), zeroed
  long long* stamps;           // kStamps: (2, 4 + steps * kFwdPhases)
  int steps, batch, hidden;
  int rows, blocks, units;     // rows and blocks of a group, hidden units of a block
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
  unsigned int* sync;          // (groups, kSyncStride) barrier counts, zeroed
  long long* stamps;           // kStamps: (2, 4 + steps * kBwdPhases)
  int steps, batch, hidden;
  int rows, blocks, units;
  int chunk;                   // K extent staged at once (3H: all of it)
};

// Phases of a step that the stamped kernels time (gru_train.py:
// FWD_STAMP_PHASES, BWD_STAMP_PHASES).
enum FwdPhase { kXproj, kHLoad, kProduct, kReduce, kGates, kPrefetch, kFwdPhases };
enum BwdPhase { kResiduals, kGateGrads, kBwdBarrier, kDghLoad, kBwdProduct, kCarry, kBwdPhases };

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
// gru_train.py:grid_layout_bytes mirrors it.
__host__ __device__ __forceinline__ Layout block_layout(int K, int m_rows, int kc, int rows,
                                                        int n_bias, int pairs, int n_state) {
  Layout L;
  L.kp = round_up(min(K, kc), kKBlock);
  L.stride = a_stride(2 * L.kp);
  L.mts = cdiv(m_rows, 16);
  const int tasks = max(kBlockWarps, cdiv(rows, kTile));
  L.tile_row = tasks * kPartTile + (tasks % 2 == 0 ? 16 : 0);
  size_t off = 0;
  L.w = take(&off, (size_t)(m_rows + 1) * L.stride);
  L.part = take(&off, sizeof(float) * L.tile_row * L.mts);
  L.bias = take(&off, sizeof(float) * n_bias);
  L.state = take(&off, sizeof(float) * n_state * max(0, pairs - kRegPairs));
  L.total = off;
  return L;
}

// Forward: 3U columns of wh over K = H, their biases, the carries.
__host__ __device__ __forceinline__ Layout fwd_layout(int H, int U, int kc, int rows) {
  return block_layout(H, 3 * U, kc, rows, 3 * U, rows * U, 1);
}

// Backward: U rows of wh over K = 3H, the carries and dh z.
__host__ __device__ __forceinline__ Layout bwd_layout(int H, int U, int kc, int rows) {
  return block_layout(3 * H, U, kc, rows, 0, rows * U, 2);
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
// of them: bf16 rows from ``bf`` (the backward's dgh), or tagged exchange
// words from ``tagged`` that must carry ``want`` (the forward's h).
struct Rows {
  const __nv_bfloat16* bf;
  const unsigned int* tagged;
  int ld, K;
  unsigned int want;
  bool vec;
};

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
// (B, H) and (B, 3H) arrays of one step, and of its product outputs' first
// K parts (forward: one per gate; backward: the first).
struct Pair {
  int row, rh, rh3, part[3];  // row: its batch row
};

__device__ __forceinline__ Pair make_pair(int p, int r0, int u0, int nu, int H, int tile_row,
                                          int kparts, int gates) {
  const int rb = p / nu, u = p % nu;
  Pair q;
  q.row = r0 + rb;
  q.rh = (r0 + rb) * H + u0 + u;
  q.rh3 = (r0 + rb) * 3 * H + u0 + u;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
    q.part[gate] = gate < gates ? part_base(tile_row, kparts, rb, gate * nu + u) : 0;
  return q;
}

__device__ __forceinline__ int group_kparts(int nr) {
  const int nts = cdiv(nr, kTile);
  return nts >= kBlockWarps ? 1 : kBlockWarps / nts;
}

// The block's 3 nu columns of wh (H, 3H) for K rows [k0, k0 + kn) as A rows
// (row lc = gate * nu + unit), zero from kn to kp; row 3 nu all zero.
__device__ __forceinline__ void stage_fwd_rows(unsigned char* w_s, int stride,
                                               const __nv_bfloat16* wh, int H, int u0, int nu,
                                               int k0, int kn, int kp) {
  const int rows = 3 * nu + 1;
  for (int i = threadIdx.x; i < rows * kp; i += kBlockThreads) {
    const int k = i / rows, lc = i % rows;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (lc < 3 * nu && k < kn) v = wh[(size_t)(k0 + k) * 3 * H + (lc / nu) * H + u0 + lc % nu];
    reinterpret_cast<__nv_bfloat16*>(w_s + (size_t)lc * stride)[k] = v;
  }
}

// The block's nu rows of wh (each 3H long) for K columns [k0, k0 + kn) as
// A rows, zero from kn to kp; row nu all zero. 16-byte copies where 3H and
// k0 are multiples of 8 (kn then is too).
__device__ __forceinline__ void stage_bwd_rows(unsigned char* w_s, int stride,
                                               const __nv_bfloat16* wh, int H3, int u0, int nu,
                                               int k0, int kn, int kp) {
  if (H3 % 8 == 0 && k0 % 8 == 0) {
    const int chunks = kp / 8;
    for (int i = threadIdx.x; i < (nu + 1) * chunks; i += kBlockThreads) {
      const int u = i / chunks, k = (i % chunks) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (u < nu && k < kn)
        v = __ldg(reinterpret_cast<const uint4*>(wh + (size_t)(u0 + u) * H3 + k0 + k));
      *reinterpret_cast<uint4*>(w_s + (size_t)u * stride + 2 * k) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < (nu + 1) * kp; i += kBlockThreads) {
    const int u = i / kp, k = i % kp;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (u < nu && k < kn) v = wh[(size_t)(u0 + u) * H3 + k0 + k];
    reinterpret_cast<__nv_bfloat16*>(w_s + (size_t)u * stride)[k] = v;
  }
}

// kSave: also write the residuals acts and hn. kMask: rows whose valid[t, b]
// is 0 keep their carry at step t, and hs[t] holds bf16 of it (the serving
// PreNet's reverse direction, _fwd_kernel_masked). kStream: the plan's K
// chunk is below H, so wh is staged with each chunk of every step;
// otherwise once, with all of K.
template <bool kSave, bool kMask, bool kStream, bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) gru_scan_grid_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, tid = threadIdx.x;
  const Share sh = block_share(B, H, a.rows, a.blocks, a.units);
  const int r0 = sh.r0, nr = sh.nr, u0 = sh.u0, nu = sh.nu, n_cols = 3 * nu;
  const int n_pairs = nr * nu, kparts = group_kparts(nr);
  const int n_chunks = kStream ? cdiv(H, a.chunk) : 1;

  const Layout L = fwd_layout(H, a.units, a.chunk, a.rows);
  unsigned char* w_s = smem + L.w;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [lc]
  float* carry_s = reinterpret_cast<float*>(smem + L.state);  // pairs past kRegPairs

  for (int lc = tid; lc < n_cols; lc += kBlockThreads)
    bias_s[lc] = a.bh[(lc / nu) * H + u0 + lc % nu];
  if (!kStream) stage_fwd_rows(w_s, L.stride, a.wh, H, u0, nu, 0, H, L.kp);

  // Pair p is (group row p / nu, unit p % nu). Thread tid holds pairs
  // tid + k kBlockThreads (k < kMaxPairs) in registers: their offsets,
  // biases, f32 carries and the step's gate inputs, loaded a step ahead
  // and left in bf16 until the gate pass uses them (converting them where
  // they are loaded would wait for the loads there). Pairs past kRegPairs
  // (more than 512 in a block) keep their carry in shared memory and load
  // their inputs when they are used.
  Pair pr[kMaxPairs];
  float carry[kMaxPairs], bias[kMaxPairs][3];
  __nv_bfloat16 xv[kMaxPairs][3];
  int valid[kMaxPairs];
  auto load_x = [&](int t, const Pair& q, __nv_bfloat16 (&x)[3], int& ok) {
    const __nv_bfloat16* xr = a.xproj + (size_t)t * B * H3 + q.rh3;
    x[0] = xr[0];
    x[1] = xr[H];
    x[2] = xr[2 * H];
    if (kMask) ok = a.valid[(size_t)t * B + q.row];
  };
  auto load_inputs = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) load_x(t, pr[k], xv[k], valid[k]);
  };
  __syncthreads();  // bias_s is staged
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = tid + k * kBlockThreads;
    pr[k] = make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 3);
    carry[k] = p < n_pairs ? a.h0[pr[k].rh] : 0.f;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) bias[k][gate] = p < n_pairs ? bias_s[gate * nu + p % nu] : 0.f;
    valid[k] = 1;
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    carry_s[p - kRegPairs] = a.h0[make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh];
  // bf16(h0) into the exchange as step -1 (slot 1), for the first product.
  for (int p = tid; p < n_pairs; p += kBlockThreads) {
    const int rh = make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh;
    st_relaxed(a.xchg + (size_t)B * H + rh,
               __bfloat16_as_ushort(__float2bfloat16(a.h0[rh])) | (tag_of(-1) << 16));
  }
  load_inputs(0);

  // Pair q's gates at step t from its hproj (bias added): its new carry
  // and its stores, the exchange word first.
  auto gates = [&](int t, const Pair& q, float& h, const __nv_bfloat16 (&x)[3], int ok,
                   const float (&hp)[3]) {
    const float r = sigmoid(__bfloat162float(x[0]) + hp[0]);
    const float z = sigmoid(__bfloat162float(x[1]) + hp[1]);
    const float n = tanhf(__bfloat162float(x[2]) + r * hp[2]);
    float h_new = (1.f - z) * n + z * h;
    if (kMask && ok == 0) h_new = h;
    h = h_new;
    const __nv_bfloat16 hb = __float2bfloat16(h_new);
    st_relaxed(a.xchg + (size_t)(t & 1) * B * H + q.rh, __bfloat16_as_ushort(hb) | (tag_of(t) << 16));
    const size_t rh = (size_t)t * B * H + q.rh, rh3 = (size_t)t * B * H3 + q.rh3;
    a.hs[rh] = hb;
    if (kSave) {
      a.acts[rh3] = __float2bfloat16(r);
      a.acts[rh3 + H] = __float2bfloat16(z);
      a.acts[rh3 + 2 * H] = __float2bfloat16(n);
      a.hn[rh] = __float2bfloat16(hp[2]);
    }
    if (t == a.steps - 1) a.h_out[q.rh] = h_new;
  };

  PhaseStamps<kFwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, a.steps);
  for (int t = 0; t < a.steps; ++t) {
    if constexpr (kStamps) st.begin_step();
    // hproj^T of this block's columns for its group's rows, from bf16(h) of
    // the step before (bf16(h0) at t = 0) in the exchange words.
    Rows src{};
    src.ld = H;
    src.K = H;
    src.vec = H % 4 == 0;
    src.tagged = a.xchg + ((size_t)((t - 1) & 1) * B + r0) * H;
    src.want = tag_of(t - 1);
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = kStream ? c * a.chunk : 0;
      const int kn = kStream ? min(a.chunk, H - k0) : H;
      if (kStream) {
        __syncthreads();  // the last chunk's w_s and part_s are read
        stage_fwd_rows(w_s, L.stride, a.wh, H, u0, nu, k0, kn, round_up(kn, kKBlock));
        __syncthreads();
      }
      chunk_product<kFwdMt, kFwdLoads, true, kStamps>(w_s, L.stride, n_cols, L.mts, src, nr, k0,
                                                      kn, part_s, L.tile_row, kStream && c > 0, st,
                                                      kHLoad);
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kProduct);

    float hp[kMaxPairs][3];
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          hp[k][gate] = part_at(part_s, pr[k].part[gate], kparts) + bias[k][gate];
    if constexpr (kStamps) {
      if (n_pairs > tid) {
        settle(hp[0][0] + hp[0][1] + hp[0][2]);
        st.mark(kReduce);
        settle(__bfloat162float(xv[0][0]) + __bfloat162float(xv[0][1]) +
               __bfloat162float(xv[0][2]));
        st.mark(kXproj);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) gates(t, pr[k], carry[k], xv[k], valid[k], hp[k]);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
      const Pair q = make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 3);
      __nv_bfloat16 x[3];
      float hq[3];
      int ok = 1;
      load_x(t, q, x, ok);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        hq[gate] = part_at(part_s, q.part[gate], kparts) + bias_s[gate * nu + p % nu];
      gates(t, q, carry_s[p - kRegPairs], x, ok, hq);
    }
    if constexpr (kStamps) st.mark(kGates);
    if (t + 1 < a.steps) load_inputs(t + 1);
    __syncthreads();  // part_s is read
    if constexpr (kStamps) {
      st.mark(kPrefetch);
      st.end_step(t);
    }
  }
  if constexpr (kStamps) st.close();
}

template <bool kStream, bool kStamps>
__global__ void __launch_bounds__(kBlockThreads, 1) gru_scan_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H3 = 3 * a.hidden, B = a.batch, tid = threadIdx.x;
  const Share sh = block_share(B, H, a.rows, a.blocks, a.units);
  const int r0 = sh.r0, nr = sh.nr, u0 = sh.u0, nu = sh.nu;
  const int n_pairs = nr * nu, kparts = group_kparts(nr);
  const int n_chunks = kStream ? cdiv(H3, a.chunk) : 1;
  unsigned int* sync = a.sync + (size_t)(blockIdx.x / a.blocks) * kSyncStride;  // the group's

  const Layout L = bwd_layout(H, a.units, a.chunk, a.rows);
  unsigned char* w_s = smem + L.w;
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  const int n_tail = max(0, a.rows * a.units - kRegPairs);
  float* carry_s = reinterpret_cast<float*>(smem + L.state);  // pairs past kRegPairs
  float* dhz_s = carry_s + n_tail;
  if (!kStream) stage_bwd_rows(w_s, L.stride, a.wh, H3, u0, nu, 0, H3, L.kp);

  // Pairs as in the forward: in registers their offsets, the f32 carry,
  // dh z and the step's residuals r, z, n, hn, h_prev, dhs (loaded a step
  // ahead, bf16 until used); past kRegPairs the carry and dh z in shared
  // memory.
  Pair pr[kMaxPairs];
  float carry[kMaxPairs], dhz[kMaxPairs];
  __nv_bfloat16 res[kMaxPairs][6];
  auto load_res = [&](int t, const Pair& q, __nv_bfloat16 (&v)[6]) {
    const size_t rh = (size_t)t * B * H + q.rh, rh3 = (size_t)t * B * H3 + q.rh3;
    v[0] = a.acts[rh3];
    v[1] = a.acts[rh3 + H];
    v[2] = a.acts[rh3 + 2 * H];
    v[3] = a.hn[rh];
    v[4] = a.hprev[rh];
    v[5] = a.dhs[rh];
  };
  auto load_residuals = [&](int t) {
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) load_res(t, pr[k], res[k]);
  };
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = tid + k * kBlockThreads;
    pr[k] = make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 1);
    carry[k] = p < n_pairs ? a.dh_t[pr[k].rh] : 0.f;
  }
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    carry_s[p - kRegPairs] = a.dh_t[make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh];
  load_residuals(a.steps - 1);
  __syncthreads();  // w_s is staged

  // Pair q's gate gradients at step t from its residuals and carry: its
  // dgh (the exchange) first, then dgx, and dh z.
  auto grads = [&](int t, const Pair& q, const __nv_bfloat16 (&v)[6], float carry_p,
                   float& dhz_p) {
    const float r = __bfloat162float(v[0]), z = __bfloat162float(v[1]);
    const float n = __bfloat162float(v[2]), hn = __bfloat162float(v[3]);
    const float dh = carry_p + __bfloat162float(v[5]);
    const float dn = dh * (1.f - z);
    const float dz = dh * (__bfloat162float(v[4]) - n);
    const float da_n = dn * (1.f - n * n);
    const float dr = da_n * hn;
    const float dhn = da_n * r;
    const float da_r = dr * r * (1.f - r);
    const float da_z = dz * z * (1.f - z);
    const size_t rh3 = (size_t)t * B * H3 + q.rh3;
    const __nv_bfloat16 bdr = __float2bfloat16(da_r), bdz = __float2bfloat16(da_z);
    a.dgh[rh3] = bdr;
    a.dgh[rh3 + H] = bdz;
    a.dgh[rh3 + 2 * H] = __float2bfloat16(dhn);
    a.dgx[rh3] = bdr;
    a.dgx[rh3 + H] = bdz;
    a.dgx[rh3 + 2 * H] = __float2bfloat16(da_n);
    dhz_p = dh * z;
  };

  PhaseStamps<kBwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, a.steps);
  for (int t = a.steps - 1; t >= 0; --t) {
    if constexpr (kStamps) {
      st.begin_step();
      if (n_pairs > tid) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) sum += __bfloat162float(res[0][i]);
        settle(sum);
        st.mark(kResiduals);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs) grads(t, pr[k], res[k], carry[k], dhz[k]);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads) {
      const Pair q = make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 0);
      __nv_bfloat16 v[6];
      load_res(t, q, v);
      grads(t, q, v, carry_s[p - kRegPairs], dhz_s[p - kRegPairs]);
    }
    if constexpr (kStamps) st.mark(kGateGrads);
    count_arrive(sync);  // dgh[t] of the group is complete once all arrive
    if (t > 0) load_residuals(t - 1);
    count_wait(sync, (unsigned int)(a.steps - t) * a.blocks);
    if constexpr (kStamps) st.mark(kBwdBarrier);

    // carry = dh z + dgh[t] @ wh^T for this block's units and group's rows.
    Rows src{};
    src.bf = a.dgh + ((size_t)t * B + r0) * H3;
    src.ld = H3;
    src.K = H3;
    src.vec = H3 % 8 == 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = kStream ? c * a.chunk : 0;
      const int kn = kStream ? min(a.chunk, H3 - k0) : H3;
      if (kStream) {
        __syncthreads();  // the last chunk's w_s and part_s are read
        stage_bwd_rows(w_s, L.stride, a.wh, H3, u0, nu, k0, kn, round_up(kn, kKBlock));
        __syncthreads();
      }
      chunk_product<kBwdMt, kBwdLoads, false, kStamps>(w_s, L.stride, nu, L.mts, src, nr, k0, kn,
                                                       part_s, L.tile_row, kStream && c > 0, st,
                                                       kDghLoad);
    }
    __syncthreads();
    if constexpr (kStamps) st.mark(kBwdProduct);
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k)
      if (tid + k * kBlockThreads < n_pairs)
        carry[k] = dhz[k] + part_at(part_s, pr[k].part[0], kparts);
    for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
      carry_s[p - kRegPairs] = dhz_s[p - kRegPairs] +
                               part_at(part_s, part_base(L.tile_row, kparts, p / nu, p % nu), kparts);
    if constexpr (kStamps) {
      if (n_pairs > tid) settle(carry[0]);
      st.mark(kCarry);
      st.end_step(a.steps - 1 - t);
    }
  }
  if constexpr (kStamps) st.close();

#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k)
    if (tid + k * kBlockThreads < n_pairs) a.dh0[pr[k].rh] = carry[k];
  for (int p = tid + kRegPairs; p < n_pairs; p += kBlockThreads)
    a.dh0[make_pair(p, r0, u0, nu, H, L.tile_row, kparts, 0).rh] = carry_s[p - kRegPairs];
}

// One direction's launch: ``groups`` row groups of ``rows`` rows (the last
// may hold fewer), each of ``blocks`` blocks of ``units`` hidden units;
// K staged in chunks of ``chunk`` (all of K: wh resident).
struct DirPlan {
  int groups, rows, blocks, units, chunk;
  size_t smem;
};

// Plans one direction (K = H forward, 3H backward) at these widths:
// the most row groups (rows a multiple of 8) whose blocks hold their slice
// of wh whole; where none do, the fewest groups, with the widest K chunk
// that fits. Each group takes an equal share of the SMs and splits H over
// it (``units`` 0: as few units per block as that share allows). Refuses a
// grid that cannot be resident or a block that does not fit even a 16-deep
// chunk.
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

struct Plan {
  DirPlan fwd, bwd;
  int sms;
};

cudaError_t plan_launch(int batch, int hidden, int units, Plan* p) {
  if (batch < 1 || hidden < 1 || units < 0) return cudaErrorInvalidValue;
  int max_smem;
  cudaError_t err = device_limits(&p->sms, &max_smem);
  if (err != cudaSuccess) return err;
  err = plan_direction(batch, hidden, units, hidden, p->sms, max_smem,
                       [&](int U, int kc, int rows) { return fwd_layout(hidden, U, kc, rows).total; },
                       &p->fwd);
  if (err != cudaSuccess) return err;
  return plan_direction(batch, hidden, units, 3 * hidden, p->sms, max_smem,
                        [&](int U, int kc, int rows) { return bwd_layout(hidden, U, kc, rows).total; },
                        &p->bwd);
}

// The forward kernel of a launch: with residuals (``save``), masked, or
// neither; streaming wh in K chunks or not; stamped (with residuals).
const void* fwd_kernel(bool save, bool mask, bool stream, bool stamps) {
  if (stamps)
    return stream ? (const void*)gru_scan_grid_kernel<true, false, true, true>
                  : (const void*)gru_scan_grid_kernel<true, false, false, true>;
  if (stream)
    return save ? (const void*)gru_scan_grid_kernel<true, false, true, false>
           : mask ? (const void*)gru_scan_grid_kernel<false, true, true, false>
                  : (const void*)gru_scan_grid_kernel<false, false, true, false>;
  return save ? (const void*)gru_scan_grid_kernel<true, false, false, false>
         : mask ? (const void*)gru_scan_grid_kernel<false, true, false, false>
                : (const void*)gru_scan_grid_kernel<false, false, false, false>;
}

const void* bwd_kernel(bool stream, bool stamps) {
  if (stamps)
    return stream ? (const void*)gru_scan_bwd_kernel<true, true>
                  : (const void*)gru_scan_bwd_kernel<false, true>;
  return stream ? (const void*)gru_scan_bwd_kernel<true, false>
                : (const void*)gru_scan_bwd_kernel<false, false>;
}

// Readies ``kernel`` for a direction's plan and launches it on ``stream``.
cudaError_t launch(const void* kernel, const DirPlan& d, int sms, void* args, void* stream) {
  cudaError_t err = ready_resident(kernel, d.smem, d.groups * d.blocks, sms, kBlockThreads);
  if (err != cudaSuccess) return err;
  void* params[] = {args};
  cudaLaunchCooperativeKernel(kernel, dim3(d.groups * d.blocks), dim3(kBlockThreads), params,
                              d.smem, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward's and then the backward's row groups, rows per group, blocks
// per group, hidden units per block, dynamic shared memory bytes and K
// chunk of a launch at these widths (``units`` 0: the default); returns a
// cudaError_t, also where the plain kernels cannot all be resident.
int vq_gru_grid_plan(int batch, int hidden, int units, int* out12) {
  Plan p;
  cudaError_t err = plan_launch(batch, hidden, units, &p);
  if (err != cudaSuccess) return (int)err;
  const DirPlan* dirs[2] = {&p.fwd, &p.bwd};
  for (int d = 0; d < 2; ++d) {
    const int* v[] = {&dirs[d]->groups, &dirs[d]->rows, &dirs[d]->blocks, &dirs[d]->units};
    for (int i = 0; i < 4; ++i) out12[6 * d + i] = *v[i];
    out12[6 * d + 4] = (int)dirs[d]->smem;
    out12[6 * d + 5] = dirs[d]->chunk;
  }
  err = ready_resident(fwd_kernel(true, false, p.fwd.chunk < hidden, false), p.fwd.smem,
                       p.fwd.groups * p.fwd.blocks, p.sms, kBlockThreads);
  if (err != cudaSuccess) return (int)err;
  return (int)ready_resident(bwd_kernel(p.bwd.chunk < 3 * hidden, false), p.bwd.smem,
                             p.bwd.groups * p.bwd.blocks, p.sms, kBlockThreads);
}

// The forward on ``stream``, with ``stamps`` non-null the stamped variant
// (int64, 2 x (4 + steps x kFwdPhases), zeroed; it takes ``save`` 1). With
// ``save`` 0, ``acts`` and ``hn`` are not written (and may be null); a
// non-null ``valid`` (T, B) int32 masks rows (and takes ``save`` 0).
// ``xchg`` (2, B, H) uint32, zeroed: the exchange of h between blocks.
// Allocates nothing and does not synchronise; returns cudaGetLastError()
// after the launch.
int vq_gru_scan_grid_stamped_launch(const void* xproj, const void* valid, const void* wh,
                                    const void* bh, const void* h0, void* hs, void* acts, void* hn,
                                    void* h_out, void* xchg, int steps, int batch, int hidden,
                                    int save, void* stamps, void* stream) {
  if (steps < 1 || xchg == nullptr ||
      (save && (acts == nullptr || hn == nullptr || valid != nullptr)) ||
      (stamps != nullptr && !save))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, 0, &p);
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
  a.xchg = static_cast<unsigned int*>(xchg);
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.rows = p.fwd.rows;
  a.blocks = p.fwd.blocks;
  a.units = p.fwd.units;
  a.chunk = p.fwd.chunk;
  const void* kernel = fwd_kernel(save, valid != nullptr, p.fwd.chunk < hidden, stamps != nullptr);
  return (int)launch(kernel, p.fwd, p.sms, &a, stream);
}

int vq_gru_scan_grid_launch(const void* xproj, const void* valid, const void* wh, const void* bh,
                            const void* h0, void* hs, void* acts, void* hn, void* h_out,
                            void* xchg, int steps, int batch, int hidden, int save, void* stream) {
  return vq_gru_scan_grid_stamped_launch(xproj, valid, wh, bh, h0, hs, acts, hn, h_out, xchg,
                                         steps, batch, hidden, save, nullptr, stream);
}

// The backward on ``stream``; the same contract as the forward's launch
// (``stamps``: 2 x (4 + steps x kBwdPhases), its steps in reverse time).
int vq_gru_scan_bwd_stamped_launch(const void* acts, const void* hn, const void* hprev,
                                   const void* dhs, const void* wh, const void* dh_t, void* dgx,
                                   void* dgh, void* dh0, void* sync, int steps, int batch,
                                   int hidden, void* stamps, void* stream) {
  if (steps < 1 || sync == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_launch(batch, hidden, 0, &p);
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
  a.sync = static_cast<unsigned int*>(sync);
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  a.rows = p.bwd.rows;
  a.blocks = p.bwd.blocks;
  a.units = p.bwd.units;
  a.chunk = p.bwd.chunk;
  return (int)launch(bwd_kernel(p.bwd.chunk < 3 * hidden, stamps != nullptr), p.bwd, p.sms, &a,
                     stream);
}

int vq_gru_scan_bwd_launch(const void* acts, const void* hn, const void* hprev, const void* dhs,
                           const void* wh, const void* dh_t, void* dgx, void* dgh, void* dh0,
                           void* sync, int steps, int batch, int hidden, void* stream) {
  return vq_gru_scan_bwd_stamped_launch(acts, hn, hprev, dhs, wh, dh_t, dgx, dgh, dh0, sync,
                                        steps, batch, hidden, nullptr, stream);
}

}  // extern "C"
