// LSTM recurrence over a precomputed input projection on thread-block
// clusters: forward (inference and training variants) and the reverse-time
// backward.
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
// variant's bits (one code path; kSave only adds stores).
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
// What bounds them on an H100. At the CPC training shape (B 64, T 70,
// H 256) each moves ~26 MB (7.8 us at 3.35 TB/s) and does 2.35 GFLOP (2.4
// us on the tensor cores); the export's B 16, T 256 is 3.3 us of bytes.
// Neither is the limit: T dependent steps are, each a (rows, H) x (H, 4H)
// product (the backward: (rows, 4H) x (4H, H)), the gates, and one hand-off
// of the new h (da) to every CTA that needs it. A step costs the latency
// of that hand-off, a short mma chain and the gate math, so the design
// keeps everything else off that path.
//
// Design. wh (H x 4H bf16, 512 KB at H 256) does not fit one SM, so it is
// spread over a cluster of kCluster = 8 CTAs, one cluster per kRows = 8
// batch rows (rows are independent: no grid-wide barrier). CTA r owns the
// hidden units [r U, (r + 1) U), U = H / 8, and holds its 64 KB slice of wh
// as mma.sync.m16n8k16 A fragments (bf16 in, f32 accumulation) in
// registers for the whole scan, the cluster's 8 rows being the mma's N:
//   - forward: gates^T (4U x 8) = wh_slice^T (4U x H) . bf16(h)^T (H x 8).
//     Warp w owns the m-tile of units 4w .. 4w + 3, its 16 M rows
//     permuted so that M row 2j + p + 8 s is gate p + 2 s of unit 4w + j:
//     a lane's accumulators then hold i and g (p 0) or f and o (p 1) of one
//     unit for rows 2q and 2q + 1, and one __shfl_xor with lane ^ 4 gives
//     each lane all four gates of one (row, unit) pair. No shared memory
//     between the product and the gates. At H 256: 8 warps, 16 mma of a
//     16-deep chain split over 4 accumulator chains, 64 registers of wh.
//   - backward: dh^T (U x 8) = wh_rows (U x 4H) . bf16(da)^T (4H x 8).
//     M is the CTA's U units (ceil(U / 16) m-tiles), K the 4H gate columns
//     split into kParts = 4 parts, a warp per (m-tile, part): at H 256,
//     8 warps of 8 K blocks (16 mma, 64 registers of wh) whose 16 x 8
//     partial sums meet in shared memory, added in part order.
//   - the tile every CTA reads, bf16(h) (H x 8) or bf16(da) (4H x 8), is
//     kept in shared memory in the B-fragment order: 32-deep K blocks of
//     32 lanes x 16 bytes, so one 16-byte load per lane feeds two mma steps
//     (K permuted alike in A, as grid_common.cuh:mma_k32 does) and a warp
//     reads 512 contiguous bytes. A CTA's U units take Up = U rounded up to
//     8 places of K (zero beyond U), so every CTA's part of the tile is
//     whole 8-element chunks (Up = U at H 256). Above H 256 a warp keeps
//     kWideRegBlocks (forward) or kRegBlocks (backward) K blocks in
//     registers and the rest of its wh slice in shared memory in fragment
//     order, read with ldmatrix into the same fragments.
//   - the exchange, double-buffered, with no cluster or CTA barrier: each
//     CTA holds one mbarrier per tile buffer. A warp writes its part of
//     the next tile into its own CTA's buffer, sends it to the other 7 CTAs
//     as st.async stores that complete bytes on their mbarrier (8 bytes a
//     row forward, 16 backward: 512 B forward and 2 KB backward per
//     destination at H 256), and arrives on its own CTA's mbarrier (warp 0
//     adding the bytes to expect). A warp waits for its barrier's phase
//     before its product. Nothing else orders a step, so no fence waits on
//     the stores of hs, acts, c_prev and dgates, which follow the sends. A
//     buffer is rewritten two steps later, after every CTA has sent the
//     tile between, which each sends only after its reads of the buffer.
//   - what a step reads from device memory (forward: xproj; backward:
//     acts, c_prev, dhs) is loaded into registers a step ahead.
// Every sum runs in a fixed order (chains, then parts) and no value is
// added atomically, so two launches give the same bits.
//
// The kStamps variants (vq_lstm_scan_stamped_launch,
// vq_lstm_scan_bwd_stamped_launch) also record, on thread 0 of rank 0 of
// the first cluster and of the last rank of the last one, the clock64
// cycles of each phase of every step (FwdPhase, BwdPhase); no entry point
// of the package launches them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

using vq_grid::mma_k32;
using vq_grid::PhaseStamps;
using vq_grid::settle;
using vq_grid::take;

constexpr int kCluster = 8;        // CTAs per cluster (the portable maximum)
constexpr int kRows = 8;           // batch rows per cluster: the mma's N
constexpr int kRegBlocks = 8;      // 32-deep K blocks of a warp's wh slice held in registers
constexpr int kWideRegBlocks = 2;  // the same in the wide forward (128 registers a thread)
constexpr int kParts = 4;          // backward: K parts of each m-tile, a warp each
constexpr int kBlock = 256;        // bf16 of one 32-deep K block of a tile (32 lanes x 8)
// The widest H each kernel takes: the cluster route's widths (wider ones
// take csrc/lstm_grid.cu). The warps that hold them:
constexpr int kMaxHidden = 432, kMaxBwdHidden = 352;
constexpr int kFwdWideWarps = (kMaxHidden / kCluster + 3) / 4;                 // 14
constexpr int kBwdWideWarps = kParts * ((kMaxBwdHidden / kCluster + 15) / 16);  // 12

enum FwdPhase { kXproj, kProduct, kPartSum, kGates, kRemote, kBarrier, kFwdPhases };
enum BwdPhase { kResiduals, kGateGrads, kBwdRemote, kBwdBarrier, kBwdProduct, kBwdPartSum,
                kBwdPhases };

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
  long long* stamps;           // kStamps: (2, 4 + steps * kFwdPhases)
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
  long long* stamps;           // kStamps: (2, 4 + steps * kBwdPhases)
  int steps, batch, hidden;
};

// U rounded up to 8: the places of K a CTA's units take in a tile.
__host__ __device__ __forceinline__ int padded_units(int H) { return (H / kCluster + 7) & ~7; }

// A CTA's plan at width H: its warps, the 32-deep K blocks of each warp's
// wh slice (``extra`` of them in shared memory), the bytes each CTA sends
// every other CTA a step, and its dynamic shared memory. The same on the
// host and the card; lstm_scan.py:scan_plan and bwd_plan mirror it.
struct Plan {
  int warps, kblocks, extra, send_bytes;
  size_t tile, part, afrag, mbar, total;
};

__host__ __device__ __forceinline__ int max0(int x) { return x > 0 ? x : 0; }

// Forward: a warp per 4 units (one m-tile of 16 gate columns) over all 8 Up
// places of K: ceil(U / 4) warps of Up / 4 K blocks, all in registers up to
// kRegBlocks, else kWideRegBlocks of them. A warp sends 8 bytes of each row.
__host__ __device__ __forceinline__ Plan fwd_plan(int H) {
  const int Up = padded_units(H);
  Plan p;
  p.warps = (H / kCluster + 3) / 4;
  p.kblocks = Up / 4;
  p.extra = p.kblocks > kRegBlocks ? p.kblocks - kWideRegBlocks : 0;
  p.send_bytes = p.warps * kRows * 8;
  size_t off = 0;
  p.tile = take(&off, sizeof(__nv_bfloat16) * 2 * p.kblocks * kBlock);
  p.part = 0;  // no partial sums: each warp has all of K
  p.afrag = take(&off, sizeof(__nv_bfloat16) * p.warps * p.extra * 2 * kBlock);
  p.mbar = take(&off, sizeof(unsigned long long) * 2);
  p.total = off;
  return p;
}

// Backward: kParts warps per m-tile of 16 units, each ceil(Up / kParts) of
// the Up K blocks of the 4 x 8 Up places of K. A CTA sends its 8 rows x Up
// places of each gate. Shared memory: the double-buffered bf16(da) tile, a
// 16 x 8 f32 partial sum per warp and the fragments past kRegBlocks.
__host__ __device__ __forceinline__ Plan bwd_plan(int H) {
  const int U = H / kCluster, Up = padded_units(H);
  Plan p;
  p.warps = kParts * ((U + 15) / 16);
  p.kblocks = (Up + kParts - 1) / kParts;
  p.extra = max0(p.kblocks - kRegBlocks);
  p.send_bytes = 4 * kRows * Up * 2;
  size_t off = 0;
  p.tile = take(&off, sizeof(__nv_bfloat16) * 2 * Up * kBlock);
  p.part = take(&off, sizeof(float) * p.warps * 32 * 4);
  p.afrag = take(&off, sizeof(__nv_bfloat16) * p.warps * p.extra * 2 * kBlock);
  p.mbar = take(&off, sizeof(unsigned long long) * 2);
  p.total = off;
  return p;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Offset (bf16) of (row, k) in a tile: K block k / 32, lane row * 4 +
// (k % 32) / 8, 8 bf16 a lane. Lane (g, q) of a warp reads its B fragment of
// block kb as the 16 bytes at kb * 32 + lane (rows g, k kb * 32 + 8q ..).
__device__ __forceinline__ int tile_at(int row, int k) {
  return ((k >> 5) * 32 + row * 4 + ((k & 31) >> 3)) * 8 + (k & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The whole cluster, once: every CTA runs and its mbarriers are set up
// before any CTA writes into another.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of ``p`` (a local shared address) in CTA ``rank``.
__device__ __forceinline__ uint32_t cluster_map(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrives on ``bar``, adding ``tx`` bytes to the phase's expected count.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar, uint32_t tx) {
  if (tx)
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
                 ::"r"(smem_addr(bar)), "r"(tx)
                 : "memory");
  else
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 ::"r"(smem_addr(bar))
                 : "memory");
}

// Waits until the phase of ``bar`` with parity ``parity`` has completed.
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

// Stores ``v`` at the offset of ``local`` in CTA ``rank``'s shared memory,
// completing its bytes on that CTA's ``bar``.
__device__ __forceinline__ void st_async(const void* local, unsigned long long* bar, int rank,
                                         const uint2& v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          cluster_map(local, rank)),
      "r"(v.x), "r"(v.y), "r"(cluster_map(bar, rank))
      : "memory");
}

__device__ __forceinline__ void st_async(const void* local, unsigned long long* bar, int rank,
                                         const uint4& v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(cluster_map(local, rank)),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(cluster_map(bar, rank))
      : "memory");
}

// One lane's 16-byte A fragment word group from shared memory stored word
// by word ([word][lane], 512 bytes): ldmatrix's matrix j is word j.
__device__ __forceinline__ uint4 ldmatrix_x4(const uint32_t* base) {
  uint4 v;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(base + (threadIdx.x & 31) * 4)));
  return v;
}

__device__ __forceinline__ void store_fragment(uint32_t* base, const uint4& f) {
  const int lane = threadIdx.x & 31;
  base[lane] = f.x;
  base[32 + lane] = f.y;
  base[64 + lane] = f.z;
  base[96 + lane] = f.w;
}

// The k of wh that place ``k`` of a padded K range holds: CTA k / Up's
// unit k % Up; -1 for a padding place.
__device__ __forceinline__ int unpadded(int k, int U, int Up) {
  const int r = k / Up, u = k - r * Up;
  return u < U ? r * U + u : -1;
}

// Forward A operand: M row m of warp w's m-tile is gate (m & 1) + 2 (m >> 3)
// of local unit 4w + ((m >> 1) & 3), i.e. wh's column gate * H + u0 + unit;
// K place k is wh's row unpadded(k) (zero past U units or at padding).
// This lane's 16 bytes of K block kb for row m: places kb * 32 + 8q .. + 7,
// two bf16 a word (low half: lower k).
__device__ __forceinline__ uint4 fwd_fragment(const __nv_bfloat16* wh, int H, int Up, int u0,
                                              int warp, int kb, int m, int q) {
  const int U = H / kCluster;
  const int unit = 4 * warp + ((m >> 1) & 3), gate = (m & 1) + 2 * (m >> 3);
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(wh);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t pair = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = unpadded(kb * 32 + 8 * q + 2 * j + e, U, Up);
      const uint32_t v = unit < U && k >= 0 ? bits[(size_t)k * 4 * H + gate * H + u0 + unit] : 0u;
      pair |= v << (16 * e);
    }
    w[j] = pair;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Backward A operand: M row m is local unit m (zero past U), K place k of
// gate k / (8 Up) is wh's column gate * H + unpadded(k % (8 Up)): 16
// contiguous bytes of wh's row u0 + m where Up = U.
__device__ __forceinline__ uint4 bwd_fragment(const __nv_bfloat16* wh, int H, int Up, int u0,
                                              int m, int kb, int q) {
  const int U = H / kCluster;
  if (m >= U) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* row = wh + (size_t)(u0 + m) * 4 * H;
  const int k0 = kb * 32 + 8 * q;
  if (Up == U) return __ldg(reinterpret_cast<const uint4*>(row + k0));
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
  for (int j = 0; j < 4; ++j) {
    uint32_t pair = 0;
    for (int e = 0; e < 2; ++e) {
      const int k = k0 + 2 * j + e, gate = k / (8 * Up), c = unpadded(k - gate * 8 * Up, U, Up);
      pair |= (c >= 0 ? (uint32_t)bits[gate * H + c] : 0u) << (16 * e);
    }
    w[j] = pair;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// kWide: H above 256, the warp's K blocks past kWideRegBlocks in shared memory.
template <bool kSave, bool kStamps, bool kWide>
__global__ void __launch_bounds__((kWide ? kFwdWideWarps : kRegBlocks) * 32, 1)
    lstm_scan_kernel(LstmArgs a) {
  constexpr int kRegs = kWide ? kWideRegBlocks : kRegBlocks;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch, T = a.steps;
  const int U = H / kCluster, Up = padded_units(H);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rank = cluster_rank();
  const int u0 = rank * U;
  const int b0 = (blockIdx.x / kCluster) * kRows;

  const Plan P = fwd_plan(H);
  const int KB = P.kblocks, extra = kWide ? P.extra : 0;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem + P.tile);  // [2][KB][32][8]
  uint32_t* afrag = reinterpret_cast<uint32_t*>(smem + P.afrag);  // [warp][extra][lo, hi][4][32]
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem + P.mbar);  // [2]

  // This warp's A fragments for the whole scan: rows g (lo) and g + 8 (hi).
  uint4 alo[kRegs], ahi[kRegs];
#pragma unroll
  for (int kb = 0; kb < kRegs; ++kb) {
    alo[kb] = kb < KB ? fwd_fragment(a.wh, H, Up, u0, warp, kb, g, q) : make_uint4(0, 0, 0, 0);
    ahi[kb] = kb < KB ? fwd_fragment(a.wh, H, Up, u0, warp, kb, g + 8, q) : make_uint4(0, 0, 0, 0);
  }
  for (int e = 0; e < extra; ++e) {
    uint32_t* f = afrag + ((size_t)(warp * extra + e) * 2) * 128;
    store_fragment(f, fwd_fragment(a.wh, H, Up, u0, warp, kRegs + e, g, q));
    store_fragment(f + 128, fwd_fragment(a.wh, H, Up, u0, warp, kRegs + e, g + 8, q));
  }

  // Both tiles zeroed (padding places), then bf16(h0) into tile 0.
  for (int i = threadIdx.x; i < 2 * KB * kBlock / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    mbar_init(&mbar[0], P.warps);
    mbar_init(&mbar[1], P.warps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const int r = i / H, k = i - r * H, kr = k / U;
    tile[tile_at(r, kr * Up + k - kr * U)] =
        __float2bfloat16(b0 + r < B ? a.h0[(size_t)(b0 + r) * H + k] : 0.f);
  }

  // This lane's gate element: (row 2q + p, local unit 4 warp + g / 2), p = g & 1.
  const int p = g & 1;
  const int row = 2 * q + p, ul = 4 * warp + (g >> 1), unit = u0 + ul;
  const int b = b0 + row;
  const bool own = ul < U, live = own && b < B;
  // What this lane sends: the warp's 4 places of row lane % 8, to the other
  // CTAs lane / 8 and lane / 8 + 4 after this one.
  const int send_at = tile_at(lane & 7, rank * Up + 4 * warp);
  float h = live ? a.h0[(size_t)b * H + unit] : 0.f;
  float c = live ? a.c0[(size_t)b * H + unit] : 0.f;
  // xproj of the step, loaded a step ahead and kept in bf16 until its use,
  // so that no instruction of the step waits for the load.
  __nv_bfloat16 xr[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
    xr[gate] = live ? a.xproj[(size_t)b * H4 + gate * H + unit] : __float2bfloat16(0.f);

  PhaseStamps<kFwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, T);
  cluster_sync();
  for (int t = 0; t < T; ++t) {
    if constexpr (kStamps) st.begin_step();
    const uint4* cur = reinterpret_cast<const uint4*>(tile + (t & 1) * KB * kBlock);
    __nv_bfloat16* nxt = tile + ((t + 1) & 1) * KB * kBlock;
    if (t > 0) mbar_wait(&mbar[t & 1], ((t - 1) >> 1) & 1);  // this step's tile is whole
    if constexpr (kStamps) st.mark(kBarrier);

    // gates^T of this warp's m-tile: four accumulator chains.
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kRegs; ++kb) {
      if (kb < KB) {
        const uint4 bv = cur[kb * 32 + lane];
        mma_k32(acc[(kb & 1) * 2], acc[(kb & 1) * 2 + 1], alo[kb], ahi[kb], bv);
      }
    }
    for (int e = 0; e < extra; ++e) {
      const int kb = kRegs + e;
      const uint32_t* f = afrag + ((size_t)(warp * extra + e) * 2) * 128;
      const uint4 lo = ldmatrix_x4(f), hi = ldmatrix_x4(f + 128);
      const uint4 bv = cur[kb * 32 + lane];
      mma_k32(acc[(kb & 1) * 2], acc[(kb & 1) * 2 + 1], lo, hi, bv);
    }
    if constexpr (kStamps) {
      settle(acc[0][0] + acc[1][0] + acc[2][0] + acc[3][0]);
      st.mark(kProduct);
    }

    // The chains in a fixed order; then lane ^ 4 supplies the other two gates.
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
    float x[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) x[gate] = __bfloat162float(xr[gate]);
    const float r0 = __shfl_xor_sync(0xffffffffu, p ? s[0] : s[1], 4);
    const float r1 = __shfl_xor_sync(0xffffffffu, p ? s[2] : s[3], 4);
    const float hi_ = p ? r0 : s[0], hf = p ? s[1] : r0;
    const float hg = p ? r1 : s[2], ho = p ? s[3] : r1;
    if constexpr (kStamps) {
      settle(hi_ + hf + hg + ho);
      st.mark(kPartSum);
      settle(x[0] + x[1] + x[2] + x[3]);
      st.mark(kXproj);
    }

    const float c_in = c;
    const float ig = sigmoid(x[0] + hi_);
    const float fg = sigmoid(x[1] + hf);
    const float gg = tanhf(x[2] + hg);
    const float og = sigmoid(x[3] + ho);
    c = fg * c + ig * gg;
    h = og * tanhf(c);
    const __nv_bfloat16 hb = __float2bfloat16(h);
    if constexpr (kStamps) st.mark(kGates);

    const bool more = t + 1 < T;
    if (more) {  // this warp's part of the next tile, here and in the other CTAs
      unsigned long long* bar = &mbar[(t + 1) & 1];
      if (own) nxt[tile_at(row, rank * Up + ul)] = hb;
      __syncwarp();
      const uint2 v = *reinterpret_cast<const uint2*>(nxt + send_at);
      for (int i = lane >> 3; i < kCluster - 1; i += 4)
        st_async(nxt + send_at, bar, (rank + 1 + i) % kCluster, v);
      if (lane == 0) mbar_arrive(bar, warp == 0 ? (kCluster - 1) * P.send_bytes : 0);
    }
    if constexpr (kStamps) st.mark(kRemote);
    // This step's stores and the next step's inputs, off the path.
    if (live) {
      a.hs[((size_t)t * B + b) * H + unit] = hb;
      if (kSave) {
        __nv_bfloat16* arow = a.acts + ((size_t)t * B + b) * H4 + unit;
        arow[0] = __float2bfloat16(ig);
        arow[H] = __float2bfloat16(fg);
        arow[2 * H] = __float2bfloat16(gg);
        arow[3 * H] = __float2bfloat16(og);
        a.c_prev[((size_t)t * B + b) * H + unit] = c_in;
      }
      if (more) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          xr[gate] = a.xproj[((size_t)(t + 1) * B + b) * H4 + gate * H + unit];
      }
    }
    if constexpr (kStamps) {
      st.mark(kGates);
      st.end_step(t);
    }
  }
  if constexpr (kStamps) st.close();

  if (live) {
    a.h_out[(size_t)b * H + unit] = h;
    a.c_out[(size_t)b * H + unit] = c;
  }
}

template <bool kStamps, bool kWide>
__global__ void __launch_bounds__((kWide ? kBwdWideWarps : kRegBlocks) * 32, 1)
    lstm_scan_bwd_kernel(LstmBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.hidden, H4 = 4 * a.hidden, B = a.batch, T = a.steps;
  const int U = H / kCluster, Up = padded_units(H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rank = cluster_rank();
  const int u0 = rank * U;
  const int b0 = (blockIdx.x / kCluster) * kRows;

  const Plan P = bwd_plan(H);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem + P.tile);  // [2][Up][32][8]
  float4* part_s = reinterpret_cast<float4*>(smem + P.part);              // [warp][32]
  uint32_t* afrag = reinterpret_cast<uint32_t*>(smem + P.afrag);  // [warp][extra][lo, hi][4][32]
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem + P.mbar);  // [2]

  // This warp's (m-tile, K part) and its K blocks [kb0, kb0 + nkb) of the Up
  // (lstm_scan.py:bwd_warp_blocks).
  const int mt = warp / kParts, part = warp - mt * kParts;
  const int kb0 = part * P.kblocks, nkb = max0(min(P.kblocks, Up - kb0));
  const int extra = kWide ? max0(nkb - kRegBlocks) : 0;
  uint4 alo[kRegBlocks], ahi[kRegBlocks];
#pragma unroll
  for (int e = 0; e < kRegBlocks; ++e) {
    alo[e] = e < nkb ? bwd_fragment(a.wh, H, Up, u0, 16 * mt + g, kb0 + e, q) : make_uint4(0, 0, 0, 0);
    ahi[e] = e < nkb ? bwd_fragment(a.wh, H, Up, u0, 16 * mt + g + 8, kb0 + e, q)
                     : make_uint4(0, 0, 0, 0);
  }
  for (int e = 0; e < extra; ++e) {
    uint32_t* f = afrag + ((size_t)(warp * P.extra + e) * 2) * 128;
    store_fragment(f, bwd_fragment(a.wh, H, Up, u0, 16 * mt + g, kb0 + kRegBlocks + e, q));
    store_fragment(f + 128, bwd_fragment(a.wh, H, Up, u0, 16 * mt + g + 8, kb0 + kRegBlocks + e, q));
  }
  for (int i = tid; i < 2 * Up * kBlock / 8; i += blockDim.x)  // padding places stay zero
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    mbar_init(&mbar[0], P.warps);
    mbar_init(&mbar[1], P.warps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // This thread's gate element (row, local unit ul), threads below 8 Up.
  const bool gp = tid < kRows * Up;
  const int row = gp ? tid / Up : 0, ul = gp ? tid - row * Up : 0, unit = u0 + ul;
  const int b = b0 + row;
  const bool own = gp && ul < U, live = own && b < B;
  // Where its dh sits in the partial sums: m-tile ul / 16, lane, element
  // (lstm_scan.py:bwd_partial_at).
  const int pm = ul & 15;
  const int pslot = (ul >> 4) * kParts * 32 + (pm & 7) * 4 + (row >> 1);
  const int pcomp = (pm >> 3) * 2 + (row & 1);
  // What this lane sends: gate lane % 4 of the 8 places of its warp's group
  // (lane % 16) / 4, to the other CTAs lane / 16, + 2, + 4, + 6 after this one.
  const int group = warp * 32 + (lane & 15) / 4 * 8;  // the group's first thread
  const bool sends = group < kRows * Up;
  const int send_at = tile_at(group / Up, (lane & 3) * 8 * Up + rank * Up + group % Up);
  float dh = live ? a.dh_t[(size_t)b * H + unit] : 0.f;
  float dc = live ? a.dc_t[(size_t)b * H + unit] : 0.f;
  // The step's residuals, loaded a step ahead and kept as loaded until
  // their use, so that no instruction of the step waits for the loads.
  __nv_bfloat16 ra[4], rdh;
  float rcp = 0.f;
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) ra[gate] = __float2bfloat16(0.f);
  rdh = ra[0];
  auto load_residuals = [&](int t) {
    const size_t bt = (size_t)t * B + b;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) ra[gate] = a.acts[bt * H4 + gate * H + unit];
    rcp = a.c_prev[bt * H + unit];
    rdh = a.dhs[bt * H + unit];
  };
  if (live) load_residuals(T - 1);

  PhaseStamps<kBwdPhases> st;
  if constexpr (kStamps) st.open(a.stamps, T);
  cluster_sync();
  for (int i = 0; i < T; ++i) {
    if constexpr (kStamps) {
      st.begin_step();
      settle(__bfloat162float(ra[0]) + __bfloat162float(ra[1]) + __bfloat162float(ra[2]) +
             __bfloat162float(ra[3]) + rcp + __bfloat162float(rdh));
      st.mark(kResiduals);
    }
    const int t = T - 1 - i;
    __nv_bfloat16* da_t = tile + (i & 1) * Up * kBlock;
    unsigned long long* bar = &mbar[i & 1];

    float da[4] = {0.f, 0.f, 0.f, 0.f};
    if (own) {
      const float ai = __bfloat162float(ra[0]), af = __bfloat162float(ra[1]);
      const float ag = __bfloat162float(ra[2]), ao = __bfloat162float(ra[3]), cp = rcp;
      const float cc = af * cp + ai * ag;  // recomputed, not stored
      const float tc = tanhf(cc);
      dh += __bfloat162float(rdh);
      const float d_o = dh * tc;
      dc += dh * ao * (1.f - tc * tc);
      da[0] = dc * ag * ai * (1.f - ai);
      da[1] = dc * cp * af * (1.f - af);
      da[2] = dc * ai * (1.f - ag * ag);
      da[3] = d_o * ao * (1.f - ao);
      dc *= af;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        da_t[tile_at(row, gate * 8 * Up + rank * Up + ul)] = __float2bfloat16(da[gate]);
    }
    if constexpr (kStamps) st.mark(kGateGrads);
    // This warp's part of the tile, here and in the other CTAs.
    __syncwarp();
    if (sends) {
      const uint4 v = *reinterpret_cast<const uint4*>(da_t + send_at);
      for (int j = lane >> 4; j < kCluster - 1; j += 2)
        st_async(da_t + send_at, bar, (rank + 1 + j) % kCluster, v);
    }
    if (lane == 0) mbar_arrive(bar, warp == 0 ? (kCluster - 1) * P.send_bytes : 0);
    if constexpr (kStamps) st.mark(kBwdRemote);
    // Off the path: dgates of this step and the residuals of the next.
    if (live) {
      __nv_bfloat16* grow = a.dgates + ((size_t)t * B + b) * H4 + unit;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) grow[gate * H] = __float2bfloat16(da[gate]);
      if (t > 0) load_residuals(t - 1);
    }
    if constexpr (kStamps) st.mark(kGateGrads);
    mbar_wait(bar, (i >> 1) & 1);  // the tile is whole
    if constexpr (kStamps) st.mark(kBwdBarrier);

    // dh^T of this warp's m-tile over its K part: four accumulator chains.
    const uint4* cur = reinterpret_cast<const uint4*>(da_t);
    float acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
    for (int e = 0; e < kRegBlocks; ++e) {
      if (e < nkb) {
        const uint4 bv = cur[(kb0 + e) * 32 + lane];
        mma_k32(acc[(e & 1) * 2], acc[(e & 1) * 2 + 1], alo[e], ahi[e], bv);
      }
    }
    for (int e = 0; e < extra; ++e) {
      const int kb = kRegBlocks + e;
      const uint32_t* f = afrag + ((size_t)(warp * P.extra + e) * 2) * 128;
      const uint4 lo = ldmatrix_x4(f), hi = ldmatrix_x4(f + 128);
      const uint4 bv = cur[(kb0 + kb) * 32 + lane];
      mma_k32(acc[(kb & 1) * 2], acc[(kb & 1) * 2 + 1], lo, hi, bv);
    }
    float4 s;
    s.x = (acc[0][0] + acc[1][0]) + (acc[2][0] + acc[3][0]);
    s.y = (acc[0][1] + acc[1][1]) + (acc[2][1] + acc[3][1]);
    s.z = (acc[0][2] + acc[1][2]) + (acc[2][2] + acc[3][2]);
    s.w = (acc[0][3] + acc[1][3]) + (acc[2][3] + acc[3][3]);
    part_s[warp * 32 + lane] = s;
    if constexpr (kStamps) {
      settle(s.x);
      st.mark(kBwdProduct);
    }
    __syncthreads();
    if (own) {  // the K parts in part order
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kParts; ++k)
        sum += reinterpret_cast<const float*>(part_s + pslot + k * 32)[pcomp];
      dh = sum;
    }
    if constexpr (kStamps) {
      settle(dh);
      st.mark(kBwdPartSum);
      st.end_step(i);
    }
    // A warp writes the other tile next step and part_s after the next
    // step's wait, which needs every warp's arrival of that step, made
    // after its reads of this step's part_s.
  }
  if constexpr (kStamps) st.close();

  if (live) {
    a.dh0[(size_t)b * H + unit] = dh;
    a.dc0[(size_t)b * H + unit] = dc;
  }
}

bool hidden_ok(int hidden, int max_hidden) {
  return hidden >= kCluster && hidden % kCluster == 0 && hidden <= max_hidden;
}

template <typename Args>
cudaError_t launch_cluster(const void* kernel, const Args& a, int warps, size_t smem,
                           cudaStream_t stream) {
  int dev, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.batch + kRows - 1) / kRows * kCluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchKernelExC(&cfg, kernel, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kSave, bool kStamps>
const void* fwd_kernel(bool wide) {
  return wide ? reinterpret_cast<const void*>(lstm_scan_kernel<kSave, kStamps, true>)
              : reinterpret_cast<const void*>(lstm_scan_kernel<kSave, kStamps, false>);
}

cudaError_t launch_fwd(const LstmArgs& a, bool save, bool stamps, cudaStream_t stream) {
  if (a.steps < 1 || a.batch < 1 || !hidden_ok(a.hidden, kMaxHidden)) return cudaErrorInvalidValue;
  const Plan P = fwd_plan(a.hidden);
  const bool wide = P.extra > 0;
  const void* kernel = save ? (stamps ? fwd_kernel<true, true>(wide) : fwd_kernel<true, false>(wide))
                            : (stamps ? fwd_kernel<false, true>(wide) : fwd_kernel<false, false>(wide));
  return launch_cluster(kernel, a, P.warps, P.total, stream);
}

LstmArgs fwd_args(const void* xproj, const void* wh, const void* h0, const void* c0, void* hs,
                  void* acts, void* c_prev, void* h_out, void* c_out, int steps, int batch,
                  int hidden, void* stamps) {
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
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  return a;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA of a forward launch at width
// ``hidden`` uses (0 past the widths it takes).
int vq_lstm_scan_smem_bytes(int hidden) {
  return hidden_ok(hidden, kMaxHidden) ? (int)fwd_plan(hidden).total : 0;
}

// The same for a backward launch.
int vq_lstm_scan_bwd_smem_bytes(int hidden) {
  return hidden_ok(hidden, kMaxBwdHidden) ? (int)bwd_plan(hidden).total : 0;
}

// The launches below run on ``stream``, allocate nothing and do not
// synchronise; each returns cudaGetLastError() after the launch.

// Inference variant: hs, h_T, c_T.
int vq_lstm_scan_launch(const void* xproj, const void* wh, const void* h0,
                        const void* c0, void* hs, void* h_out, void* c_out,
                        int steps, int batch, int hidden, void* stream) {
  return (int)launch_fwd(fwd_args(xproj, wh, h0, c0, hs, nullptr, nullptr, h_out, c_out, steps,
                                  batch, hidden, nullptr),
                         false, false, static_cast<cudaStream_t>(stream));
}

// Training variant: also the residuals acts (T, B, 4H) bf16 and c_prev (T, B, H) f32.
int vq_lstm_scan_train_launch(const void* xproj, const void* wh, const void* h0,
                              const void* c0, void* hs, void* acts, void* c_prev,
                              void* h_out, void* c_out, int steps, int batch, int hidden,
                              void* stream) {
  return (int)launch_fwd(fwd_args(xproj, wh, h0, c0, hs, acts, c_prev, h_out, c_out, steps,
                                  batch, hidden, nullptr),
                         true, false, static_cast<cudaStream_t>(stream));
}

// The forward's stamped variant (``save`` 0: inference, 1: training);
// ``stamps`` int64 (2, 4 + steps x kFwdPhases), zeroed.
int vq_lstm_scan_stamped_launch(const void* xproj, const void* wh, const void* h0,
                                const void* c0, void* hs, void* acts, void* c_prev,
                                void* h_out, void* c_out, int steps, int batch, int hidden,
                                int save, void* stamps, void* stream) {
  if (stamps == nullptr || (save && (acts == nullptr || c_prev == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd(fwd_args(xproj, wh, h0, c0, hs, acts, c_prev, h_out, c_out, steps,
                                  batch, hidden, stamps),
                         save != 0, true, static_cast<cudaStream_t>(stream));
}

// Backward: dgates (T, B, 4H) bf16, dh0 and dc0 (B, H) f32; with ``stamps``
// non-null (int64 (2, 4 + steps x kBwdPhases), zeroed, steps in reverse
// time) the stamped variant.
int vq_lstm_scan_bwd_stamped_launch(const void* acts, const void* c_prev, const void* dhs,
                                    const void* wh, const void* dh_t, const void* dc_t,
                                    void* dgates, void* dh0, void* dc0, int steps, int batch,
                                    int hidden, void* stamps, void* stream) {
  if (steps < 1 || batch < 1 || !hidden_ok(hidden, kMaxBwdHidden))
    return (int)cudaErrorInvalidValue;
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
  a.stamps = static_cast<long long*>(stamps);
  a.steps = steps;
  a.batch = batch;
  a.hidden = hidden;
  const Plan P = bwd_plan(hidden);
  const bool wide = P.extra > 0;
  const void* kernel =
      stamps != nullptr
          ? (wide ? reinterpret_cast<const void*>(lstm_scan_bwd_kernel<true, true>)
                  : reinterpret_cast<const void*>(lstm_scan_bwd_kernel<true, false>))
          : (wide ? reinterpret_cast<const void*>(lstm_scan_bwd_kernel<false, true>)
                  : reinterpret_cast<const void*>(lstm_scan_bwd_kernel<false, false>));
  return (int)launch_cluster(kernel, a, P.warps, P.total, static_cast<cudaStream_t>(stream));
}

int vq_lstm_scan_bwd_launch(const void* acts, const void* c_prev, const void* dhs,
                            const void* wh, const void* dh_t, const void* dc_t, void* dgates,
                            void* dh0, void* dc0, int steps, int batch, int hidden,
                            void* stream) {
  return vq_lstm_scan_bwd_stamped_launch(acts, c_prev, dhs, wh, dh_t, dc_t, dgates, dh0, dc0,
                                         steps, batch, hidden, nullptr, stream);
}

}  // extern "C"
