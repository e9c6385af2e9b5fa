// The decode kernels' shared core (ar_decode.cu, dual_decode.cu): their
// sampling, Gumbel-max over a counter-based hash, so that the plain PyTorch
// versions (ar_decode.py:gumbel_bits, gumbel_noise) reproduce every draw bit
// for bit; and their product pass (tile_pass), on grid_common.cuh's mma.

#pragma once

#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace vq_decode {

using namespace vq_grid;

constexpr int kMaxBatch = 128;        // rows of one launch (the JAX kernel's largest)
constexpr int kKBytes = 2 * kKBlock;  // bytes of a row one K block holds: 4 lanes x 16

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// The Gumbel noise of (step key, row b, class c) among C classes a row:
// 24 hashed bits of b C + c -> uniform (0, 1] -> -log(-log(u)), as
// ar_decode.py:gumbel_noise.
__device__ __forceinline__ float gumbel(uint32_t step_key, int b, int c, int C) {
  const uint32_t bits = mix32(step_key ^ (uint32_t)(b * C + c));
  const float u = (float)(bits & 0xffffffu) * (1.0f / 16777216.0f) + 1e-9f;
  return -logf(-logf(u));
}

// The argmax's order: the larger score, the lower index among equal ones.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// mma_k32 over a 64-deep int8 K block (16 int8 a lane): two m16n8k32 steps,
// their exact int32 sums carried in the f32 registers' bits.
__device__ __forceinline__ void mma_k64_s8(float c0[4], float c1[4], const uint4& lo,
                                           const uint4& hi, const uint4& b) {
  int i0[4], i1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    i0[e] = __float_as_int(c0[e]);
    i1[e] = __float_as_int(c1[e]);
  }
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(i0[0]), "+r"(i0[1]), "+r"(i0[2]), "+r"(i0[3])
      : "r"(lo.x), "r"(hi.x), "r"(lo.y), "r"(hi.y), "r"(b.x), "r"(b.y));
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(i1[0]), "+r"(i1[1]), "+r"(i1[2]), "+r"(i1[3])
      : "r"(lo.z), "r"(hi.z), "r"(lo.w), "r"(hi.w), "r"(b.z), "r"(b.w));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c0[e] = __int_as_float(i0[e]);
    c1[e] = __int_as_float(i1[e]);
  }
}

// The two chains' sum of one accumulator element (int32 sums are exact).
template <bool kInt8>
__device__ __forceinline__ float add_chains(float a, float b) {
  if constexpr (kInt8)
    return __int_as_float(__float_as_int(a) + __float_as_int(b));
  else
    return a + b;
}

// A warp's sums of NT row tiles x MT A tiles, each in two chains (the two
// mma steps of a K block): c[e] at A row g (+ 8 for e >= 2), tile row 2q
// (+ 1 for odd e).
template <int NT, int MT>
struct Chains {
  float c[NT][MT][2][4];
};

// One warp's pass over K blocks [kb_lo, kb_hi) for NT row tiles (1 or 2)
// at once: tile ``tile`` and, for NT 2, the tile kBlockWarps further on, of
// ``nr`` rows; A tiles [mt0, mt0 + MT) below ``mts`` of ``w_s`` (rows
// ``stride`` bytes apart from local K 0, row ``zrow`` zero), bf16 or int8.
// ``load(n, kb)`` gives the lane's 16 bytes of K block kb of row n; LOADS K
// blocks of every tile are in flight at once before their mma steps. Each
// A fragment is read from shared memory once for all NT tiles, and each
// tile's two chains add their K blocks in order, so a tile's sums are those
// of a pass of its own (emit_chains hands them out). The stamped variant
// marks ``load_phase`` once the first loads are there.
template <int NT, int MT, int LOADS, bool kInt8, bool kStamps, int kPhases, class Load>
__device__ __forceinline__ Chains<NT, MT> tile_pass(const unsigned char* w_s, int stride, int zrow,
                                                    int mt0, int mts, int tile, int nr, int kb_lo,
                                                    int kb_hi, Load load,
                                                    PhaseStamps<kPhases>& st, int load_phase) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  Chains<NT, MT> s;
  auto& c = s.c;
  int n[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) n[j] = (tile + j * kBlockWarps) * kTile + g;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][mt][0][e] = c[j][mt][1][e] = 0.f;
  for (int kb0 = kb_lo; kb0 < kb_hi; kb0 += LOADS) {
    uint4 bv[NT][LOADS];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        bv[j][i] = n[j] < nr && kb0 + i < kb_hi ? load(n[j], kb0 + i) : make_uint4(0, 0, 0, 0);
    if constexpr (kStamps) {
      if (mt0 == 0 && kb0 == kb_lo) {
        uint32_t all = 0;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < LOADS; ++i) all ^= bv[j][i].x ^ bv[j][i].w;
        settle(all);
        st.mark(load_phase);
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int kb = kb0 + i;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt0 + mt < mts && kb < kb_hi) {
          const int r_lo = min((mt0 + mt) * 16 + g, zrow);
          const int r_hi = min((mt0 + mt) * 16 + g + 8, zrow);
          const uint4 lo = *reinterpret_cast<const uint4*>(w_s + (size_t)r_lo * stride +
                                                           kb * kKBytes + q * 16);
          const uint4 hi = *reinterpret_cast<const uint4*>(w_s + (size_t)r_hi * stride +
                                                           kb * kKBytes + q * 16);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if constexpr (kInt8)
              mma_k64_s8(c[j][mt][0], c[j][mt][1], lo, hi, bv[j][i]);
            else
              mma_k32(c[j][mt][0], c[j][mt][1], lo, hi, bv[j][i]);
          }
        }
      }
    }
  }
  return s;
}

// tile_pass's sums as ``emit(row, A row, sum)``, each of a row below ``nr``
// and an A row below ``zrow``. Apart from the pass, so that a caller whose
// K ranges may be split (the AR decode) branches around it once: checked
// element by element, it made the AR's product at B 8 some 30 % slower on
// an H100.
template <bool kInt8, int NT, int MT, class Emit>
__device__ __forceinline__ void emit_chains(const Chains<NT, MT>& s, int mt0, int mts, int tile,
                                            int nr, int zrow, Emit emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = (mt0 + mt) * 16 + g + 8 * (e >> 1);
        const int b = (tile + j * kBlockWarps) * kTile + 2 * q + (e & 1);
        if (mt0 + mt < mts && m < zrow && b < nr)
          emit(b, m, add_chains<kInt8>(s.c[j][mt][0][e], s.c[j][mt][1][e]));
      }
}

}  // namespace vq_decode
