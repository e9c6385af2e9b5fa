// The sampling of the AR decode kernels (ar_decode.cu, dual_decode.cu):
// Gumbel-max over a counter-based hash, so that the plain PyTorch versions
// (ar_decode.py:gumbel_bits, gumbel_noise) reproduce every draw bit for bit.

#pragma once

#include <math.h>
#include <stdint.h>

namespace vq_decode {

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

}  // namespace vq_decode
