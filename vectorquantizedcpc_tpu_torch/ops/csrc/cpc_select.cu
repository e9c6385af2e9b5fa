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
// H100 it is bound by its bytes (forward ~16 MB, ~4.8 us at 3.35 TB/s;
// backward ~28.6 MB, ~8.5 us), so it is written as a gather:
//   - a warp per anchor (u, l), its lanes over Z, the anchor's wc row in
//     registers (Z <= 256; wider rows are taken in chunks of 256, the
//     forward adding each chunk's sums to the scores); lane n first
//     loads negative n's (v, m) (and, backward, d_fneg), and the loop over
//     negatives takes them by shuffle, so no step of it waits on device
//     memory;
//   - forward: a group of blocks per (k, s), each with the (k, s) tile of
//     z_shift (U L x Z f32, 128 KB at the training shape) in shared memory
//     when it fits, else read through the L1 cache; f_pos and every f_neg
//     are summed by the same routine in the same order (lane FMAs, then a
//     fixed xor butterfly), so a negative that lands on the positive's own
//     frame, or on an equal vector, ties with it bit for bit;
//   - backward, one launch of two kinds of blocks: gather blocks give d_wc
//     (one writer per anchor, the z_shift tile in shared memory as in the
//     forward); one scatter block per (k, s) owns that d_zs tile in shared
//     memory (when it fits; else the zeroed output in device memory), since
//     every contribution to it comes from the same (k, s), adds into it with
//     atomics and writes it out once. The atomics' order varies from run to
//     run, so d_zs does too, by f32 rounding; d_wc does not.
// Indices out of range give NaN scores (forward) and no contribution
// (backward) rather than reading outside the tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxZLane = 8;  // Z values per lane held in registers: 256 per chunk

struct SelectArgs {
  const float* wc;   // (KS, U, L, Z)
  const float* zs;   // (KS, U, L, Z) z_shift
  const int* utt;    // (K, U, N)
  const int* seq;    // (KS, U, N, L)
  float* f_neg;      // (KS, U, N, L)
  float* f_pos;      // (KS, U, L)
  int ks, s_count, u_count, n_count, l_count, z_dim;
  int groups;        // blocks per (k, s)
  int tile;          // 1: the block's z_shift tile in shared memory
};

struct SelectBwdArgs {
  const float* d_fneg;  // (KS, U, N, L)
  const float* d_fpos;  // (KS, U, L)
  const float* wc;      // (KS, U, L, Z)
  const float* zs;      // (KS, U, L, Z)
  const int* utt;       // (K, U, N)
  const int* seq;       // (KS, U, N, L)
  float* d_wc;          // (KS, U, L, Z)
  float* d_zs;          // (KS, U, L, Z); zeroed by the caller when tile == 0
  int ks, s_count, u_count, n_count, l_count, z_dim;
  int groups;           // gather blocks per (k, s); the scatter blocks follow
  int tile;             // 1: each block's tile in shared memory
};

// w . row over Z, each lane summing its z = lane + 32 i in order, then a
// fixed xor butterfly; every lane ends with the same value. Called by all
// 32 lanes of the warp.
template <int kZL>
__device__ __forceinline__ float warp_dot(const float (&w)[kZL], const float* row, int Z,
                                          int lane) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kZL; ++i) {
    const int z = lane + 32 * i;
    if (z < Z) acc = fmaf(w[i], row[z], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <int kZL>
__device__ __forceinline__ void load_row(float (&w)[kZL], const float* row, int Z, int lane) {
#pragma unroll
  for (int i = 0; i < kZL; ++i) {
    const int z = lane + 32 * i;
    w[i] = z < Z ? row[z] : 0.f;
  }
}

// Negative n of anchor (u, l): its row v L + m of the (k, s) tile, or -1
// when n >= N or an index is out of range.
__device__ __forceinline__ int negative_row(const int* utt, const int* seq, int k, int ks, int U,
                                            int N, int L, int u, int l, int n) {
  if (n >= N) return -1;
  const int v = utt[(k * U + u) * N + n];
  const int m = seq[(((size_t)ks * U + u) * N + n) * L + l];
  return (v >= 0 && v < U && m >= 0 && m < L) ? v * L + m : -1;
}

__device__ void load_tile(float* tile, const float* src, size_t n) {
  const bool vec = (n % 4 == 0) && ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
  if (vec) {
    for (size_t i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(tile)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) tile[i] = src[i];
  }
}

// kZL Z values per lane in registers.
template <int kZL>
__global__ void __launch_bounds__(kThreads) cpc_select_kernel(SelectArgs a) {
  extern __shared__ __align__(16) float tile[];
  const int U = a.u_count, N = a.n_count, L = a.l_count, Z = a.z_dim;
  const int ks = blockIdx.x / a.groups, g = blockIdx.x % a.groups, k = ks / a.s_count;
  const int UL = U * L;
  const size_t ULZ = (size_t)UL * Z;
  const float* zs = a.zs + ks * ULZ;
  if (a.tile) {
    load_tile(tile, zs, ULZ);
    __syncthreads();
    zs = tile;
  }
  const int lane = threadIdx.x % 32;
  for (int an = g * kWarps + threadIdx.x / 32; an < UL; an += a.groups * kWarps) {
    const int u = an / L, l = an - u * L;
    // Z in chunks of 32 kZL (one chunk when Z <= 32 kZL), each chunk's sums
    // added to the scores by the thread that wrote them: every score of the
    // anchor, positive or negative, goes through the same sums in one order.
    for (int z0 = 0; z0 < Z; z0 += 32 * kZL) {
      const int zc = min(32 * kZL, Z - z0);
      float w[kZL];
      load_row(w, a.wc + ks * ULZ + (size_t)an * Z + z0, zc, lane);
      const float fp = warp_dot(w, zs + (size_t)an * Z + z0, zc, lane);
      if (lane == 0) {
        float* out = a.f_pos + (size_t)ks * UL + an;
        *out = z0 == 0 ? fp : *out + fp;
      }
      for (int n0 = 0; n0 < N; n0 += 32) {
        const int my_row = negative_row(a.utt, a.seq, k, ks, U, N, L, u, l, n0 + lane);
        float mine = NAN;
        const int count = min(32, N - n0);
        for (int j = 0; j < count; ++j) {
          const int row = __shfl_sync(0xffffffffu, my_row, j);
          const float f = row >= 0 ? warp_dot(w, zs + (size_t)row * Z + z0, zc, lane) : NAN;
          if (lane == j) mine = f;
        }
        if (lane < count) {
          float* out = a.f_neg + (((size_t)ks * U + u) * N + n0 + lane) * L + l;
          *out = z0 == 0 ? mine : *out + mine;
        }
      }
    }
  }
}

template <int kZL>
__global__ void __launch_bounds__(kThreads) cpc_select_bwd_kernel(SelectBwdArgs a) {
  extern __shared__ __align__(16) float tile[];
  const int U = a.u_count, N = a.n_count, L = a.l_count, Z = a.z_dim;
  const bool gather = blockIdx.x < a.ks * a.groups;
  const int ks = gather ? blockIdx.x / a.groups : blockIdx.x - a.ks * a.groups;
  const int g = gather ? blockIdx.x % a.groups : 0, stride = gather ? a.groups : 1;
  const int k = ks / a.s_count;
  const int UL = U * L;
  const size_t ULZ = (size_t)UL * Z;
  const int lane = threadIdx.x % 32;
  const float* zs = a.zs + ks * ULZ;
  float* acc_zs = a.d_zs + ks * ULZ;
  if (a.tile) {
    if (gather) {
      load_tile(tile, zs, ULZ);
      zs = tile;
    } else {
      for (size_t i = threadIdx.x; i < ULZ; i += blockDim.x) tile[i] = 0.f;
      acc_zs = tile;
    }
    __syncthreads();
  }
  // Z in chunks of 32 kZL (one chunk when Z <= 32 kZL): each z is summed on
  // its own, so the chunks change no sum.
  for (int an = g * kWarps + threadIdx.x / 32; an < UL; an += stride * kWarps) {
    for (int z0 = 0; z0 < Z; z0 += 32 * kZL) {
      const int zc = min(32 * kZL, Z - z0);
      const int u = an / L, l = an - u * L;
      const float dp = a.d_fpos[(size_t)ks * UL + an];
      float w[kZL];  // gather: z_shift row of the anchor; scatter: its wc row
      load_row(w, (gather ? zs : a.wc + ks * ULZ) + (size_t)an * Z + z0, zc, lane);
      float dw[kZL];
#pragma unroll
      for (int i = 0; i < kZL; ++i) {
        dw[i] = dp * w[i];
        const int z = lane + 32 * i;
        if (!gather && z < zc) atomicAdd(acc_zs + (size_t)an * Z + z0 + z, dw[i]);
      }
      for (int n0 = 0; n0 < N; n0 += 32) {
        const int n = n0 + lane;
        const int my_row = negative_row(a.utt, a.seq, k, ks, U, N, L, u, l, n);
        const float my_d = n < N ? a.d_fneg[(((size_t)ks * U + u) * N + n) * L + l] : 0.f;
        const int count = min(32, N - n0);
        for (int j = 0; j < count; ++j) {
          const int row = __shfl_sync(0xffffffffu, my_row, j);
          const float d = __shfl_sync(0xffffffffu, my_d, j);
          if (row < 0) continue;
          const float* at = zs + (size_t)row * Z + z0;
          float* to = acc_zs + (size_t)row * Z + z0;
#pragma unroll
          for (int i = 0; i < kZL; ++i) {
            const int z = lane + 32 * i;
            if (z >= zc) continue;
            if (gather) {
              dw[i] = fmaf(d, at[z], dw[i]);
            } else {
              atomicAdd(to + z, d * w[i]);
            }
          }
        }
      }
      if (gather) {
#pragma unroll
        for (int i = 0; i < kZL; ++i) {
          const int z = lane + 32 * i;
          if (z < zc) a.d_wc[ks * ULZ + (size_t)an * Z + z0 + z] = dw[i];
        }
      }
    }
  }
  if (a.tile && !gather) {
    __syncthreads();
    float* out = a.d_zs + ks * ULZ;
    for (size_t i = threadIdx.x; i < ULZ; i += blockDim.x) out[i] = tile[i];
  }
}

// Shared memory of the tile, or 0 when it does not fit one block.
size_t tile_bytes(int u_count, int l_count, int z_dim) {
  const size_t bytes = sizeof(float) * (size_t)u_count * l_count * z_dim;
  int dev, max_smem;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return bytes <= (size_t)max_smem ? bytes : 0;
}

// Blocks per (k, s): enough to fill the SMs left after ``reserved`` other
// blocks once (a block with the tile holds one SM), and no more than there
// are warps' worth of anchors.
int group_count(int ks, int anchors, int reserved) {
  int dev, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int by_sms = (sms - reserved) / ks > 1 ? (sms - reserved) / ks : 1;
  const int by_work = (anchors + kWarps - 1) / kWarps;
  return by_sms < by_work ? by_sms : by_work;
}

bool shape_ok(int ks, int s_count, int u_count, int n_count, int l_count, int z_dim) {
  return ks >= 1 && s_count >= 1 && ks % s_count == 0 && u_count >= 1 && n_count >= 0 &&
         l_count >= 1 && z_dim >= 1;
}

// Z values per lane in registers: 2, 4 or 8 (chunks of 256 above 256).
int lanes_for(int z_dim) {
  if (z_dim <= 64) return 2;
  if (z_dim <= 128) return 4;
  return kMaxZLane;
}

template <typename Kernel, typename Args>
cudaError_t run(Kernel kernel, Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = tile_bytes(a.u_count, a.l_count, a.z_dim);
  a.tile = smem > 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when the z_shift / d_zs tile of one (k, s) fits one block's shared
// memory on the current card (else the kernels read and add in device memory).
int vq_cpc_select_uses_tile(int u_count, int l_count, int z_dim) {
  return tile_bytes(u_count, l_count, z_dim) > 0;
}

// The launches below run on ``stream``, allocate nothing and do not
// synchronise; each returns cudaGetLastError() after the launch.

int vq_cpc_select_launch(const void* wc, const void* zs, const void* utt, const void* seq,
                         void* f_neg, void* f_pos, int ks, int s_count, int u_count,
                         int n_count, int l_count, int z_dim, void* stream) {
  if (!shape_ok(ks, s_count, u_count, n_count, l_count, z_dim)) return cudaErrorInvalidValue;
  SelectArgs a;
  a.wc = static_cast<const float*>(wc);
  a.zs = static_cast<const float*>(zs);
  a.utt = static_cast<const int*>(utt);
  a.seq = static_cast<const int*>(seq);
  a.f_neg = static_cast<float*>(f_neg);
  a.f_pos = static_cast<float*>(f_pos);
  a.ks = ks;
  a.s_count = s_count;
  a.u_count = u_count;
  a.n_count = n_count;
  a.l_count = l_count;
  a.z_dim = z_dim;
  a.groups = group_count(ks, u_count * l_count, 0);
  const int blocks = ks * a.groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes_for(z_dim)) {
    case 2: return (int)run(cpc_select_kernel<2>, a, blocks, s);
    case 4: return (int)run(cpc_select_kernel<4>, a, blocks, s);
    default: return (int)run(cpc_select_kernel<8>, a, blocks, s);
  }
}

// d_zs must hold zeros when vq_cpc_select_uses_tile() is 0.
int vq_cpc_select_bwd_launch(const void* d_fneg, const void* d_fpos, const void* wc,
                             const void* zs, const void* utt, const void* seq, void* d_wc,
                             void* d_zs, int ks, int s_count, int u_count, int n_count,
                             int l_count, int z_dim, void* stream) {
  if (!shape_ok(ks, s_count, u_count, n_count, l_count, z_dim)) return cudaErrorInvalidValue;
  SelectBwdArgs a;
  a.d_fneg = static_cast<const float*>(d_fneg);
  a.d_fpos = static_cast<const float*>(d_fpos);
  a.wc = static_cast<const float*>(wc);
  a.zs = static_cast<const float*>(zs);
  a.utt = static_cast<const int*>(utt);
  a.seq = static_cast<const int*>(seq);
  a.d_wc = static_cast<float*>(d_wc);
  a.d_zs = static_cast<float*>(d_zs);
  a.ks = ks;
  a.s_count = s_count;
  a.u_count = u_count;
  a.n_count = n_count;
  a.l_count = l_count;
  a.z_dim = z_dim;
  a.groups = group_count(ks, u_count * l_count, ks);  // the ks scatter blocks
  const int blocks = ks * (a.groups + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes_for(z_dim)) {
    case 2: return (int)run(cpc_select_bwd_kernel<2>, a, blocks, s);
    case 4: return (int)run(cpc_select_bwd_kernel<4>, a, blocks, s);
    default: return (int)run(cpc_select_bwd_kernel<8>, a, blocks, s);
  }
}

}  // extern "C"
