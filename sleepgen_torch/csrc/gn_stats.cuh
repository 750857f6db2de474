// Group statistics shared by the GroupNorm(+SiLU) kernel (group_norm_silu.cu)
// and the fused GroupNorm -> SiLU -> Conv1d(k=3) kernel (gn_silu_conv3.cu).
//
// Layout: x is (B, C, L), contiguous, so the group (b, g) is one contiguous
// run of n = (C / G) * L elements starting at (b * G + g) * n.
//
// Pass 1 (launch_partial_stats, gn_stats.cu) cuts every group into chunks
// of kStatsChunk elements, one block per (group, chunk), and writes each
// chunk's (count, mean, M2) in fp32: a two-pass mean, then sum of squared
// deviations, over values held in registers. The consumer kernels merge a
// group's chunks with Chan's parallel formula (merge_group). Splitting the
// reduction over blocks keeps the card busy when groups are few and long
// (the AEKL's G = 1 gives 64 groups of up to 98,304 elements at batch 64).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sg {

constexpr int kStatsThreads = 256;
constexpr int kStatsPerThread = 8;
constexpr int kStatsChunk = kStatsThreads * kStatsPerThread;  // 2048 elements
constexpr int kMaxGroups = 64;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Chan et al.'s pairwise update over one group's chunks -> mean, 1/sqrt(var + eps)
// with the biased variance, as torch's GroupNorm.
__device__ __forceinline__ void merge_group(const float3* __restrict__ p, int nchunks, float eps,
                                            float* mean_out, float* rstd_out) {
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const float3 q = p[c];
    const float nn = n + q.x;
    const float delta = q.y - mean;
    mean += delta * (q.x / nn);
    m2 += q.z + delta * delta * (n / nn) * q.x;
    n = nn;
  }
  *mean_out = mean;
  *rstd_out = rsqrtf(m2 / n + eps);
}

// Sum over the block (blockDim.x a multiple of 32, at most 1024); every
// thread gets the result. red needs 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

inline int stats_chunks(int n) { return (n + kStatsChunk - 1) / kStatsChunk; }

// Pass 1 over `groups` groups of n elements each: writes
// partial[group * stats_chunks(n) + chunk]. Defined for float and
// __nv_bfloat16 in gn_stats.cu.
template <typename T>
cudaError_t launch_partial_stats(const T* x, int groups, int n, float3* partial,
                                 cudaStream_t stream);

}  // namespace sg
