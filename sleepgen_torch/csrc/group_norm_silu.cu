// GroupNorm (+SiLU) over (B, C, L) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sleepgen/pallas_kernels/group_norm.py
// (fused_group_norm_silu -> _pallas_forward -> _kernel): fp32 statistics
// per (batch row, group), normalise, per-channel affine, optional SiLU,
// output in the input's dtype (fp32 or bf16).
//
// Bound on the card: bytes. The least work reads x once and writes y once
// (at 3.35 TB/s); the arithmetic is a few operations per element.
// Design: the TPU kernel holds a whole (L, C) row in VMEM; a block on
// Hopper cannot, and one block per group would leave most SMs idle for
// the AEKL's G = 1 (64 groups at batch 64). So the reduction is split
// over blocks (gn_stats.cuh, the L-tiled form of the Pallas B2 kernel):
// pass 1 writes per-chunk (count, mean, M2), pass 2 merges a group's
// chunks in its first thread and normalises the chunk. x is read twice
// (the second read mostly from L2), so the kernel moves about 1.5x the
// bound's bytes. The first block of each group also writes the group's
// (mean, rstd), which the backward (group_norm_silu_bwd.cu) reads back
// instead of computing them again.
#include "gn_stats.cuh"

namespace sg {

// grid (B * G, nchunks), kStatsThreads threads: block normalises chunk
// blockIdx.y of group blockIdx.x; stats[group] = (mean, rstd).
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_apply(const T* __restrict__ x, const float3* __restrict__ partial, int nchunks,
         const float* __restrict__ scale, const float* __restrict__ bias, int n, int L,
         int cpg, int G, float eps, int apply_silu, T* __restrict__ y,
         float2* __restrict__ stats) {
  __shared__ float ms[2];
  const int64_t bg = blockIdx.x;
  if (threadIdx.x == 0) {
    merge_group(partial + bg * nchunks, nchunks, eps, &ms[0], &ms[1]);
    if (blockIdx.y == 0) stats[bg] = make_float2(ms[0], ms[1]);
  }
  __syncthreads();
  const float mean = ms[0], rstd = ms[1];
  const int c0 = (int)(bg % G) * cpg;
  const int start = blockIdx.y * kStatsChunk;
  const int cnt = min(kStatsChunk, n - start);
  const T* xg = x + bg * n + start;
  T* yg = y + bg * n + start;
  for (int i = threadIdx.x; i < cnt; i += kStatsThreads) {
    const int c = c0 + (start + i) / L;
    float v = (to_f(xg[i]) - mean) * rstd * scale[c] + bias[c];
    if (apply_silu) v = silu(v);
    yg[i] = from_f<T>(v);
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                          void* stats, void* partial, int B, int C, int L, int G, float eps,
                          int apply_silu, cudaStream_t stream) {
  const int cpg = C / G;
  const int n = cpg * L;
  const int nchunks = stats_chunks(n);
  const dim3 grid(B * G, nchunks);
  const cudaError_t err = launch_partial_stats(static_cast<const T*>(x), B * G, n,
                                               static_cast<float3*>(partial), stream);
  if (err != cudaSuccess) return err;
  gn_apply<T><<<grid, kStatsThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float3*>(partial), nchunks,
      static_cast<const float*>(scale), static_cast<const float*>(bias), n, L, cpg, G, eps,
      apply_silu, static_cast<T*>(y), static_cast<float2*>(stats));
  return cudaGetLastError();
}

}  // namespace sg

extern "C" {

// x, y: (B, C, L) contiguous, dtype 0 = fp32, 1 = bf16; scale, bias: (C,) fp32;
// stats: (B * G) x (mean, rstd) fp32, written. Returns the cudaError_t of the
// launches (0 = success).
int sg_group_norm_silu(const void* x, const void* scale, const void* bias, void* y,
                       void* stats, void* partial, int B, int C, int L, int G, float eps,
                       int apply_silu, int dtype, void* stream) {
  if (G <= 0 || C % G != 0 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch<float>(x, scale, bias, y, stats, partial, B, C, L, G, eps,
                                  apply_silu, s);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch<__nv_bfloat16>(x, scale, bias, y, stats, partial, B, C, L, G, eps,
                                          apply_silu, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
