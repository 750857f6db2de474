// Pass 1 of the group statistics (see gn_stats.cuh), and the C entry points
// that both kernels' wrappers share: the scratch size of the partial
// statistics and the text of a CUDA error.
#include "gn_stats.cuh"

namespace sg {

// grid (groups, nchunks), kStatsThreads threads; partial[group * nchunks + chunk].
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_partial_stats(const T* __restrict__ x, int n, int nchunks, float3* __restrict__ partial) {
  __shared__ float red[33];
  const int64_t bg = blockIdx.x;
  const int start = blockIdx.y * kStatsChunk;
  const int cnt = min(kStatsChunk, n - start);
  const T* xg = x + bg * n + start;
  float v[kStatsPerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kStatsPerThread; ++i) {
    const int idx = i * kStatsThreads + threadIdx.x;
    v[i] = idx < cnt ? to_f(xg[idx]) : 0.f;
    s += v[i];
  }
  const float mean = block_sum(s, red) / cnt;
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < kStatsPerThread; ++i) {
    const int idx = i * kStatsThreads + threadIdx.x;
    const float d = v[i] - mean;
    m2 += idx < cnt ? d * d : 0.f;
  }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) partial[bg * nchunks + blockIdx.y] = make_float3((float)cnt, mean, m2);
}

template <typename T>
cudaError_t launch_partial_stats(const T* x, int groups, int n, float3* partial,
                                 cudaStream_t stream) {
  const int nchunks = stats_chunks(n);
  gn_partial_stats<T><<<dim3(groups, nchunks), kStatsThreads, 0, stream>>>(x, n, nchunks,
                                                                          partial);
  return cudaGetLastError();
}

template cudaError_t launch_partial_stats<float>(const float*, int, int, float3*, cudaStream_t);
template cudaError_t launch_partial_stats<__nv_bfloat16>(const __nv_bfloat16*, int, int,
                                                         float3*, cudaStream_t);

}  // namespace sg

extern "C" {

// Floats of scratch the wrapper allocates for the partial statistics.
int sg_gn_scratch_floats(int B, int C, int L, int G) {
  return 3 * B * G * sg::stats_chunks((C / G) * L);
}

const char* sg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
