// Backward of GroupNorm (+SiLU) over (B, C, L) for Hopper (sm_90a).
//
// Replaces the backward of the Pallas TPU kernel
// sleepgen/pallas_kernels/group_norm.py (fused_group_norm_silu's VJP,
// _fwd/_bwd at lines 221-234, which differentiate the jnp reference), with
// the closed form of sleepgen/nn/fused_norm.py:81-114. Per element, with
// xhat = (x - mean) * rstd and z = xhat * scale + bias:
//   dz    = dy * sigmoid(z) * (1 + z * (1 - sigmoid(z)))   (dy without SiLU)
//   dxhat = dz * scale
//   dx    = rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat))
//   dscale = sum over (B, L) of dz * xhat,  dbias = sum over (B, L) of dz
// where mean_g is the mean over the (C / G) * L elements of the element's
// (batch row, group). mean and rstd are the forward's, written by
// group_norm_silu.cu. Everything is fp32; dx is rounded to x's dtype.
//
// Bound on the card: bytes. The least work reads x and dy once and writes
// dx once (at 3.35 TB/s); the arithmetic is about 20 operations per element.
// Design, three launches, no atomics, so two runs give the same bits:
//  1. gn_bwd_rows: one warp per (b, c) row sums dz and dz * xhat over L.
//     These row sums serve both reductions: the group means are
//     sum_c scale[c] * row / n, and the parameter gradients are sums of rows
//     over the batch. A row is long enough at every shape the models use
//     (L 192 to 3072) to keep a warp busy, and B * C rows fill the card.
//  2. gn_bwd_dx: grid (B * G, chunks of 2048 elements), as K1's apply pass;
//     each block sums its group's cpg row sums (a block reduction), then
//     writes dx for its chunk.
//  3. gn_bwd_params: one thread per (channel, batch slice) adds the row sums
//     over the batch in a fixed order, then a fixed-order sum over slices.
// x and dy are read twice (passes 1 and 2), so the kernel moves about 5/3
// of the bound's bytes: simple first.
#include "gn_stats.cuh"

namespace sg {

constexpr int kBwdThreads = 256;
constexpr int kRowsPerBlock = kBwdThreads / 32;
constexpr int kParamSlices = 8;  // batch slices per channel in pass 3

// Gradient at the affine output z, through SiLU when apply_silu.
__device__ __forceinline__ float grad_z(float dy, float z, int apply_silu) {
  if (!apply_silu) return dy;
  const float s = 1.f / (1.f + expf(-z));
  return dy * s * (1.f + z * (1.f - s));
}

// grid ceil(B * C / kRowsPerBlock), kBwdThreads threads; warp w handles row
// r = blockIdx.x * kRowsPerBlock + w, that is (b, c) = (r / C, r % C), and
// writes row_sums[r] = (sum dz, sum dz * xhat).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
gn_bwd_rows(const T* __restrict__ x, const T* __restrict__ dy, const float2* __restrict__ stats,
            const float* __restrict__ scale, const float* __restrict__ bias, int64_t rows, int C,
            int L, int cpg, int apply_silu, float2* __restrict__ row_sums) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // warp-uniform
  const int c = (int)(r % C);
  const float2 st = stats[(r / C) * (C / cpg) + c / cpg];
  const float sc = scale[c], bi = bias[c];
  const T* xr = x + r * L;
  const T* dr = dy + r * L;
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < L; i += 32) {
    const float xh = (to_f(xr[i]) - st.x) * st.y;
    const float dz = grad_z(to_f(dr[i]), xh * sc + bi, apply_silu);
    s1 += dz;
    s2 += dz * xh;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) row_sums[r] = make_float2(s1, s2);
}

// grid (B * G, nchunks), kStatsThreads threads: block writes dx for chunk
// blockIdx.y of group blockIdx.x (n = cpg * L elements per group).
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy, const float2* __restrict__ stats,
          const float* __restrict__ scale, const float* __restrict__ bias,
          const float2* __restrict__ row_sums, int n, int C, int L, int cpg, int G,
          int apply_silu, T* __restrict__ dx) {
  __shared__ float red[33];
  const int64_t bg = blockIdx.x;
  const int c0 = (int)(bg % G) * cpg;
  const float2* rs = row_sums + (bg / G) * C + c0;
  float a1 = 0.f, a2 = 0.f;
  for (int j = threadIdx.x; j < cpg; j += kStatsThreads) {
    const float sc = scale[c0 + j];
    a1 += sc * rs[j].x;
    a2 += sc * rs[j].y;
  }
  const float m1 = block_sum(a1, red) / n;  // mean_g(dxhat)
  const float m2 = block_sum(a2, red) / n;  // mean_g(dxhat * xhat)
  const float2 st = stats[bg];
  const int start = blockIdx.y * kStatsChunk;
  const int cnt = min(kStatsChunk, n - start);
  const T* xg = x + bg * n + start;
  const T* dg = dy + bg * n + start;
  T* og = dx + bg * n + start;
  for (int i = threadIdx.x; i < cnt; i += kStatsThreads) {
    const int c = c0 + (start + i) / L;
    const float xh = (to_f(xg[i]) - st.x) * st.y;
    const float dxh = grad_z(to_f(dg[i]), xh * scale[c] + bias[c], apply_silu) * scale[c];
    og[i] = from_f<T>(st.y * (dxh - m1 - xh * m2));
  }
}

// grid ceil(C / 32), block (32, kParamSlices): dbias[c] and dscale[c] are the
// sums over b of row_sums[b * C + c], in a fixed order.
__global__ void __launch_bounds__(32 * kParamSlices)
gn_bwd_params(const float2* __restrict__ row_sums, int B, int C, float* __restrict__ dscale,
              float* __restrict__ dbias) {
  __shared__ float2 part[kParamSlices][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    for (int b = threadIdx.y; b < B; b += kParamSlices) {
      const float2 v = row_sums[(int64_t)b * C + c];
      s1 += v.x;
      s2 += v.y;
    }
  }
  part[threadIdx.y][threadIdx.x] = make_float2(s1, s2);
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < kParamSlices; ++k) {
      t1 += part[k][threadIdx.x].x;
      t2 += part[k][threadIdx.x].y;
    }
    dbias[c] = t1;
    dscale[c] = t2;
  }
}

template <typename T>
static cudaError_t launch_bwd(const void* x, const void* dy, const void* stats, const void* scale,
                              const void* bias, void* dx, void* dscale, void* dbias,
                              void* row_sums, int B, int C, int L, int G, int apply_silu,
                              cudaStream_t stream) {
  const int cpg = C / G;
  const int n = cpg * L;
  const int64_t rows = (int64_t)B * C;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float2* st = static_cast<const float2*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float2* rs = static_cast<float2*>(row_sums);
  gn_bwd_rows<T><<<(unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock), kBwdThreads, 0,
                   stream>>>(xt, dyt, st, sc, bi, rows, C, L, cpg, apply_silu, rs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_dx<T><<<dim3(B * G, stats_chunks(n)), kStatsThreads, 0, stream>>>(
      xt, dyt, st, sc, bi, rs, n, C, L, cpg, G, apply_silu, static_cast<T*>(dx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_params<<<(C + 31) / 32, dim3(32, kParamSlices), 0, stream>>>(
      rs, B, C, static_cast<float*>(dscale), static_cast<float*>(dbias));
  return cudaGetLastError();
}

}  // namespace sg

extern "C" {

// x, dy, dx: (B, C, L) contiguous, dtype 0 = fp32, 1 = bf16; stats: (B * G) x
// (mean, rstd) fp32 from sg_group_norm_silu; scale, bias, dscale, dbias: (C,)
// fp32; row_sums: 2 * B * C floats of scratch. Returns the cudaError_t of the
// launches (0 = success).
int sg_group_norm_silu_bwd(const void* x, const void* dy, const void* stats, const void* scale,
                           const void* bias, void* dx, void* dscale, void* dbias,
                           void* row_sums, int B, int C, int L, int G, int apply_silu, int dtype,
                           void* stream) {
  if (G <= 0 || C % G != 0 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch_bwd<float>(x, dy, stats, scale, bias, dx, dscale, dbias, row_sums, B,
                                      C, L, G, apply_silu, s);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch_bwd<__nv_bfloat16>(x, dy, stats, scale, bias, dx, dscale, dbias,
                                              row_sums, B, C, L, G, apply_silu, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
