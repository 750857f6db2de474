// GroupNorm -> SiLU -> Conv1d(k=3, SAME padding) + bias over (B, C, L), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sleepgen/pallas_kernels/fused_resblock.py
// (fused_gn_silu_conv3_tiled -> _kernel_tiled; fused_gn_silu_conv3 ->
// _kernel computes the same function): fp32 group statistics, normalise,
// affine, SiLU, round h to the working dtype, then the k = 3 convolution
// with fp32 accumulation plus the bias, output in the working dtype.
// Weights come in torch's (C_out, C_in, 3) layout.
//
// Bound on the card: operations. A chain does 3 * C_in * C_out * L
// multiply-adds per batch row; at the UNet's widths that is far above the
// 295 operations per byte where the bf16 tensor cores stop waiting for
// memory. The TPU kernel keeps one batch row's (L, C) slice in VMEM and
// runs three shifted matmuls; here the GroupNorm statistics come from the
// shared split reduction (gn_stats.cuh) and a tiled convolution kernel
// applies normalise, affine and SiLU while it stages its input tile in
// shared memory, so h never goes to device memory.
//
// Convolution kernels: one block owns a (TCO output channels x TL
// positions) tile of one batch row. For each chunk of TCI input channels
// it stages h[ci][l0 - 1 .. l0 + TL] (zeros outside [0, L): SAME padding
// of h) and the weights w[co][ci][0..2], then sums the chunk's channels
// and the three taps into one fp32 accumulator.
//  * bf16 (the sampler's dtype): tensor cores through WMMA (mma.sync),
//    16 x 16 x 16 bf16 products with fp32 accumulation. The three taps are
//    three shifted copies of the h tile, so every fragment load stays
//    32-byte aligned; each warp owns a 32 x 32 output tile.
//  * fp32: the fp32 FMA units, a 4 x 4 register tile per thread.
// Both stage synchronously (no copy/compute overlap) and use mma.sync
// rather than Hopper's wgmma and TMA: simple first, fast later.
#include <mma.h>

#include <type_traits>

#include "gn_stats.cuh"

namespace sg {

constexpr int kConvThreads = 256;

// One element of h = SiLU(GN(x)) rounded to T, or 0 outside the row.
template <typename T>
__device__ __forceinline__ float h_value(const T* __restrict__ xb, int ci, int l, int Cin, int L,
                                         int cpg, const float* mean_s, const float* rstd_s,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias) {
  if (ci >= Cin || l < 0 || l >= L) return 0.f;
  const int g = ci / cpg;
  const float v = (to_f(xb[(int64_t)ci * L + l]) - mean_s[g]) * rstd_s[g] * scale[ci] + bias[ci];
  return to_f(from_f<T>(silu(v)));
}

// -- fp32: FMA units ------------------------------------------------------------

constexpr int kTCO = 64;   // output channels per block
constexpr int kTL = 64;    // positions per block
constexpr int kTCI = 16;   // input channels per shared-memory stage

__global__ void __launch_bounds__(kConvThreads)
gn_silu_conv3_fma(const float* __restrict__ x, const float3* __restrict__ partial,
                  int nchunks, const float* __restrict__ scale, const float* __restrict__ bias,
                  const float* __restrict__ w, const float* __restrict__ b,
                  float* __restrict__ y, int Cin, int Cout, int L, int G, float eps) {
  __shared__ float hs[kTCI][kTL + 2];
  __shared__ __align__(16) float ws[kTCI][3][kTCO];
  __shared__ float mean_s[kMaxGroups], rstd_s[kMaxGroups];

  const int l0 = blockIdx.x * kTL;
  const int co0 = blockIdx.y * kTCO;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // positions tx + 16 j
  const int ty = tid >> 4;  // output channels 4 ty + i

  for (int g = tid; g < G; g += kConvThreads)
    merge_group(partial + ((int64_t)bi * G + g) * nchunks, nchunks, eps, &mean_s[g], &rstd_s[g]);
  __syncthreads();

  const int cpg = Cin / G;
  const float* xb = x + (int64_t)bi * Cin * L;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kTCI) {
    for (int i = tid; i < kTCI * (kTL + 2); i += kConvThreads) {
      const int cl = i / (kTL + 2), p = i % (kTL + 2);
      hs[cl][p] = h_value(xb, ci0 + cl, l0 - 1 + p, Cin, L, cpg, mean_s, rstd_s, scale, bias);
    }
    for (int i = tid; i < kTCO * kTCI * 3; i += kConvThreads) {
      const int col = i / (kTCI * 3), r = i % (kTCI * 3);
      const int cl = r / 3, k = r % 3;
      const int co = co0 + col, ci = ci0 + cl;
      ws[cl][k][col] = (co < Cout && ci < Cin) ? w[((int64_t)co * Cin + ci) * 3 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cl = 0; cl < kTCI; ++cl) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[cl][k][ty * 4]);
        float hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[cl][tx + 16 * j + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] = fmaf(wv.x, hv[j], acc[0][j]);
          acc[1][j] = fmaf(wv.y, hv[j], acc[1][j]);
          acc[2][j] = fmaf(wv.z, hv[j], acc[2][j]);
          acc[3][j] = fmaf(wv.w, hv[j], acc[3][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= Cout) continue;
    float* yrow = y + ((int64_t)bi * Cout + co) * L;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + tx + 16 * j;
      if (l < L) yrow[l] = acc[i][j] + b[co];
    }
  }
}

// -- bf16: tensor cores (WMMA) -----------------------------------------------------

namespace tc {
constexpr int TCO = 128;        // output channels per block (8 warps: 4 x 2 of 32 x 32)
constexpr int TL = 64;          // positions per block
constexpr int TCI = 32;         // input channels per stage (two k-steps of 16)
constexpr int LDA = TCI + 8;    // bf16 row pitch of the weight tiles
constexpr int LDB = TL + 8;     // bf16 row pitch of the h tiles
constexpr int LDC = TL + 4;     // fp32 row pitch of the output tile
constexpr int A_BYTES = 3 * TCO * LDA * 2;
constexpr int B_BYTES = 3 * TCI * LDB * 2;
constexpr int C_BYTES = TCO * LDC * 4;
constexpr int SMEM_BYTES = A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
}  // namespace tc

__global__ void __launch_bounds__(kConvThreads)
gn_silu_conv3_wmma(const __nv_bfloat16* __restrict__ x, const float3* __restrict__ partial,
                   int nchunks, const float* __restrict__ scale, const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ b,
                   __nv_bfloat16* __restrict__ y, int Cin, int Cout, int L, int G, float eps) {
  using namespace nvcuda;
  using namespace tc;
  // ws[k][co][ci] = w[co0 + co][ci0 + ci][k]; hs[k][ci][l] = h[ci0 + ci][l0 + l + k - 1];
  // after the last stage the same bytes hold the fp32 output tile cs[co][l].
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float mean_s[kMaxGroups], rstd_s[kMaxGroups];
  auto ws = reinterpret_cast<__nv_bfloat16 (*)[TCO][LDA]>(smem);
  auto hs = reinterpret_cast<__nv_bfloat16 (*)[TCI][LDB]>(smem + A_BYTES);
  auto cs = reinterpret_cast<float (*)[LDC]>(smem);
  const int l0 = blockIdx.x * TL;
  const int co0 = blockIdx.y * TCO;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wco = (warp >> 1) * 32;  // warp's output channels
  const int wl = (warp & 1) * 32;    // warp's positions

  for (int g = tid; g < G; g += kConvThreads)
    merge_group(partial + ((int64_t)bi * G + g) * nchunks, nchunks, eps, &mean_s[g], &rstd_s[g]);
  __syncthreads();

  const int cpg = Cin / G;
  const __nv_bfloat16* xb = x + (int64_t)bi * Cin * L;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int ci0 = 0; ci0 < Cin; ci0 += TCI) {
    for (int i = tid; i < TCI * (TL + 2); i += kConvThreads) {
      const int cl = i / (TL + 2), p = i % (TL + 2);
      const __nv_bfloat16 v = __float2bfloat16(
          h_value(xb, ci0 + cl, l0 - 1 + p, Cin, L, cpg, mean_s, rstd_s, scale, bias));
      if (p < TL) hs[0][cl][p] = v;
      if (p >= 1 && p <= TL) hs[1][cl][p - 1] = v;
      if (p >= 2) hs[2][cl][p - 2] = v;
    }
    for (int i = tid; i < TCO * TCI * 3; i += kConvThreads) {
      const int col = i / (TCI * 3), r = i % (TCI * 3);
      const int cl = r / 3, k = r % 3;
      const int co = co0 + col, ci = ci0 + cl;
      ws[k][col][cl] = (co < Cout && ci < Cin) ? w[((int64_t)co * Cin + ci) * 3 + k]
                                               : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int kk = 0; kk < TCI; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &ws[k][wco + 16 * i][kk], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &hs[k][kk][wl + 16 * j], LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wco + 16 * i][wl + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TCO * TL; i += kConvThreads) {
    const int row = i / TL, col = i % TL;
    const int co = co0 + row, l = l0 + col;
    if (co < Cout && l < L)
      y[((int64_t)bi * Cout + co) * L + l] = __float2bfloat16(cs[row][col] + __bfloat162float(b[co]));
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* scale, const void* bias, const void* w,
                          const void* b, void* y, void* partial, int B, int Cin, int Cout, int L,
                          int G, float eps, cudaStream_t stream) {
  const int n = (Cin / G) * L;
  const int nchunks = stats_chunks(n);
  const cudaError_t err = launch_partial_stats(static_cast<const T*>(x), B * G, n,
                                               static_cast<float3*>(partial), stream);
  if (err != cudaSuccess) return err;
  const float3* part = static_cast<const float3*>(partial);
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((L + kTL - 1) / kTL, (Cout + kTCO - 1) / kTCO, B);
    gn_silu_conv3_fma<<<grid, kConvThreads, 0, stream>>>(
        static_cast<const float*>(x), part, nchunks, sc, bs, static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), Cin, Cout, L, G, eps);
  } else {
    const dim3 grid((L + tc::TL - 1) / tc::TL, (Cout + tc::TCO - 1) / tc::TCO, B);
    gn_silu_conv3_wmma<<<grid, kConvThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, nchunks, sc, bs,
        static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(y), Cin, Cout, L, G, eps);
  }
  return cudaGetLastError();
}

}  // namespace sg

extern "C" {

// x: (B, Cin, L), w: (Cout, Cin, 3), b: (Cout,), y: (B, Cout, L), all
// contiguous in one dtype (0 = fp32, 1 = bf16); scale, bias: (Cin,) fp32.
// Returns the cudaError_t of the launches (0 = success).
int sg_gn_silu_conv3(const void* x, const void* scale, const void* bias, const void* w,
                     const void* b, void* y, void* partial, int B, int Cin, int Cout, int L,
                     int G, float eps, int dtype, void* stream) {
  if (G <= 0 || G > sg::kMaxGroups || Cin % G != 0 || B <= 0 || L <= 0 || Cout <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch<float>(x, scale, bias, w, b, y, partial, B, Cin, Cout, L, G, eps, s);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch<__nv_bfloat16>(x, scale, bias, w, b, y, partial, B, Cin, Cout, L, G,
                                          eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
