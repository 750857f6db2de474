// The DiT's pass between two half-blocks for Hopper (sm_90a): K4.
//
// Replaces no TPU kernel: the JAX package has no DiT. It was added because
// at each boundary between half-blocks of sleepgen_torch/nn/dit.py the
// composed PyTorch ops (the gated residual addcmul, LayerNorm, the adaLN
// addcmul and the cast to the compute dtype) made four passes over the fp32
// residual stream, each re-reading what the one before had written.
//
// For every token row r of the stream x (rows = B T, D wide, contiguous fp32),
// with b = r / T the row's batch index:
//
//   x_new = x + gate[b] h                      (only when a branch is pending)
//   n     = (x_new - mean) rsqrt(var + 1e-6)   LayerNorm over D: no affine,
//                                              biased variance, fp32
//   y     = T(shift[b] + n (1 + scale[b]))     T the compute dtype (fp32, bf16)
//
// x_new is written into x_out (the stream itself, in place) unless x_out is
// null: the final layer needs only y. h (rows, D) is the pending branch's
// output and y (rows, D) the next GEMM's input, both in T. shift and scale
// are (B, D) rows of an adaLN projection's (B, k D) output in T, taken where
// they lie with a row stride of mod_stride elements, no copy; gate likewise
// with gate_stride (the final layer's shift and scale come from its own
// projection, the gate from the last block's).
//
// Bound on the card: bytes. At the DiT-XL/2 cell's shape (49,152 rows of
// 1152, bf16) the least work reads x and h and writes x_new and y once:
// 679 MB, 0.203 ms at 3.35 TB/s, against a few operations per element. The
// composed ops moved 1.81 GB for the same result.
//
// Design: one warp per row, kWarps rows a block. Lane l holds the float4s
// l, l + 32, ... of the row (D / 4 of them; kVecs = ceil(D / 128) a lane,
// so D up to 2048) in registers: x by 16-byte loads, h, gate, shift and
// scale by 8-byte loads in bf16 (16-byte in fp32), neighbouring lanes on
// neighbouring addresses. x_new = fma(gate, h, x) stays in registers; the
// mean, then the sum of squared deviations from it (exact two-pass fp32
// statistics), are warp sums by xor shuffles, so every lane holds the same
// bits and nothing goes through shared memory. y is written with the same
// vector widths; x_new by 16-byte stores after every load of the row, so
// the pass may write in place. gate, shift and scale go through the
// read-only path: every row of a batch reads the same (B, D) rows, which
// stay in L1 and L2. Nothing is allocated, nothing synchronises, and the
// launcher returns the launch's error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sg {
namespace adaln {

constexpr int kWarps = 8;     // rows a block
constexpr int kMaxVecs = 16;  // float4s a lane: D up to 32 * 4 * kMaxVecs = 2048
constexpr float kEps = 1e-6f;  // the DiT's LayerNorm (LN_EPS in kernels/adaln.py)

// Four T's as one vector: a float4 for fp32, a uint2 for bf16.
template <typename T> struct Quad;
template <> struct Quad<float> {
  using type = float4;
  static __device__ __forceinline__ void unpack(const float4& v, float f[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ float4 pack(const float f[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Quad<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ void unpack(const uint2& v, float f[4]) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  static __device__ __forceinline__ uint2 pack(const float f[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);  // round to nearest even
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};

template <typename T>
__device__ __forceinline__ void load4(const T* p, float f[4]) {
  Quad<T>::unpack(*reinterpret_cast<const typename Quad<T>::type*>(p), f);
}

template <typename T>
__device__ __forceinline__ void load4_ro(const T* p, float f[4]) {
  Quad<T>::unpack(__ldg(reinterpret_cast<const typename Quad<T>::type*>(p)), f);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float f[4]) {
  *reinterpret_cast<typename Quad<T>::type*>(p) = Quad<T>::pack(f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid ceil(rows / kWarps), kWarps * 32 threads. Warp w of block i takes row
// i kWarps + w. x and x_out may be the same tensor.
template <typename T, int kVecs, bool kPending>
__global__ void __launch_bounds__(kWarps * 32)
adaln_modulate(const float* x, float* x_out, const T* __restrict__ h,
               const T* __restrict__ gate, const T* __restrict__ shift,
               const T* __restrict__ scale, T* __restrict__ y, int rows, int tokens, int D,
               int mod_stride, int gate_stride) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps: the shuffles below see all 32 lanes
  const int64_t base = (int64_t)row * D;
  const int64_t batch = row / tokens;
  const int64_t mod = batch * mod_stride, gmod = batch * gate_stride;
  float v[kVecs][4];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int e = 4 * (k * 32 + lane);
    if (k < kVecs - 1 || e < D) {  // only the last vector of a lane can lie past D
      const float4 xv = *reinterpret_cast<const float4*>(x + base + e);
      v[k][0] = xv.x; v[k][1] = xv.y; v[k][2] = xv.z; v[k][3] = xv.w;
      if constexpr (kPending) {
        float hv[4], g[4];
        load4(h + base + e, hv);
        load4_ro(gate + gmod + e, g);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] = fmaf(g[j], hv[j], v[k][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s += v[k][j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = 0.f;
    }
  }
  const float mean = warp_sum(s) / D;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (k < kVecs - 1 || 4 * (k * 32 + lane) < D) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = v[k][j] - mean;
        m2 += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(m2) / D + kEps);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int e = 4 * (k * 32 + lane);
    if (k == kVecs - 1 && e >= D) break;
    if (kPending && x_out != nullptr)
      *reinterpret_cast<float4*>(x_out + base + e) =
          make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    float sh[4], sc[4], f[4];
    load4_ro(shift + mod + e, sh);
    load4_ro(scale + mod + e, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = fmaf((v[k][j] - mean) * rstd, 1.f + sc[j], sh[j]);
    store4(y + base + e, f);
  }
}

template <typename T, int kVecs>
static cudaError_t launch_vecs(const float* x, float* x_out, const T* h, const T* gate,
                               const T* shift, const T* scale, T* y, int rows, int tokens,
                               int D, int mod_stride, int gate_stride,
                               cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  if (h != nullptr)
    adaln_modulate<T, kVecs, true><<<grid, kWarps * 32, 0, stream>>>(
        x, x_out, h, gate, shift, scale, y, rows, tokens, D, mod_stride, gate_stride);
  else
    adaln_modulate<T, kVecs, false><<<grid, kWarps * 32, 0, stream>>>(
        x, nullptr, nullptr, nullptr, shift, scale, y, rows, tokens, D, mod_stride, 0);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* x, void* x_out, const void* h, const void* gate,
                          const void* shift, const void* scale, void* y, int rows, int tokens,
                          int D, int mod_stride, int gate_stride,
                          cudaStream_t stream) {
  const auto* xf = static_cast<const float*>(x);
  auto* xo = static_cast<float*>(x_out);
  const auto* ht = static_cast<const T*>(h);
  const auto* gt = static_cast<const T*>(gate);
  const auto* st = static_cast<const T*>(shift);
  const auto* ct = static_cast<const T*>(scale);
  auto* yt = static_cast<T*>(y);
#define SG_ADALN_CASE(V)                                                                  \
  case V:                                                                                 \
    return launch_vecs<T, V>(xf, xo, ht, gt, st, ct, yt, rows, tokens, D, mod_stride,      \
                             gate_stride, stream);
  switch ((D + 127) / 128) {
    SG_ADALN_CASE(1) SG_ADALN_CASE(2) SG_ADALN_CASE(3) SG_ADALN_CASE(4)
    SG_ADALN_CASE(5) SG_ADALN_CASE(6) SG_ADALN_CASE(7) SG_ADALN_CASE(8)
    SG_ADALN_CASE(9) SG_ADALN_CASE(10) SG_ADALN_CASE(11) SG_ADALN_CASE(12)
    SG_ADALN_CASE(13) SG_ADALN_CASE(14) SG_ADALN_CASE(15) SG_ADALN_CASE(16)
  }
#undef SG_ADALN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace adaln
}  // namespace sg

extern "C" {

// x: (rows, D) fp32, contiguous, 16-byte aligned; x_out: where x_new goes
// (x itself for the in-place update) or null; h: (rows, D) in dtype, or null
// when no branch is pending (then gate is not read and x_out must be null);
// shift, scale: row b at b * mod_stride elements, gate at b * gate_stride,
// D contiguous, in dtype; y: (rows, D) in dtype, written. dtype 0 = fp32,
// 1 = bf16; the vector loads need D, mod_stride and gate_stride multiples
// of 4 and every base aligned to four elements (16 bytes for x). Returns
// the cudaError_t of the launch (0 = success).
int sg_adaln_modulate(const void* x, void* x_out, const void* h, const void* gate,
                      const void* shift, const void* scale, void* y, int rows, int tokens,
                      int D, int mod_stride, int gate_stride, int dtype,
                      void* stream) {
  if (rows <= 0 || tokens <= 0 || D <= 0 || D % 4 != 0 || D > 32 * 4 * sg::adaln::kMaxVecs ||
      mod_stride % 4 != 0 || gate_stride % 4 != 0 || (h != nullptr && gate == nullptr) ||
      (h == nullptr && x_out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)sg::adaln::launch<float>(x, x_out, h, gate, shift, scale, y, rows, tokens, D,
                                         mod_stride, gate_stride, s);
  if (dtype == 1)
    return (int)sg::adaln::launch<__nv_bfloat16>(x, x_out, h, gate, shift, scale, y, rows,
                                                 tokens, D, mod_stride, gate_stride, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
