// One block per GroupNorm group, the group held in registers: the pieces
// that K1 (group_norm_silu.cu) and K3 (group_norm_silu_bwd.cu) share.
//
// A group (b, g) of x (B, C, L) is one contiguous run of n = (C / G) * L
// elements. When n <= kOnChipMax a block of OnChip<T>::kThreads threads
// loads the whole group once, as 16-byte vectors (8 bf16 or 4 fp32; vector
// v covers elements [v * kVec, v * kVec + kVec), and thread t holds the
// vectors v = k * kThreads + t for k < kVPT), and keeps it in registers in
// its storage dtype: at most kMaxVecs vectors, 24 registers, a thread.
// Every stage-2 GroupNorm (G 32, n <= 9216) fits. Rows with L % kVec != 0
// or bases that are not 16-byte aligned ("ragged") load and store element
// by element into the same register layout.
#pragma once

#include "gn_stats.cuh"

namespace sg {

constexpr int kOnChipMax = 12288;
constexpr int kMaxVecs = 6;

template <typename T>
struct OnChip {
  static constexpr int kVec = 16 / (int)sizeof(T);                  // elements per vector
  static constexpr int kThreads = kOnChipMax / (kVec * kMaxVecs);   // 256 bf16, 512 fp32
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Vectors per thread for a group of n elements (n <= kOnChipMax).
template <typename T>
inline int vecs_per_thread(int n) {
  const int per_pass = OnChip<T>::kThreads * OnChip<T>::kVec;
  return (n + per_pass - 1) / per_pass;
}

// SiLU and the sigmoid with the hardware exponential and reciprocal
// (ex2.approx, rcp.approx: two MUFU instructions and two FP32 ones): a few
// ulp of fp32 (|v| < 20: under 3e-6 relative), inside the fp32 bounds, for
// a small part of the instructions of expf and an IEEE division.
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sigmoid_fast(float v) { return rcp_approx(1.f + __expf(-v)); }
__device__ __forceinline__ float silu_fast(float v) { return v * sigmoid_fast(v); }

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Element j of a 16-byte vector, in fp32 (j a compile-time constant after unrolling).
template <typename T> __device__ __forceinline__ float elem(const uint4& r, int j);
template <> __device__ __forceinline__ float elem<float>(const uint4& r, int j) {
  return __uint_as_float(word(r, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int j) {
  const uint32_t w = word(r, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T> __device__ __forceinline__ uint32_t bits(T v);
template <> __device__ __forceinline__ uint32_t bits<float>(float v) { return __float_as_uint(v); }
template <> __device__ __forceinline__ uint32_t bits<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// fp32 values f[0 .. kVec) rounded to T and packed into 16 bytes.
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // .x low
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The vector at element e of p (e a multiple of kVec), zero past n.
template <typename T, bool kAligned>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p, int e, int n) {
  constexpr int kVec = OnChip<T>::kVec;
  if constexpr (kAligned) {
    return e < n ? *reinterpret_cast<const uint4*>(p + e) : make_uint4(0, 0, 0, 0);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t b = e + j < n ? bits<T>(p[e + j]) : 0u;
      if constexpr (kVec == 4) w[j] = b;
      else w[j >> 1] |= (j & 1) ? (b << 16) : b;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Store kVec fp32 values at element e of p (in range as a whole when
// aligned; element by element up to n when not).
template <typename T, bool kAligned>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int e, int n, const float* f) {
  constexpr int kVec = OnChip<T>::kVec;
  if constexpr (kAligned) {
    *reinterpret_cast<uint4*>(p + e) = pack<T>(f);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (e + j < n) p[e + j] = from_f<T>(f[j]);
  }
}

}  // namespace sg
