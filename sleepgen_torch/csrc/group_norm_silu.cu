// GroupNorm (+SiLU) over (B, C, L) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sleepgen/pallas_kernels/group_norm.py
// (fused_group_norm_silu -> _pallas_forward -> _kernel): fp32 statistics
// per (batch row, group), normalise, per-channel affine, optional SiLU,
// output in the input's dtype (fp32 or bf16). Every launch also writes
// each group's (mean, rstd), which the backward (group_norm_silu_bwd.cu)
// reads back instead of computing them again.
//
// Bound on the card: bytes. The least work reads x once and writes y once
// (at 3.35 TB/s); the arithmetic is a few operations per element.
//
// On-chip path, every group of n <= kOnChipMax elements (gn_group.cuh;
// every stage-2 GroupNorm): the TPU kernel's own formulation (the whole
// slice resident, statistics, then apply), scaled from a (L, C) row to one
// group. One block per group loads it once with 16-byte vectors and keeps
// it in registers; exact two-pass fp32 statistics (the sum, then the sum
// of squared deviations) from those registers with fixed-order block
// reductions; per channel a_c = rstd * scale_c into shared memory beside
// bias_c, so that with L % kVec == 0 (a vector inside one channel row) an
// element costs a subtraction, one FMA, y = (x - mean) a_c + bias_c, and
// the SiLU (silu_fast, gn_group.cuh: ex2.approx and rcp.approx); 16-byte
// stores. x is read once and y written once, the bound's bytes, in one
// launch with no scratch. (x - mean) a_c + bias_c rather than x a_c + d_c
// keeps the reference's rounding when |mean| is large against the spread.
//
// Cluster form, aligned groups of kOnChipMax < n <= kClusterMax elements
// (gn_cluster.cuh; every stage-1 GroupNorm at G 1, 24,576-98,304 elements,
// the DM's and the long window's G 32 groups of 18,432-49,152 and the
// attention AEKL's 49,152): one launch of cs = ceil(n / kOnChipMax) blocks
// per group as one thread-block cluster. Each block loads its slice of the
// group once into registers, in the on-chip path's layout; the statistics
// are the same exact two-pass ones, each block's sum exchanged through
// distributed shared memory and added in rank order (cluster_sums), then
// the same for the squared deviations; rank 0 writes (mean, rstd); each
// block applies the affine (and SiLU) from its registers with 16-byte
// stores. x is read once and y written once, with no scratch.
//
// Streaming path, what is left: groups above kClusterMax (B2's long window
// at G 1, the long-window AEKL decode) and ragged or unaligned groups above
// kOnChipMax, three launches: the split reduction of gn_stats.cuh (pass 1,
// one block per 2048-element chunk: (count, mean, M2)); gn_finalize, one
// warp per group merging its chunks with Chan's formula in a fixed tree
// order and writing (mean, rstd); gn_apply, one block per chunk, which
// reads those two floats and normalises with 16-byte vectors. The merge
// runs once per group, so its work grows with the chunk count, not with
// its square as a merge in every block would. x is read twice on this
// path: such groups do not stay in the 50 MB L2 between the passes.
//
// The launcher reports the form it took (Form, gn_cluster.cuh); the rule
// is the group's size, L and the bases' alignment, nothing else.
#include "gn_cluster.cuh"

namespace sg {

// grid B * G, OnChip<T>::kThreads threads; dynamic shared memory cpg
// float2 when kAligned. Block bg normalises group bg; stats[bg] = (mean, rstd).
template <typename T, int kVPT, bool kAligned>
__global__ void __launch_bounds__(OnChip<T>::kThreads)
gn_fwd_on_chip(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, int n, int L, int cpg, int G, float eps,
               int apply_silu, T* __restrict__ y, float2* __restrict__ stats) {
  constexpr int kVec = OnChip<T>::kVec, kThreads = OnChip<T>::kThreads;
  extern __shared__ float2 affine[];  // (rstd * scale_c, bias_c) per channel of the group
  __shared__ float red[33];
  const int64_t bg = blockIdx.x;
  const T* xg = x + bg * n;
  uint4 r[kVPT];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    r[k] = load_vec<T, kAligned>(xg, (k * kThreads + threadIdx.x) * kVec, n);  // 0 past n
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += elem<T>(r[k], j);
  }
  const float mean = block_sum(s, red) / n;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    const int e = (k * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = elem<T>(r[k], j) - mean;
      m2 += (k < kVPT - 1 || e + j < n) ? d * d : 0.f;
    }
  }
  const float rstd = rsqrtf(block_sum(m2, red) / n + eps);
  if (threadIdx.x == 0) stats[bg] = make_float2(mean, rstd);
  const int c0 = (int)(bg % G) * cpg;
  if constexpr (kAligned) {
    for (int c = threadIdx.x; c < cpg; c += kThreads)
      affine[c] = make_float2(rstd * scale[c0 + c], bias[c0 + c]);
    __syncthreads();
  }
  T* yg = y + bg * n;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    const int e = (k * kThreads + threadIdx.x) * kVec;
    if (k == kVPT - 1 && e >= n) break;
    float f[kVec];
    if constexpr (kAligned) {
      const float2 ad = affine[e / L];
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = fmaf(elem<T>(r[k], j) - mean, ad.x, ad.y);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = c0 + min(e + j, n - 1) / L;
        f[j] = (elem<T>(r[k], j) - mean) * rstd * scale[c] + bias[c];
      }
    }
    if (apply_silu) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = silu_fast(f[j]);
    }
    store_vec<T, kAligned>(yg, e, n, f);
  }
}

template <typename T, int kVPT>
static cudaError_t launch_on_chip(const T* x, const float* scale, const float* bias, T* y,
                                  float2* stats, int B, int L, int cpg, int G, float eps,
                                  int apply_silu, cudaStream_t stream) {
  constexpr int kVec = OnChip<T>::kVec, kThreads = OnChip<T>::kThreads;
  const int n = cpg * L;
  if (L % kVec == 0 && aligned16(x) && aligned16(y))
    gn_fwd_on_chip<T, kVPT, true><<<B * G, kThreads, cpg * sizeof(float2), stream>>>(
        x, scale, bias, n, L, cpg, G, eps, apply_silu, y, stats);
  else
    gn_fwd_on_chip<T, kVPT, false><<<B * G, kThreads, 0, stream>>>(
        x, scale, bias, n, L, cpg, G, eps, apply_silu, y, stats);
  return cudaGetLastError();
}

// grid B * G * cs as clusters of cs blocks, OnChip<T>::kThreads threads;
// dynamic shared memory one float2 per channel row the block's slice
// touches. Cluster bg normalises group bg; rank 0 writes stats[bg] =
// (mean, rstd).
template <typename T, int kVPT>
__global__ void __launch_bounds__(OnChip<T>::kThreads)
gn_fwd_cluster(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, int n, int L, int cpg, int G, float eps,
               int apply_silu, T* __restrict__ y, float2* __restrict__ stats) {
  constexpr int kVec = OnChip<T>::kVec, kThreads = OnChip<T>::kThreads;
  extern __shared__ float2 affine[];  // (rstd * scale_c, bias_c) per row of the slice
  __shared__ float red[33], slot[2], total[1];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int64_t bg = blockIdx.x / cs;
  const ClusterSlice sl(n / kVec, cs, rank);
  const int e0 = sl.v0 * kVec, m = sl.count * kVec;  // the slice: elements [e0, e0 + m)
  const T* xs = x + bg * n + e0;
  uint4 r[kVPT];
  float v[1] = {0.f};
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    r[k] = load_vec<T, true>(xs, (k * kThreads + threadIdx.x) * kVec, m);  // 0 past m
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[0] += elem<T>(r[k], j);
  }
  cluster_sums<1>(v, red, &slot[0], total, cluster);
  const float mean = v[0] / n;
  v[0] = 0.f;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    if ((k * kThreads + threadIdx.x) * kVec >= m) break;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = elem<T>(r[k], j) - mean;
      v[0] += d * d;
    }
  }
  cluster_sums<1>(v, red, &slot[1], total, cluster);
  const float rstd = rsqrtf(v[0] / n + eps);
  if (rank == 0 && threadIdx.x == 0) stats[bg] = make_float2(mean, rstd);
  const int row0 = e0 / L, rows = (e0 + m - 1) / L - row0 + 1;
  const int c0 = (int)(bg % G) * cpg + row0;
  for (int c = threadIdx.x; c < rows; c += kThreads)
    affine[c] = make_float2(rstd * scale[c0 + c], bias[c0 + c]);
  __syncthreads();
  T* ys = y + bg * n + e0;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    const int e = (k * kThreads + threadIdx.x) * kVec;
    if (e >= m) break;
    const float2 ad = affine[(e0 + e) / L - row0];
    float f[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] = fmaf(elem<T>(r[k], j) - mean, ad.x, ad.y);
    if (apply_silu) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = silu_fast(f[j]);
    }
    store_vec<T, true>(ys, e, m, f);
  }
  cluster.sync();  // the other blocks have read this block's slots
}

template <typename T, int kVPT>
static cudaError_t launch_cluster(const T* x, const float* scale, const float* bias, T* y,
                                  float2* stats, int B, int L, int cpg, int G, float eps,
                                  int apply_silu, cudaStream_t stream) {
  const int n = cpg * L, cs = cluster_blocks(n);
  const int per = ClusterSlice(n / OnChip<T>::kVec, cs, 0).count * OnChip<T>::kVec;
  const size_t smem = (size_t)((per + L - 1) / L + 1) * sizeof(float2);  // rows a slice touches
  return launch_clusters(gn_fwd_cluster<T, kVPT>, B * G, cs, OnChip<T>::kThreads, smem, stream,
                         x, scale, bias, n, L, cpg, G, eps, apply_silu, y, stats);
}

// Chan et al.'s merge of two (count, mean, M2) states; an empty b leaves a
// as it is, an empty a gives b.
__device__ __forceinline__ float3 chan_merge(float3 a, float3 b) {
  const float n = a.x + b.x;
  if (n == 0.f) return a;
  const float w = b.x / n, d = b.y - a.y;
  return make_float3(n, a.y + d * w, a.z + b.z + d * d * a.x * w);
}

constexpr int kFinalizeWarps = 8;

// grid ceil(groups / kFinalizeWarps), 32 * kFinalizeWarps threads: one warp
// per group merges its chunks' states in a fixed order (lane l takes chunks
// l, l + 32, ..., then lane l merges lane l + o for o = 16, 8, 4, 2, 1) and
// writes stats[group] = (mean, rstd).
__global__ void __launch_bounds__(32 * kFinalizeWarps)
gn_finalize(const float3* __restrict__ partial, int groups, int nchunks, float eps,
            float2* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int64_t grp = (int64_t)blockIdx.x * kFinalizeWarps + (threadIdx.x >> 5);
  if (grp >= groups) return;  // warp-uniform
  const float3* p = partial + grp * nchunks;
  float3 s = make_float3(0.f, 0.f, 0.f);
  for (int c = lane; c < nchunks; c += 32) s = chan_merge(s, p[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float3 q = make_float3(__shfl_down_sync(0xffffffffu, s.x, o),
                                 __shfl_down_sync(0xffffffffu, s.y, o),
                                 __shfl_down_sync(0xffffffffu, s.z, o));
    if (lane < o) s = chan_merge(s, q);
  }
  if (lane == 0) stats[grp] = make_float2(s.y, rsqrtf(s.z / s.x + eps));
}

// grid (B * G, nchunks), kStatsThreads threads: block normalises chunk
// blockIdx.y of group blockIdx.x from the group's stats, 16-byte vectors
// when kAligned (a vector then lies in one channel row).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kStatsThreads)
gn_apply(const T* __restrict__ x, const float2* __restrict__ stats,
         const float* __restrict__ scale, const float* __restrict__ bias, int n, int L,
         int cpg, int G, int apply_silu, T* __restrict__ y) {
  constexpr int kVec = OnChip<T>::kVec;
  const int64_t bg = blockIdx.x;
  const float2 st = stats[bg];  // (mean, rstd)
  const int c0 = (int)(bg % G) * cpg;
  const int start = blockIdx.y * kStatsChunk;
  const int cnt = min(kStatsChunk, n - start);
  const T* xg = x + bg * n + start;
  T* yg = y + bg * n + start;
  for (int e = threadIdx.x * kVec; e < cnt; e += kStatsThreads * kVec) {
    const uint4 r = load_vec<T, kAligned>(xg, e, cnt);
    float f[kVec];
    if constexpr (kAligned) {
      const int c = c0 + (start + e) / L;
      const float a = st.y * scale[c], b = bias[c];
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = fmaf(elem<T>(r, j) - st.x, a, b);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = c0 + (start + min(e + j, cnt - 1)) / L;
        f[j] = (elem<T>(r, j) - st.x) * st.y * scale[c] + bias[c];
      }
    }
    if (apply_silu) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = silu_fast(f[j]);
    }
    store_vec<T, kAligned>(yg, e, cnt, f);
  }
}

// K1's form for a group of n = (C / G) * L elements of x into y.
template <typename T>
static int forward_form(const void* x, const void* y, int n, int L) {
  if (n <= kOnChipMax) return kFormOnChip;
  return takes_cluster<T>(n, L, aligned16(x) && aligned16(y)) ? kFormCluster : kFormStreaming;
}

template <typename T>
static cudaError_t launch(const void* xv, const void* scalev, const void* biasv, void* yv,
                          void* statsv, void* partial, int B, int C, int L, int G, float eps,
                          int apply_silu, cudaStream_t stream, int* form) {
  const int cpg = C / G;
  const int n = cpg * L;
  const T* x = static_cast<const T*>(xv);
  const float* scale = static_cast<const float*>(scalev);
  const float* bias = static_cast<const float*>(biasv);
  T* y = static_cast<T*>(yv);
  float2* stats = static_cast<float2*>(statsv);
  *form = forward_form<T>(xv, yv, n, L);
  if (*form == kFormOnChip) {
#define SG_ON_CHIP(V) \
  launch_on_chip<T, V>(x, scale, bias, y, stats, B, L, cpg, G, eps, apply_silu, stream)
    switch (vecs_per_thread<T>(n)) {
      case 1: return SG_ON_CHIP(1);
      case 2: return SG_ON_CHIP(2);
      case 3: return SG_ON_CHIP(3);
      case 4: return SG_ON_CHIP(4);
      case 5: return SG_ON_CHIP(5);
      default: return SG_ON_CHIP(6);
    }
#undef SG_ON_CHIP
  }
  if (*form == kFormCluster) {
#define SG_CLUSTER(V) \
  launch_cluster<T, V>(x, scale, bias, y, stats, B, L, cpg, G, eps, apply_silu, stream)
    const int per = ClusterSlice(n / OnChip<T>::kVec, cluster_blocks(n), 0).count;
    switch (vecs_per_thread<T>(per * OnChip<T>::kVec)) {
      case 1: return SG_CLUSTER(1);
      case 2: return SG_CLUSTER(2);
      case 3: return SG_CLUSTER(3);
      case 4: return SG_CLUSTER(4);
      case 5: return SG_CLUSTER(5);
      default: return SG_CLUSTER(6);
    }
#undef SG_CLUSTER
  }
  if (partial == nullptr) return cudaErrorInvalidValue;
  const int groups = B * G, nchunks = stats_chunks(n);
  float3* part = static_cast<float3*>(partial);
  cudaError_t err = launch_partial_stats(x, groups, n, part, stream);
  if (err != cudaSuccess) return err;
  gn_finalize<<<(groups + kFinalizeWarps - 1) / kFinalizeWarps, 32 * kFinalizeWarps, 0,
                stream>>>(part, groups, nchunks, eps, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, nchunks);
  if (L % OnChip<T>::kVec == 0 && aligned16(x) && aligned16(y))
    gn_apply<T, true><<<grid, kStatsThreads, 0, stream>>>(x, stats, scale, bias, n, L, cpg, G,
                                                          apply_silu, y);
  else
    gn_apply<T, false><<<grid, kStatsThreads, 0, stream>>>(x, stats, scale, bias, n, L, cpg,
                                                           G, apply_silu, y);
  return cudaGetLastError();
}

}  // namespace sg

extern "C" {

// Floats of scratch sg_group_norm_silu needs for x into y (B, C, L) of
// dtype 0 = fp32, 1 = bf16: 0 unless the group takes the streaming path.
int sg_group_norm_silu_scratch_floats(const void* x, const void* y, int B, int C, int L, int G,
                                      int dtype) {
  if (G <= 0 || C % G != 0) return 0;
  const int n = (C / G) * L;
  const int form = dtype == sg::kBFloat16 ? sg::forward_form<__nv_bfloat16>(x, y, n, L)
                                          : sg::forward_form<float>(x, y, n, L);
  return form == sg::kFormStreaming ? 3 * B * G * sg::stats_chunks(n) : 0;
}

// x, y: (B, C, L) contiguous, dtype 0 = fp32, 1 = bf16; scale, bias: (C,) fp32;
// stats: (B * G) x (mean, rstd) fp32, written; partial: scratch of
// sg_group_norm_silu_scratch_floats floats (may be null when that is 0);
// form: written with the form launched (sg::Form: 0 on chip, 1 cluster,
// 2 streaming). Returns the cudaError_t of the launches (0 = success).
int sg_group_norm_silu(const void* x, const void* scale, const void* bias, void* y,
                       void* stats, void* partial, int B, int C, int L, int G, float eps,
                       int apply_silu, int dtype, void* stream, int* form) {
  if (G <= 0 || C % G != 0 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch<float>(x, scale, bias, y, stats, partial, B, C, L, G, eps,
                                  apply_silu, s, form);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch<__nv_bfloat16>(x, scale, bias, y, stats, partial, B, C, L, G, eps,
                                          apply_silu, s, form);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
