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
// No atomics anywhere, so two runs give the same bits. Both paths go
// through per-(b, c) row sums of dz and dz * xhat: they serve both
// reductions, as the group means are sum_c scale[c] * row / n and the
// parameter gradients are sums of rows over the batch.
//
// On-chip path, groups of n <= kOnChipMax elements with L % kVec == 0 and
// 16-byte aligned bases (gn_group.cuh; every stage-2 training shape), two
// launches:
//  1. gn_bwd_on_chip: one block per (b, g) loads x and dy once as 16-byte
//     vectors and keeps them in registers; each vector lies in one channel
//     row, so a thread forms its vectors' partial (sum dz, sum dz * xhat)
//     into shared memory; one warp per channel adds its row's L / kVec
//     partials (lane-strided, then a butterfly) and writes row_sums[b, c];
//     the warps' sums of scale_c * row give m1 and m2 through a block
//     reduction, all in fixed order; then dx from the registers: dz is
//     held in fp32 where dy's registers were, so the sigmoid is formed
//     once per element. x and dy are read once and dx written once.
//  2. gn_bwd_params: one thread per (channel, batch slice) adds the row sums
//     over the batch in a fixed order, then a fixed-order sum over slices.
// Holding dz, and the sigmoid on the hardware exponential and reciprocal
// (sigmoid_fast, both paths), keep the instructions per element below what
// the bytes allow: formed twice with a correctly rounded reciprocal, the
// sigmoid left the kernel short of instruction issue (PERF.md).
//
// Cluster form, aligned groups of kOnChipMax < n <= kClusterMax elements
// (gn_cluster.cuh; every stage-1 shape at G 1, the DM's and the attention
// AEKL's larger groups), two launches:
//  1. gn_bwd_cluster: cs = ceil(n / kOnChipMax) blocks per (b, g) as one
//     thread-block cluster; each block loads x and dy of its slice once,
//     keeps x in registers and dz in fp32 in shared memory (in registers,
//     48 more a thread in bf16, it left two blocks an SM, too few to hide
//     the reductions and the cluster barrier: PERF.md); one warp per
//     channel row of the slice adds the row's per-vector partials in
//     fixed order. A row inside the slice is written to row_sums at once;
//     a row that straddles slices has each block's piece of it published
//     in shared memory, and the block that holds the row's first element
//     adds the pieces in rank order through distributed shared memory and
//     writes row_sums[b, c]. The group means need no whole rows: each
//     block's sums of scale_c * piece over its row pieces are published
//     with the pieces, behind the same one cluster barrier, and added in
//     rank order for m1 and m2; then dx from the registers. x and dy are
//     read once and dx written once.
//  2. gn_bwd_params, as above.
//
// Three-pass form, what is left: groups above kClusterMax, and ragged or
// unaligned groups of any size:
//  1. gn_bwd_rows: one warp per (b, c) row sums dz and dz * xhat over L.
//  2. gn_bwd_dx: grid (B * G, chunks of 2048 elements), as K1's streaming
//     apply; each block sums its group's cpg row sums (a block reduction),
//     then writes dx for its chunk.
//  3. gn_bwd_params, as above.
// x and dy are read twice on this form (passes 1 and 2): about 5/3 of the
// bound's bytes.
//
// The launcher reports the form it took (Form, gn_cluster.cuh; kStreaming
// is the three-pass form).
#include "gn_cluster.cuh"

namespace sg {

constexpr int kBwdThreads = 256;
constexpr int kRowsPerBlock = kBwdThreads / 32;
constexpr int kParamSlices = 8;  // batch slices per channel in pass 3

// Gradient at the affine output z, through SiLU when apply_silu.
__device__ __forceinline__ float grad_z(float dy, float z, int apply_silu) {
  if (!apply_silu) return dy;
  const float s = sigmoid_fast(z);
  return dy * s * (1.f + z * (1.f - s));
}

// grid B * G, OnChip<T>::kThreads threads, dynamic shared memory n / kVec
// float2. Block bg writes dx for group bg and row_sums[b * C + c] =
// (sum dz, sum dz * xhat) for its channels.
template <typename T, int kVPT>
__global__ void __launch_bounds__(OnChip<T>::kThreads)
gn_bwd_on_chip(const T* __restrict__ x, const T* __restrict__ dy,
               const float2* __restrict__ stats, const float* __restrict__ scale,
               const float* __restrict__ bias, int n, int L, int cpg, int G, int apply_silu,
               T* __restrict__ dx, float2* __restrict__ row_sums) {
  constexpr int kVec = OnChip<T>::kVec, kThreads = OnChip<T>::kThreads;
  extern __shared__ float2 part[];  // per vector: (sum dz, sum dz * xhat)
  __shared__ float red[33];
  const int64_t bg = blockIdx.x;
  const int c0 = (int)(bg % G) * cpg;
  const float2 st = stats[bg];  // (mean, rstd)
  uint4 rx[kVPT];
  float dz[kVPT][kVec];  // dy's registers become dz's
  {
    uint4 rd[kVPT];
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int e = (k * kThreads + threadIdx.x) * kVec;
      rx[k] = load_vec<T, true>(x + bg * n, e, n);
      rd[k] = load_vec<T, true>(dy + bg * n, e, n);
    }
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = k * kThreads + threadIdx.x;
      if (k == kVPT - 1 && v * kVec >= n) break;
      const int c = c0 + v * kVec / L;
      const float sc = scale[c], bi = bias[c];
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xh = (elem<T>(rx[k], j) - st.x) * st.y;
        dz[k][j] = grad_z(elem<T>(rd[k], j), fmaf(xh, sc, bi), apply_silu);
        p1 += dz[k][j];
        p2 += dz[k][j] * xh;
      }
      part[v] = make_float2(p1, p2);
    }
  }
  __syncthreads();
  // one warp per channel row: its L / kVec partials, lane-strided, then a butterfly
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_row = L / kVec;
  float a1 = 0.f, a2 = 0.f;  // lane 0: sum over the warp's channels of scale_c * row
  for (int c = warp; c < cpg; c += kThreads / 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < per_row; i += 32) {
      const float2 p = part[c * per_row + i];
      s1 += p.x;
      s2 += p.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      row_sums[bg * cpg + c] = make_float2(s1, s2);  // b * C + c0 + c
      const float sc = scale[c0 + c];
      a1 += sc * s1;
      a2 += sc * s2;
    }
  }
  const float m1 = block_sum(a1, red) / n;  // mean_g(dxhat)
  const float m2 = block_sum(a2, red) / n;  // mean_g(dxhat * xhat)
  T* dxg = dx + bg * n;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    const int v = k * kThreads + threadIdx.x;
    if (k == kVPT - 1 && v * kVec >= n) break;
    const float sc = scale[c0 + v * kVec / L];
    float f[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xh = (elem<T>(rx[k], j) - st.x) * st.y;
      f[j] = st.y * (dz[k][j] * sc - m1 - xh * m2);
    }
    store_vec<T, true>(dxg, v * kVec, n, f);
  }
}

// grid B * G * cs as clusters of cs blocks, OnChip<T>::kThreads threads,
// dynamic shared memory bwd_cluster_smem<T>(kVPT, per): the block's dz in
// fp32, then one float2 per vector of the largest slice (per vectors).
// Cluster bg writes dx for group bg and row_sums[b * C + c] = (sum dz,
// sum dz * xhat) for its channels.
template <typename T, int kVPT>
__global__ void __launch_bounds__(OnChip<T>::kThreads)
gn_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy,
               const float2* __restrict__ stats, const float* __restrict__ scale,
               const float* __restrict__ bias, int n, int L, int cpg, int G, int apply_silu,
               T* __restrict__ dx, float2* __restrict__ row_sums) {
  constexpr int kVec = OnChip<T>::kVec, kThreads = OnChip<T>::kThreads;
  // dz as float4 [k][q][thread], q < kVec / 4: in shared memory, not in
  // registers, so that three blocks fit on an SM (PERF.md)
  extern __shared__ float4 dzs[];
  float2* part = reinterpret_cast<float2*>(dzs + kVPT * (kVec / 4) * kThreads);  // per vector
  __shared__ float red[33], slot[2], total[2];
  __shared__ float2 edge[2];  // the pieces of the slice's first and last rows
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int64_t bg = blockIdx.x / cs;
  const int nv = n / kVec;
  const ClusterSlice sl(nv, cs, rank);
  const int e0 = sl.v0 * kVec, m = sl.count * kVec;  // the slice: elements [e0, e0 + m)
  const int c0 = (int)(bg % G) * cpg;
  const float2 st = stats[bg];  // (mean, rstd)
  uint4 rx[kVPT];
  {
    uint4 rd[kVPT];
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int e = (k * kThreads + threadIdx.x) * kVec;
      rx[k] = load_vec<T, true>(x + bg * n + e0, e, m);
      rd[k] = load_vec<T, true>(dy + bg * n + e0, e, m);
    }
#pragma unroll
    for (int k = 0; k < kVPT; ++k) {
      const int v = k * kThreads + threadIdx.x;
      if (v >= sl.count) break;
      const int c = c0 + (e0 + v * kVec) / L;
      const float sc = scale[c], bi = bias[c];
      float p1 = 0.f, p2 = 0.f;
      float d[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xh = (elem<T>(rx[k], j) - st.x) * st.y;
        d[j] = grad_z(elem<T>(rd[k], j), fmaf(xh, sc, bi), apply_silu);
        p1 += d[j];
        p2 += d[j] * xh;
      }
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q)
        dzs[(k * (kVec / 4) + q) * kThreads + threadIdx.x] =
            make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
      part[v] = make_float2(p1, p2);
    }
  }
  __syncthreads();
  // one warp per channel row of the slice: its partials in the slice,
  // lane-strided, then a butterfly
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = e0 / L, last = (e0 + m - 1) / L;
  float a[2] = {0.f, 0.f};  // lane 0: sum over the warp's row pieces of scale_c * piece
  for (int c = row0 + warp; c <= last; c += kThreads / 32) {
    const int lo = max(c * L, e0), hi = min((c + 1) * L, e0 + m);
    float s1 = 0.f, s2 = 0.f;
    for (int i = (lo - e0) / kVec + lane; i < (hi - e0) / kVec; i += 32) {
      const float2 p = part[i];
      s1 += p.x;
      s2 += p.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      if (c == row0) edge[0] = make_float2(s1, s2);
      if (c == last) edge[1] = make_float2(s1, s2);
      if (lo == c * L && hi == (c + 1) * L)  // the whole row lies in the slice
        row_sums[bg * cpg + c] = make_float2(s1, s2);  // b * C + c0 + c
      const float sc = scale[c0 + c];
      a[0] += sc * s1;
      a[1] += sc * s2;
    }
  }
  publish_sums<2>(a, red, slot);
  cluster.sync();  // every block's row pieces and sums are published
  if (threadIdx.x == 0) {
    read_sums<2>(slot, total, cluster);
    if (last * L >= e0 && (last + 1) * L > e0 + m) {
      // the slice's last row starts here and runs on: its pieces in rank order
      float2 t = edge[1];
      for (int r = rank + 1; r < cs; ++r) {
        const ClusterSlice o(nv, cs, r);
        const float2 p = *cluster.map_shared_rank(&edge[0], r);  // the row is r's first
        t.x += p.x;
        t.y += p.y;
        if ((last + 1) * L <= (o.v0 + o.count) * kVec) break;  // the row ends in r's slice
      }
      row_sums[bg * cpg + last] = t;
    }
  }
  __syncthreads();
  const float m1 = total[0] / n;  // mean_g(dxhat)
  const float m2 = total[1] / n;  // mean_g(dxhat * xhat)
  T* dxs = dx + bg * n + e0;
#pragma unroll
  for (int k = 0; k < kVPT; ++k) {
    const int v = k * kThreads + threadIdx.x;
    if (v >= sl.count) break;
    const float sc = scale[c0 + (e0 + v * kVec) / L];
    float d[kVec];
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 t = dzs[(k * (kVec / 4) + q) * kThreads + threadIdx.x];
      d[4 * q] = t.x;
      d[4 * q + 1] = t.y;
      d[4 * q + 2] = t.z;
      d[4 * q + 3] = t.w;
    }
    float f[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xh = (elem<T>(rx[k], j) - st.x) * st.y;
      f[j] = st.y * (d[j] * sc - m1 - xh * m2);
    }
    store_vec<T, true>(dxs, v * kVec, m, f);
  }
  cluster.sync();  // the other blocks have read this block's edges and slots
}

// Bytes of dynamic shared memory gn_bwd_cluster<T, kVPT> takes for slices
// of at most per vectors.
template <typename T>
inline size_t bwd_cluster_smem(int kvpt, int per) {
  return (size_t)kvpt * OnChip<T>::kVec * OnChip<T>::kThreads * sizeof(float) +
         (size_t)per * sizeof(float2);
}

template <typename T, int kVPT>
static cudaError_t launch_bwd_cluster(const T* x, const T* dy, const float2* stats,
                                      const float* scale, const float* bias, T* dx,
                                      float2* row_sums, int B, int L, int cpg, int G,
                                      int apply_silu, cudaStream_t stream) {
  const int n = cpg * L, cs = cluster_blocks(n);
  const size_t smem =
      bwd_cluster_smem<T>(kVPT, ClusterSlice(n / OnChip<T>::kVec, cs, 0).count);  // above 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      gn_bwd_cluster<T, kVPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return launch_clusters(gn_bwd_cluster<T, kVPT>, B * G, cs, OnChip<T>::kThreads, smem, stream,
                         x, dy, stats, scale, bias, n, L, cpg, G, apply_silu, dx, row_sums);
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

// K3's form for a group of n = (C / G) * L elements of x and dy into dx.
template <typename T>
static int backward_form(const void* x, const void* dy, const void* dx, int n, int L) {
  const bool aligned = aligned16(x) && aligned16(dy) && aligned16(dx);
  if (n <= kOnChipMax && L % OnChip<T>::kVec == 0 && aligned) return kFormOnChip;
  return takes_cluster<T>(n, L, aligned) ? kFormCluster : kFormStreaming;
}

template <typename T>
static cudaError_t launch_bwd(const void* x, const void* dy, const void* stats, const void* scale,
                              const void* bias, void* dx, void* dscale, void* dbias,
                              void* row_sums, int B, int C, int L, int G, int apply_silu,
                              cudaStream_t stream, int* form) {
  const int cpg = C / G;
  const int n = cpg * L;
  const int64_t rows = (int64_t)B * C;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float2* st = static_cast<const float2*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float2* rs = static_cast<float2*>(row_sums);
  T* dxt = static_cast<T*>(dx);
  constexpr int kVec = OnChip<T>::kVec;
  cudaError_t err;
  *form = backward_form<T>(x, dy, dx, n, L);
  if (*form == kFormOnChip) {
    const size_t smem = (size_t)(n / kVec) * sizeof(float2);
#define SG_BWD_ON_CHIP(V)                                                                    \
  gn_bwd_on_chip<T, V><<<B * G, OnChip<T>::kThreads, smem, stream>>>(xt, dyt, st, sc, bi, n, L, \
                                                                   cpg, G, apply_silu, dxt, rs)
    switch (vecs_per_thread<T>(n)) {
      case 1: SG_BWD_ON_CHIP(1); break;
      case 2: SG_BWD_ON_CHIP(2); break;
      case 3: SG_BWD_ON_CHIP(3); break;
      case 4: SG_BWD_ON_CHIP(4); break;
      case 5: SG_BWD_ON_CHIP(5); break;
      default: SG_BWD_ON_CHIP(6); break;
    }
#undef SG_BWD_ON_CHIP
    err = cudaGetLastError();
  } else if (*form == kFormCluster) {
    const int per = ClusterSlice(n / kVec, cluster_blocks(n), 0).count;
#define SG_BWD_CLUSTER(V) \
  err = launch_bwd_cluster<T, V>(xt, dyt, st, sc, bi, dxt, rs, B, L, cpg, G, apply_silu, stream)
    switch (vecs_per_thread<T>(per * kVec)) {
      case 1: SG_BWD_CLUSTER(1); break;
      case 2: SG_BWD_CLUSTER(2); break;
      case 3: SG_BWD_CLUSTER(3); break;
      case 4: SG_BWD_CLUSTER(4); break;
      case 5: SG_BWD_CLUSTER(5); break;
      default: SG_BWD_CLUSTER(6); break;
    }
#undef SG_BWD_CLUSTER
  } else {
    gn_bwd_rows<T><<<(unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock), kBwdThreads, 0,
                     stream>>>(xt, dyt, st, sc, bi, rows, C, L, cpg, apply_silu, rs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gn_bwd_dx<T><<<dim3(B * G, stats_chunks(n)), kStatsThreads, 0, stream>>>(
        xt, dyt, st, sc, bi, rs, n, C, L, cpg, G, apply_silu, dxt);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  gn_bwd_params<<<(C + 31) / 32, dim3(32, kParamSlices), 0, stream>>>(
      rs, B, C, static_cast<float*>(dscale), static_cast<float*>(dbias));
  return cudaGetLastError();
}

}  // namespace sg

extern "C" {

// x, dy, dx: (B, C, L) contiguous, dtype 0 = fp32, 1 = bf16; stats: (B * G) x
// (mean, rstd) fp32 from sg_group_norm_silu; scale, bias, dscale, dbias: (C,)
// fp32; row_sums: 2 * B * C floats of scratch; form: written with the form
// launched (sg::Form: 0 on chip, 1 cluster, 2 three-pass). Returns the
// cudaError_t of the launches (0 = success).
int sg_group_norm_silu_bwd(const void* x, const void* dy, const void* stats, const void* scale,
                           const void* bias, void* dx, void* dscale, void* dbias,
                           void* row_sums, int B, int C, int L, int G, int apply_silu, int dtype,
                           void* stream, int* form) {
  if (G <= 0 || C % G != 0 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch_bwd<float>(x, dy, stats, scale, bias, dx, dscale, dbias, row_sums, B,
                                      C, L, G, apply_silu, s, form);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch_bwd<__nv_bfloat16>(x, dy, stats, scale, bias, dx, dscale, dbias,
                                              row_sums, B, C, L, G, apply_silu, s, form);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
