// One thread-block cluster per GroupNorm group: the pieces that K1's and
// K3's cluster forms (group_norm_silu.cu, group_norm_silu_bwd.cu) share.
//
// A group of kOnChipMax < n <= kClusterMax elements is too large for one
// block's registers (gn_group.cuh) but fits in those of a cluster of
// cs = ceil(n / kOnChipMax) <= 8 blocks, the portable cluster size.
// Block `rank` of the cluster holds one contiguous slice of the group, in
// 16-byte vectors (ClusterSlice), in gn_group.cuh's register layout, so the
// group is read from device memory once. The blocks exchange their partial
// sums through distributed shared memory: each block writes its sums to
// its own shared memory, the cluster synchronises, and every block reads
// all cs partials in rank order 0 .. cs - 1 (cluster_sums). That order is
// fixed, so every block gets the same bits, and two runs give the same
// bits. A block may exit only after a last cluster.sync(): until then
// another block of its cluster may still read its shared memory.
//
// The cluster form takes aligned groups only (L % kVec == 0 and 16-byte
// aligned bases, so a vector lies in one channel row), as K3's on-chip
// form does; ragged or unaligned groups, and groups above kClusterMax,
// keep the streaming forms.
#pragma once

#include <cooperative_groups.h>

#include "gn_group.cuh"

namespace sg {

namespace cg = cooperative_groups;

constexpr int kMaxClusterBlocks = 8;  // the portable cluster size
constexpr int kClusterMax = kMaxClusterBlocks * kOnChipMax;

// The form a launcher took, reported to the caller: K1's streaming path and
// K3's three-pass form are kStreaming.
enum Form : int { kFormOnChip = 0, kFormCluster = 1, kFormStreaming = 2 };

// Whether a group of n elements with rows of L takes the cluster form;
// `aligned`: every tensor base the kernel reads or writes is 16-byte aligned.
template <typename T>
inline bool takes_cluster(int n, int L, bool aligned) {
  return n > kOnChipMax && n <= kClusterMax && L % OnChip<T>::kVec == 0 && aligned;
}

inline int cluster_blocks(int n) { return (n + kOnChipMax - 1) / kOnChipMax; }

// Vectors of rank's slice of a group of nv vectors split over cs blocks:
// [v0, v0 + count), per = ceil(nv / cs) vectors a block (at most
// kOnChipMax elements, since n <= cs * kOnChipMax); the last slice may be
// shorter and is never empty.
struct ClusterSlice {
  int v0, count;
  __host__ __device__ ClusterSlice(int nv, int cs, int rank) {
    const int per = (nv + cs - 1) / cs;
    v0 = rank * per;
    count = nv - v0 < per ? nv - v0 : per;
  }
};

// Sums of kN values over the cluster, in two steps around one
// cluster.sync(). publish_sums: each block's sums (block_sum) go to its
// `slot` (kN floats of shared memory, used by no other exchange of the
// kernel). read_sums, by one thread after the sync: every block's slot
// added in rank order into `total` (kN floats of shared memory).
template <int kN>
__device__ __forceinline__ void publish_sums(const float (&v)[kN], float* red, float* slot) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float s = block_sum(v[i], red);
    if (threadIdx.x == 0) slot[i] = s;
  }
}
template <int kN>
__device__ __forceinline__ void read_sums(float* slot, float* total, cg::cluster_group& cluster) {
  const int cs = (int)cluster.num_blocks();
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float t = 0.f;
    for (int r = 0; r < cs; ++r) t += cluster.map_shared_rank(slot, r)[i];
    total[i] = t;
  }
}

// Sums of kN values over the cluster: every thread gets v[i] = the
// cluster's sum i, the same bits in every block.
template <int kN>
__device__ __forceinline__ void cluster_sums(float (&v)[kN], float* red, float* slot,
                                             float* total, cg::cluster_group& cluster) {
  publish_sums<kN>(v, red, slot);
  cluster.sync();
  if (threadIdx.x == 0) read_sums<kN>(slot, total, cluster);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = total[i];
}

// Launch kernel over `groups` clusters of cs blocks (grid groups * cs, one
// dimension), threads a block, dynamic shared memory smem bytes. Returns
// the launch's error; a cluster shape the card refuses is returned, never
// replaced by another form.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int groups, int cs, int threads,
                                   size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)groups * (unsigned)cs);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // cleared, so no later call reports it
  return err != cudaSuccess ? err : last;
}

}  // namespace sg
