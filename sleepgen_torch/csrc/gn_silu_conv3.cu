// GroupNorm -> SiLU -> Conv1d(k=3, SAME padding) + bias over (B, C, L), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sleepgen/pallas_kernels/fused_resblock.py
// (fused_gn_silu_conv3_tiled -> _kernel_tiled; fused_gn_silu_conv3 ->
// _kernel computes the same function): fp32 group statistics, normalise,
// affine, SiLU, round h to the working dtype, then the k = 3 convolution
// with fp32 accumulation plus the bias, output in the working dtype.
//
// Bound on the card: operations. A chain does 3 * C_in * C_out * L
// multiply-adds per batch row; at the UNet's widths that is far above the
// 295 operations per byte where the bf16 tensor cores stop waiting for
// memory, and above the 20 per byte of the fp32 FMA units (67 TFLOP/s).
// Each path takes its group statistics from a launch of its own (bf16: its
// own kernel; fp32: the split reduction shared with K1, gn_stats.cuh) before
// the convolution kernel, which applies normalise, affine and SiLU while it
// stages its input, so h never goes to device memory.
//
//  * bf16 (the sampler's dtype): the TPU kernel's own formulation, y =
//    sum_k h[l + k - 1] @ W_k, with the positions as the M dimension of
//    the products and the three taps as row offsets 0, 1, 2 of one h tile
//    h[l0 - 1 .. l0 + TM] (zero outside [0, L)). Two launches:
//      - gn_silu_conv3_tc_stats: one block per (b, g) merges the group's
//        statistics once (two passes over register-held pieces, Chan's
//        merge across pieces) and writes the per-channel affine (a / 2,
//        d / 2), a = rstd scale, d = bias - mean a, padded to whole chunks;
//      - gn_silu_conv3_tc, launched as its programmatic dependent: a
//        persistent grid of at most one block per SM walks tiles of TM = 192
//        positions x TN = 128 output channels in a static order (tile i,
//        i + gridDim.x, ...: no counter, so a graph replays it as it ran and
//        the result is the same bits every run). A block is warp-specialised
//        and has no block-wide barrier after its set-up: one producer thread
//        keeps each 64-channel chunk's weights (one bulk copy of the 48 KB
//        tile the wrapper swizzled, conv_tiles), raw x (one TMA box of a
//        (L, C_in, B) tensor map, whose zero fill gives the padding at l < 0,
//        l >= L and past C_in) and affine (one bulk copy) two chunks ahead in
//        an mbarrier ring; three warpgroups each own 64 positions: each turns
//        its rows of raw x, and one each side, into h with one FMA and one
//        tanh per element (silu(v) = u + u tanh(u), u = v / 2), into its own
//        double buffer of channel planes (16-byte rows, the layout wgmma reads
//        without swizzle, so tap k is the same tile k rows further), then
//        issues the chunk's twelve wgmma m64n128k16 from shared memory, in
//        turn with the other two warpgroups (named barriers), so that one
//        warpgroup's h is made while another's products run; each frees the
//        stages through the ring's barriers and stores its tile (bias, bf16,
//        a transpose through its h buffers, 16-byte stores). Shared memory:
//        weights 2 x 48 KB, raw x 2 x 26 KB, h 3 x 2 x 9 KB, affine and bias
//        2.5 KB: 202 KB, one block per SM. Where L % 8 != 0 or x is not
//        16-byte aligned, the transform loads x element by element instead
//        (form "elem"; "tma" otherwise, counted by the wrapper). Why one
//        block per SM: two co-resident blocks would get 113 KB each, one
//        stage of weights, so each would stall on every copy; and a tile of
//        fewer than 192 positions rereads the weights more often.
//    What bounds it now (PERF.md; clock stamps on an H100 at 1980 MHz): a
//    chunk takes 3,900-4,800 clocks against the 2,304 of its products.
//    Each warpgroup's turn is its h (2,500-2,850 clocks while the
//    other warpgroups' products read shared memory, 1,700-2,000 without
//    them: issue- and tanh-bound) followed by its products (820-1,050), so
//    the tensor cores wait for h; a tile's epilogue takes 2,350-2,700; the
//    statistics launch 7 us at the LDM's shapes and 21-22 us at the DM's.
//    Next: h made by warps of its own needs registers for 21 warps or
//    setmaxnreg (a transform warpgroup alone made it slower).
//  * fp32 (the first-generation ancestral sampler's dtype, and every fp32
//    call): exact fp32 products and sums (fmaf) on the CUDA cores, no TF32,
//    so its bound is the fp32 FMA rate. The same tap formulation, as an
//    implicit GEMM of positions x output channels x (taps, input channels):
//      - a block owns TN output channels (64 for C_out <= 64, else 128) x
//        TL positions (96 or 48) of one batch row, 256 threads in two
//        K-groups; each K-group takes half of every chunk's 32 input
//        channels, and its threads own 12 positions x 4 output channels;
//        the two K-groups' sums are added in a fixed order at the end, so
//        the result does not depend on timing;
//      - weights: laid out once per weight and version by the wrapper
//        (fp32_conv_tiles in kernels/fused_resblock.py) so that a chunk's
//        32 channels x 3 taps x TN is one contiguous run, copied with
//        16-byte cp.async into a two-stage ring and read as float4 along
//        the output channels: no bank conflicts;
//      - raw x[ci][l0 - 4 .. l0 + TL + 4) (zero outside [0, L)), scale and
//        bias: cp.async into two buffers, two chunks ahead (4-byte element
//        copies where rows are not 16-byte aligned, L % 4 != 0);
//      - h: the per-channel affine a_c = rstd scale_c, d_c = bias_c -
//        mean a_c is folded once per chunk, and h = silu(a_c x + d_c) is
//        made once per block and chunk for all TN output channels and the
//        three taps, while the other buffer's products run: one barrier
//        a chunk;
//      - products: per input channel a thread loads 14 h values (its 12
//        positions and the +-1 halo, serving all three taps) and 3 x 4
//        weights, and issues 144 FMAs; the next channel's values load
//        while they run.
//    Tiles at the v1 UNet's K2 shapes (batch 16; one block of 101 or 125
//    KiB of shared memory an SM, 132 SMs): (C_in, C_out, L) = (64, 64,
//    768), (192, 64, 768), (128, 64, 768): TN 64 x TL 96, 128 blocks, 0.97
//    of a wave; (64, 64, 384): 64 blocks, 0.48; (64, 128, 384), (128, 128,
//    384), (256, 128, 384), (192, 128, 384): TN 128 x TL 48, 128 blocks,
//    0.97; (128, 128, 768): 256 blocks, 1.94 waves.
//    What bounds it now (PERF.md, PR 14): a chunk takes about twice its
//    FMAs' time at the fp32 peak, and neither the tile, the number of
//    warps, the unroll nor halving the shared-memory loads per FMA moved
//    it; the compiler's register allocation, which puts both register-file
//    operands of many of the loop's FFMAs in one bank, is the likely cause
//    (read from the SASS, not traced: no profiler on the card's machine).
//    Outside the chunks, a block's prologue (the first chunk's copies and
//    h) and epilogue overlap nothing, and the statistics are a launch of
//    their own.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "gn_stats.cuh"
#include "hopper.cuh"

namespace sg {

// -- bf16: tensor cores ---------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int KC = 64;        // input channels per chunk: one 128-byte swizzled weight row
constexpr int TN = 128;       // output channels per tile: one wgmma n128 per warpgroup
constexpr int MW = 3;         // consumer warpgroups, each 64 positions x TN of a tile
constexpr int TM = 64 * MW;   // positions per tile: 192 divides every sampler length
constexpr int CONSUMERS = 128 * MW;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int PRODUCER = CONSUMERS / 32;  // the producer's warp index
constexpr int STAGES = 2;     // chunks of weights and raw x in flight
// Raw x row element e is position l0 - XOFF + e. A tensor-map box must start
// 16 bytes aligned along its row, so the row starts 8 positions before the
// tile and holds TM + 16 positions (l0 - 1 .. l0 + TM are read).
constexpr int XOFF = 8;
constexpr int XP = TM + 16;
// A warpgroup's h: rows 0 .. HR - 1 (its 64 positions and one each side),
// rows 1 .. 64 made in quads of 4 rows (8-byte loads of raw x), one quad of
// one plane a thread, rows 0 and 65 by 16 threads.
constexpr int HR = 64 + 2;
constexpr int PLANE = 72 * 16;        // bytes of an h plane: 8 channels x 72 rows (HR used)
constexpr int H_BUF = 8 * PLANE;      // one chunk's h of one warpgroup: 9 KB
constexpr int YP = 64 + 8;            // bf16 pitch of a warpgroup's output row (epilogue)
constexpr int W_STAGE = 3 * TN * KC * 2;  // one chunk's weights, three taps: 48 KB
constexpr int X_STAGE = KC * XP * 2;      // one chunk's raw x: 26 KB
constexpr int OFF_X = STAGES * W_STAGE;
constexpr int OFF_H = OFF_X + STAGES * X_STAGE;
constexpr int OFF_AD = OFF_H + MW * 2 * H_BUF;
constexpr int AD_STAGE = KC * 8;  // one chunk's affine: KC float2
constexpr int OFF_BIAS = OFF_AD + STAGES * AD_STAGE;  // [MW][TN] fp32: each warpgroup's tile bias
constexpr int OFF_BAR = OFF_BIAS + MW * TN * 4;
constexpr int SMEM = OFF_BAR + 4 * STAGES * 8 + 1024;  // + base alignment
// Named barriers: 1 + w, warpgroup w's own; ORDER + w, warpgroup w's turn
// to issue its products, after warpgroup w - 1 (mod MW) has issued its own.
constexpr int ORDER = 1 + MW;
constexpr int kTma = 1;       // x through the tensor map (else the consumers load it)
constexpr int kVecY = 2;      // y rows are 16-byte aligned: 16-byte stores
static_assert(OFF_X % 1024 == 0 && X_STAGE % 1024 == 0 && H_BUF % 1024 == 0, "stage alignment");
static_assert(TN * YP * 2 <= 2 * H_BUF, "a warpgroup's output tile fits its two h buffers");
static_assert(64 * (MW - 1) + HR + XOFF - 1 <= XP, "a warpgroup's raw x lies in the row");
static_assert(SMEM <= 232448, "shared memory of one block");

// The statistics kernel's threads: one block per group.
constexpr int STATS_THREADS = 128;

// One thread: `bytes` contiguous bytes into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Shared-memory descriptor of a K-major bf16 tile without swizzle: core
// matrices of 8 rows x 8 channels, each row 16 bytes, rows 16 bytes apart;
// the two 8-channel halves of a k16 slice `lbo` bytes apart, 8-row groups
// `sbo` bytes apart. Any 16-byte aligned start is a valid tile, so a tile
// shifted by one row is one more descriptor.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// Keeps the compiler from moving accumulator accesses across the async products.
__device__ __forceinline__ void fence_acc(float (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[j][r])::"memory");
}
// d[64 x 128] (+)= A[64 x 16] x B[16 x 128], both K-major in shared memory
// (descriptors), fp32 accumulation; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[16][4], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Four 8 x 8 bf16 matrices in the mma accumulator layout (r[i]: matrix i,
// row lane / 4, columns 2 (lane % 4) and + 1), stored transposed: lanes 8 i ..
// 8 i + 7 give the addresses of the 8 rows of matrix i's transpose.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

}  // namespace tc

// The group statistics of K2's bf16 path, merged once per group, and the
// per-channel affine the tiles fold them into: one block per (b, g) walks
// the group's n contiguous elements in pieces of STATS_THREADS x LOADS loads
// of V elements (V = 8: 16-byte loads, where rows are 16-byte aligned), kept
// packed in registers; each piece's mean and M2 by two passes over them, the
// pieces merged in order by Chan's formula; mean and rstd = 1 / sqrt(var +
// eps) with the biased variance, as torch's GroupNorm. It writes ad[b][c] =
// (a / 2, d / 2), a = rstd scale_c, d = bias_c - mean a, for the group's
// channels, and group G - 1 zeros for c in [Cin, cpad): rows of cpad float2,
// so that a chunk's 64 are one contiguous copy. The tiles' launch may start
// as each block ends its work (griddepcontrol), before the grid's end.
template <int V>
__global__ void __launch_bounds__(tc::STATS_THREADS)
gn_silu_conv3_tc_stats(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, int n, int cpg, int G, int cpad, float eps,
                       float2* __restrict__ ad) {
  constexpr int LOADS = V == 8 ? 4 : 16, PIECE = tc::STATS_THREADS * LOADS * V;
  using Raw = typename std::conditional<V == 8, uint4, __nv_bfloat16>::type;
  __shared__ float red[33];
  const __nv_bfloat16* xg = x + (int64_t)blockIdx.x * n;
  // element e of a load, as fp32
  auto val = [](const Raw& r, int e) {
    if constexpr (V == 8)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&r)[e]);
    else
      return __bfloat162float(r);
  };
  float count = 0.f, mean = 0.f, m2 = 0.f;
  for (int p0 = 0; p0 < n; p0 += PIECE) {
    const int cnt = min(PIECE, n - p0);  // V = 8: n % 8 == 0, so a load is all in or all out
    Raw raw[LOADS];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int idx = (j * tc::STATS_THREADS + threadIdx.x) * V;
      if constexpr (V == 8)
        raw[j] = idx < cnt ? *reinterpret_cast<const uint4*>(xg + p0 + idx) : make_uint4(0u, 0u, 0u, 0u);
      else
        raw[j] = idx < cnt ? xg[p0 + idx] : __float2bfloat16(0.f);
#pragma unroll
      for (int e = 0; e < V; ++e) s += val(raw[j], e);
    }
    const float pm = block_sum(s, red) / cnt;
    float d2 = 0.f;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      if ((j * tc::STATS_THREADS + threadIdx.x) * V < cnt) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = val(raw[j], e) - pm;
          d2 += d * d;
        }
      }
    }
    const float pm2 = block_sum(d2, red);
    const float total = count + cnt;
    const float delta = pm - mean;
    mean += delta * (cnt / total);
    m2 += pm2 + delta * delta * (count / total) * cnt;
    count = total;
  }
  const float rstd = rsqrtf(m2 / count + eps);
  const int bi = blockIdx.x / G, g = blockIdx.x % G, Cin = cpg * G;
  float2* adb = ad + (int64_t)bi * cpad;
  for (int i = threadIdx.x; i < cpg; i += blockDim.x) {
    const int c = g * cpg + i;
    const float a = rstd * scale[c];
    adb[c] = make_float2(0.5f * a, 0.5f * (bias[c] - mean * a));
  }
  if (g == G - 1)
    for (int c = Cin + threadIdx.x; c < cpad; c += blockDim.x) adb[c] = make_float2(0.f, 0.f);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// x (B, Cin, L), b (Cout,), y (B, Cout, L), all bf16; adg (B, nk KC) the
// per-channel affine from gn_silu_conv3_tc_stats; wt: the weights as tiles
// (ceil(Cout / TN), nk, 3, TN, KC) bf16, zero padded, each row's 16-byte
// chunk c at c ^ (row % 8) (the wrapper's conv_tiles); xmap: x as a tensor
// map over (L, Cin, B) with the box (XP, KC, 1) (flags & kTma; else
// unused). Grid: at most one block per SM; block i takes the tiles i, i +
// gridDim.x, ..., tile t = ((b nL) + lt) nN + nt, its TM positions from lt
// TM and TN output channels from nt TN. Each role walks the block's (tile,
// chunk) sequence, chunk q in stage q % STAGES:
//  - the producer (warp PRODUCER, one thread): into a stage its consumers
//    freed, the chunk's weights, raw x (positions l0 - XOFF .. + XP - 1 of
//    64 channels) and affine; only the affine's first copy waits for the
//    statistics (griddepcontrol.wait);
//  - warpgroup w (positions l0 + 64 w .. + 63): h of its rows, free the x
//    stage, its turn (ORDER), the chunk's twelve products, the previous
//    chunk's weights freed once its products are done; per tile, the
//    epilogue through its own h buffers.
__global__ void __launch_bounds__(tc::THREADS, 1)
gn_silu_conv3_tc(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ x,
                 const float2* __restrict__ adg, const __nv_bfloat16* __restrict__ wt,
                 const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y, int B,
                 int Cin, int Cout, int L, int flags) {
  using namespace tc;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the weight stages to it
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float2* ad = reinterpret_cast<float2*>(smem + OFF_AD);  // [STAGES][KC]
  // barriers of stage s: x and affine full, weights full, x free, weights free
  auto full_x = [&](int s) { return sbase + OFF_BAR + 8 * s; };
  auto full_w = [&](int s) { return sbase + OFF_BAR + 8 * (STAGES + s); };
  auto free_x = [&](int s) { return sbase + OFF_BAR + 8 * (2 * STAGES + s); };
  auto free_w = [&](int s) { return sbase + OFF_BAR + 8 * (3 * STAGES + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = (Cin + KC - 1) / KC, nN = (Cout + TN - 1) / TN, nL = (L + TM - 1) / TM;
  const int tiles = nN * nL * B;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_x(s), 1);
      mbar_init(full_w(s), 1);
      mbar_init(free_x(s), CONSUMERS / 32);
      mbar_init(free_w(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER) {
    if (lane == 0) {
      uint32_t q = 0;  // the block's chunk count: stage q % STAGES, round q / STAGES
      bool waited = false;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int nt = t % nN, lt = t / nN % nL, bi = t / (nN * nL);
        const __nv_bfloat16* wtile = wt + (int64_t)nt * nk * (3 * TN * KC);
        for (int kc = 0; kc < nk; ++kc, ++q) {
          const int s = q % STAGES;
          const uint32_t free_parity = ((q / STAGES) & 1) ^ 1;
          auto load_w = [&]() {
            mbar_wait(free_w(s), free_parity);
            mbar_expect_tx(full_w(s), W_STAGE);
            bulk_load(sbase + s * W_STAGE, wtile + (int64_t)kc * (3 * TN * KC), W_STAGE, full_w(s));
          };
          if (q < STAGES) load_w();  // the ring's first weights wait for nothing
          mbar_wait(free_x(s), free_parity);
          mbar_expect_tx(full_x(s), AD_STAGE + (flags & kTma ? X_STAGE : 0));
          if (flags & kTma)
            tma_load_3d(sbase + OFF_X + s * X_STAGE, &xmap, lt * TM - XOFF, kc * KC, bi, full_x(s));
          if (!waited) {  // the statistics' affine
            asm volatile("griddepcontrol.wait;\n" ::: "memory");
            waited = true;
          }
          bulk_load(sbase + OFF_AD + s * AD_STAGE, adg + ((int64_t)bi * nk + kc) * KC, AD_STAGE,
                    full_x(s));
          if (q >= STAGES) load_w();
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg, its thread wgt; the warp's accumulator rows in
  // the warpgroup, 16 (warp % 4) .. + 15, after the wgmma fragment
  const int wg = warp / 4, wgt = tid & 127, mw = 16 * (warp % 4);
  const int bar_id = 1 + wg;
  unsigned char* hwg = smem + OFF_H + wg * 2 * H_BUF;
  float* bias_s = reinterpret_cast<float*>(smem + OFF_BIAS) + wg * TN;
  const uint32_t hwg_addr = sbase + OFF_H + wg * 2 * H_BUF;
  float acc[16][4];
  uint32_t q = 0;
  if (wg == MW - 1) named_arrive(ORDER, 256);  // warpgroup 0 issues first
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % nN, lt = t / nN % nL, bi = t / (nN * nL);
    const int l0 = lt * TM, co0 = nt * TN;
    const int lw = l0 + 64 * wg;  // the warpgroup's first position
    for (int kc = 0; kc < nk; ++kc, ++q) {
      const int s = q % STAGES, hb = q & 1;
      const uint32_t full_parity = (q / STAGES) & 1;
      mbar_wait(full_x(s), full_parity);
      // h[hb][plane p][row r] = bf16(silu(a_c x + d_c)) for channels c = 8 p ..
      // 8 p + 7 at position lw - 1 + r (0 outside [0, L)); u = v / 2 = a' x +
      // d', silu(v) = u + u tanh(u). Thread t: plane t / 16, rows 4 (t % 16)
      // + 1 .. + 4, one 8-byte load of raw x a channel; threads 8 k also row
      // 0 (k < 8) or 65 of plane k % 8. The quad's rows are taken rotated by
      // rot = (t % 16) / 2 % 4, so that the 8 rows each quarter-warp stores
      // at once lie in 8 distinct 16-byte bank groups.
      {
        const float4* adb = reinterpret_cast<const float4*>(ad + s * KC);
        const __nv_bfloat16* xs =
            reinterpret_cast<const __nv_bfloat16*>(smem + OFF_X + s * X_STAGE) + 64 * wg + XOFF - 1;
        const __nv_bfloat16* xg = x + ((int64_t)bi * Cin + kc * KC) * L;
        unsigned char* hbuf = hwg + hb * H_BUF;
        auto silu2 = [](float u0, float u1) {
          return pack_bf16(fmaf(u0, tanh_approx(u0), u0), fmaf(u1, tanh_approx(u1), u1));
        };
        {
          const int p = wgt >> 4, r0 = 4 * (wgt & 15) + 1, rot = (wgt >> 1) & 3;
          const int lq = lw - 1 + r0;  // position of the quad's first row
          // the rotation as byte selectors of the 8-byte load's two words
          const uint32_t sel_lo = (0x3210u + 0x2222u * rot) & 0x7777u, sel_hi = sel_lo ^ 0x4444u;
          // masked: some of the quad's rows lie outside [0, L)
          auto quad = [&](auto masked) {
            uint32_t out[4][4];  // out[j]: row r0 + (j + rot) % 4
#pragma unroll
            for (int cp = 0; cp < 4; ++cp) {
              const float4 av = adb[4 * p + cp];  // (a', d') of channels 8 p + 2 cp and + 1
              float v[2][4];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int ci = 8 * p + 2 * cp + c;
                if (flags & kTma) {
                  const uint2 raw = *reinterpret_cast<const uint2*>(xs + ci * XP + r0);
                  const uint32_t lo = __byte_perm(raw.x, raw.y, sel_lo);
                  const uint32_t hi = __byte_perm(raw.x, raw.y, sel_hi);
                  v[c][0] = __uint_as_float(lo << 16);
                  v[c][1] = __uint_as_float(lo & 0xFFFF0000u);
                  v[c][2] = __uint_as_float(hi << 16);
                  v[c][3] = __uint_as_float(hi & 0xFFFF0000u);
                } else {
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const int l = lq + ((j + rot) & 3);
                    v[c][j] = kc * KC + ci < Cin && l >= 0 && l < L
                                  ? __bfloat162float(xg[(int64_t)ci * L + l])
                                  : 0.f;
                  }
                }
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                out[j][cp] = silu2(fmaf(av.x, v[0][j], av.y), fmaf(av.z, v[1][j], av.w));
                if constexpr (decltype(masked)::value) {
                  const int l = lq + ((j + rot) & 3);
                  if (l < 0 || l >= L) out[j][cp] = 0u;
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<uint4*>(hbuf + p * PLANE + (r0 + ((j + rot) & 3)) * 16) =
                  make_uint4(out[j][0], out[j][1], out[j][2], out[j][3]);
          };
          if (lq >= 0 && lq + 3 < L)
            quad(std::false_type{});
          else
            quad(std::true_type{});
        }
        if ((wgt & 7) == 0) {  // the edge rows
          const int k = wgt >> 3, p = k & 7, r = k < 8 ? 0 : HR - 1;
          const int l = lw - 1 + r;
          uint32_t out[4] = {0u, 0u, 0u, 0u};
          if (l >= 0 && l < L) {
#pragma unroll
            for (int cp = 0; cp < 4; ++cp) {
              const float4 av = adb[4 * p + cp];
              float v[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int ci = 8 * p + 2 * cp + c;
                if (flags & kTma)
                  v[c] = __bfloat162float(xs[ci * XP + r]);
                else
                  v[c] = kc * KC + ci < Cin ? __bfloat162float(xg[(int64_t)ci * L + l]) : 0.f;
              }
              out[cp] = silu2(fmaf(av.x, v[0], av.y), fmaf(av.z, v[1], av.w));
            }
          }
          *reinterpret_cast<uint4*>(hbuf + p * PLANE + r * 16) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
        if (kc == 0) bias_s[wgt] = co0 + wgt < Cout ? __bfloat162float(b[co0 + wgt]) : 0.f;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // h, for the products
      __syncwarp();
      if (lane == 0) mbar_arrive(free_x(s));
      named_sync(bar_id, 128);  // the warpgroup's h is whole
      mbar_wait(full_w(s), full_parity);
      // y[m][n] += h[m + k][ci] W_k[n][ci] over the chunk's 64 ci: twelve
      // wgmma m64n128k16, tap k's A the h tile shifted by k rows
      const uint32_t h_addr = hwg_addr + hb * H_BUF, w_addr = sbase + s * W_STAGE;
      named_sync(ORDER + wg, 256);  // the previous warpgroup has issued its products
      fence_acc(acc);
      wgmma_fence();
      // each operand's descriptor once; a start address moves in its low
      // bits (addresses >> 4, below 2^14)
      const uint64_t desc_a = plain_desc(h_addr, PLANE, 128);
      const uint64_t desc_b = sw128_desc(w_addr, 16, 1024);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_m64n128k16_ss(acc, desc_a + ((2 * j * PLANE + 16 * k) >> 4),
                              desc_b + ((k * (TN * KC * 2) + 32 * j) >> 4), kc | k | j);
      wgmma_commit();
      named_arrive(ORDER + (wg + 1) % MW, 256);
      wgmma_wait<1>();  // the previous chunk's products: its weights and h are free
      fence_acc(acc);
      if (kc > 0 && lane == 0) mbar_arrive(free_w((q - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(free_w((q - 1) % STAGES));

    // epilogue: bias, bf16, transposed through the warpgroup's h buffers
    // into ys[co][m] (stmatrix.trans: matrix (j, half) is the warp's rows 8
    // half .. + 7 at channels 8 j .. 8 j + 7), then stored along l
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(hwg);
    {
      const int t4 = lane & 3, mi = lane >> 3, rho = lane & 7;
      const uint32_t row_addr = hwg_addr + ((8 * (mi >> 1) + rho) * YP + mw + 8 * (mi & 1)) * 2;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float2 b0 = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t4);
        const float2 b1 = *reinterpret_cast<const float2*>(bias_s + 8 * j + 8 + 2 * t4);
        const uint32_t r[4] = {pack_bf16(acc[j][0] + b0.x, acc[j][1] + b0.y),
                               pack_bf16(acc[j][2] + b0.x, acc[j][3] + b0.y),
                               pack_bf16(acc[j + 1][0] + b1.x, acc[j + 1][1] + b1.y),
                               pack_bf16(acc[j + 1][2] + b1.x, acc[j + 1][3] + b1.y)};
        stmatrix_x4_trans(row_addr + 8 * j * YP * 2, r);
      }
    }
    named_sync(bar_id, 128);
    __nv_bfloat16* yb = y + ((int64_t)bi * Cout + co0) * L + lw;
    if (flags & kVecY) {
      for (int i = wgt; i < TN * 8; i += 128) {
        const int n = i >> 3, s8 = i & 7;
        if (co0 + n < Cout && lw + 8 * s8 < L)
          *reinterpret_cast<uint4*>(yb + (int64_t)n * L + 8 * s8) =
              *reinterpret_cast<const uint4*>(ys + n * YP + 8 * s8);
      }
    } else {
      for (int i = wgt; i < TN * 64; i += 128) {
        const int n = i >> 6, m = i & 63;
        if (co0 + n < Cout && lw + m < L) yb[(int64_t)n * L + m] = ys[n * YP + m];
      }
    }
    named_sync(bar_id, 128);  // the next tile's h may overwrite ys
  }
  if (wg == 0) named_sync(ORDER, 256);  // the last warpgroup's last arrival
}

// Per device, set once for the process: the shared-memory opt-in of the
// kernel and the number of SMs.
static cudaError_t tc_device(int* sms) {
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && sm_count[dev] > 0) {
    *sms = sm_count[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(gn_silu_conv3_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) sm_count[dev] = *sms;
  return cudaSuccess;
}

// The bf16 path: the statistics and affine into ad (B, ceil(Cin / KC) KC)
// float2, then the tiles. *form: 0 when x goes through the tensor map (L % 8
// == 0 and x 16-byte aligned), 1 when the consumers load it element by
// element.
static cudaError_t launch_tc(const __nv_bfloat16* x, float2* ad, const float* sc,
                             const float* bs, const __nv_bfloat16* wt, const __nv_bfloat16* b,
                             __nv_bfloat16* y, int B, int Cin, int Cout, int L, int G, float eps,
                             int* form, cudaStream_t stream) {
  using namespace tc;
  int sms = 0;
  cudaError_t err = tc_device(&sms);
  if (err != cudaSuccess) return err;
  const bool rows16 = L % 8 == 0;
  const bool tma = rows16 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int flags = (tma ? kTma : 0) |
                    (rows16 && reinterpret_cast<uintptr_t>(y) % 16 == 0 ? kVecY : 0);
  // x's tensor map is a function of its address and shape alone, and
  // encoding one costs the host about 10 us: keep the last few per
  // thread, which an eager sampler's loop finds again at every step.
  struct XMap {
    const void* x;
    int L, Cin, B;
    CUtensorMap map;
  };
  constexpr int kMaps = 16;
  static thread_local XMap maps[kMaps];
  static thread_local int next_map = 0;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  bool known = false;
  for (int i = 0; tma && i < kMaps && !known; ++i)
    if (maps[i].x == x && maps[i].L == L && maps[i].Cin == Cin && maps[i].B == B) {
      xmap = maps[i].map;
      known = true;
    }
  if (tma && !known) {
    const hopper::EncodeTiled encode = hopper::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)L, (cuuint64_t)Cin, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)L * 2, (cuuint64_t)Cin * L * 2};
    const cuuint32_t box[3] = {XP, KC, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(x), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    maps[next_map] = XMap{x, L, Cin, B, xmap};
    next_map = (next_map + 1) % kMaps;
  }
  const int cpg = Cin / G, n = cpg * L, cpad = (Cin + KC - 1) / KC * KC;
  if (tma)
    gn_silu_conv3_tc_stats<8><<<B * G, STATS_THREADS, 0, stream>>>(x, sc, bs, n, cpg, G, cpad, eps,
                                                                   ad);
  else
    gn_silu_conv3_tc_stats<1><<<B * G, STATS_THREADS, 0, stream>>>(x, sc, bs, n, cpg, G, cpad, eps,
                                                                   ad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)((Cout + TN - 1) / TN) * ((L + TM - 1) / TM) * B;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<int64_t>(tiles, sms));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_silu_conv3_tc, xmap, x, (const float2*)ad, wt, b, y, B, Cin,
                           Cout, L, flags);
  if (err != cudaSuccess) return err;
  *form = tma ? 0 : 1;
  return cudaSuccess;
}

// -- fp32: CUDA cores -----------------------------------------------------------

namespace fp {

constexpr int KC = 32;         // input channels per chunk
constexpr int KG = 2;          // K-groups a block
constexpr int CK = KC / KG;    // input channels of a chunk per K-group
constexpr int PT = 12;         // positions per thread
constexpr int QT = 4;          // output channels per thread (one float4 of weights)
constexpr int THREADS = 256;   // KG K-groups of KTH threads
constexpr int KTH = THREADS / KG;
constexpr int kVecX = 1;       // x rows are 16-byte aligned: 16-byte cp.async
static_assert(THREADS == 8 * KC, "the transform runs eight threads a channel");
static_assert(KG == 2, "the epilogue adds two K-groups' sums");

// A block: TN output channels x TL positions of one batch row. Per K-group,
// QG = TN / QT channel groups x PG position groups of PT, one thread each.
template <int TN>
struct Tile {
  static constexpr int QG = TN / QT;
  static constexpr int PG = KTH / QG;
  static constexpr int TL = PT * PG;         // 48 (TN 128) or 96 (TN 64)
  static constexpr int XP = TL + 8;          // raw x row: positions l0 - 4 .. l0 + TL + 4
  static constexpr int XSEG = XP / 4;        // 16-byte segments per raw x row
  static constexpr int HR = TL + 2;          // h rows: positions l0 - 1 .. l0 + TL
  static constexpr int HP = TL + 8;          // h pitch: 4 channels of a warp on 4 bank octets
  static constexpr int YP = TL + 1;          // output row pitch (epilogue)
  static constexpr int W_STAGE = KC * 3 * TN;  // floats: one chunk's weights, three taps
  static constexpr int X_STAGE = KC * XP;
  static constexpr int H_STAGE = KC * HP;
  static constexpr int OFF_X = 2 * W_STAGE;  // float offsets into shared memory
  static constexpr int OFF_H = OFF_X + 2 * X_STAGE;
  static constexpr int OFF_SB = OFF_H + 2 * H_STAGE;  // [2][scale, bias][KC]
  static constexpr int OFF_STATS = OFF_SB + 4 * KC;
  static constexpr int SMEM = (OFF_STATS + 2 * kMaxGroups) * 4;
  static_assert(QG * PG == KTH && HR <= HP && XP % 4 == 0, "tile");
  static_assert(TN * YP <= 2 * W_STAGE, "the output tile fits the weight stages");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4-byte copy, zero-filled when !valid (element loads of unaligned rows).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace fp

// x (B, Cin, L), b (Cout,), y (B, Cout, L), all fp32; wt: the weights as
// tiles (ceil(Cout / TN), ceil(Cin / KC), KC, 3, TN) fp32, zero padded (the
// wrapper's fp32_conv_tiles), so one chunk's three taps are one contiguous
// run. Grid (ceil(L / TL), ceil(Cout / TN), B), fp::THREADS threads.
//
// Per chunk kc of 32 input channels, one barrier: the copies of chunk
// kc + 1's weights and chunk kc + 2's raw x, scale and bias go into the
// buffers the previous chunk freed; every thread turns chunk kc + 1's raw x
// into h[kc + 1]; then each K-group runs its 16 channels of chunk kc: per
// channel 14 h values and 3 x 4 weights from shared memory as float4, 144
// FMAs into the thread's 12 x 4 sums, the next channel's values loaded
// while these run.
template <int TN>
__global__ void __launch_bounds__(fp::THREADS, 1)
gn_silu_conv3_fp32(const float* __restrict__ x, const float3* __restrict__ partial,
                   int nchunks, const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ wt, const float* __restrict__ b,
                   float* __restrict__ y, int Cin, int Cout, int L, int G, float eps,
                   int flags) {
  using namespace fp;
  using T = Tile<TN>;
  constexpr int TL = T::TL;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                        // [2][KC][3][TN]
  float* xs = smem + T::OFF_X;             // [2][KC][XP]
  float* hs = smem + T::OFF_H;             // [2][KC][HP]
  const float* sb = smem + T::OFF_SB;      // [2][2][KC]
  float* mean_s = smem + T::OFF_STATS;
  float* rstd_s = mean_s + kMaxGroups;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int l0 = blockIdx.x * TL, co0 = blockIdx.y * TN, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int cpg = Cin / G;
  const int nk = (Cin + KC - 1) / KC;
  const float* xb = x + (int64_t)bi * Cin * L;
  const float* wtile = wt + (int64_t)blockIdx.y * nk * T::W_STAGE;

  auto load_w = [&](int kc) {
    const uint32_t dst = sbase + (kc & 1) * T::W_STAGE * 4;
    const float* src = wtile + (int64_t)kc * T::W_STAGE;
    for (int i = tid; i < T::W_STAGE / 4; i += THREADS)
      cp_async16(dst + 16 * i, src + 4 * i, true);
  };
  // Chunk kc's raw x, xs[kc % 2][ci][e] = x[kc KC + ci][l0 - 4 + e] (zeros
  // outside the row and past Cin), and its scale and bias (zeros past Cin).
  auto load_x = [&](int kc) {
    const int ci0 = kc * KC;
    const uint32_t dst = sbase + (T::OFF_X + (kc & 1) * T::X_STAGE) * 4;
    if (flags & kVecX) {
      for (int i = tid; i < KC * T::XSEG; i += THREADS) {
        const int row = i / T::XSEG, s = i % T::XSEG;
        const int ci = ci0 + row, l = l0 - 4 + 4 * s;
        const bool ok = ci < Cin && l >= 0 && l < L;  // L % 4 == 0: all or none
        cp_async16(dst + (row * T::XP + 4 * s) * 4, ok ? xb + (int64_t)ci * L + l : xb, ok);
      }
    } else {
      for (int i = tid; i < KC * T::HR; i += THREADS) {
        const int row = i / T::HR, j = i % T::HR;
        const int ci = ci0 + row, l = l0 - 1 + j;
        const bool ok = ci < Cin && l >= 0 && l < L;
        cp_async4(dst + (row * T::XP + j + 3) * 4, ok ? xb + (int64_t)ci * L + l : xb, ok);
      }
    }
    if (tid < 2 * KC) {
      const int c = ci0 + tid % KC;
      const float* src = tid < KC ? scale : bias;
      cp_async4(sbase + (T::OFF_SB + (kc & 1) * 2 * KC + tid) * 4, c < Cin ? src + c : src,
                c < Cin);
    }
  };
  // h[kc % 2][ci][j] = silu(a_c x + d_c) at position l0 - 1 + j, 0 outside
  // [0, L), with a_c = rstd scale_c and d_c = bias_c - mean a_c (0 past
  // Cin): eight threads a channel, each every eighth position.
  auto transform = [&](int kc) {
    const int ci = tid >> 3, c = kc * KC + ci;
    const float* sbb = sb + (kc & 1) * 2 * KC;
    float a = 0.f, d = 0.f;
    if (c < Cin) {
      const int g = c / cpg;
      a = rstd_s[g] * sbb[ci];
      d = fmaf(-mean_s[g], a, sbb[KC + ci]);
    }
    const float* xr = xs + (kc & 1) * T::X_STAGE + ci * T::XP + 3;
    float* hr = hs + (kc & 1) * T::H_STAGE + ci * T::HP;
    for (int j = tid & 7; j < T::HR; j += 8) {
      const int l = l0 - 1 + j;
      hr[j] = l >= 0 && l < L ? silu(fmaf(a, xr[j], d)) : 0.f;
    }
  };

  // K-group kg = tid / 128 sums input channels 16 kg .. 16 kg + 15 of every
  // chunk; its thread (q, pg) output channels co0 + 4 q .. + 3 at positions
  // l0 + 12 pg .. + 11, as sums over channels in order, then taps 0, 1, 2.
  const int kg = tid / KTH, q = tid % KTH % T::QG, pg = tid % KTH / T::QG;
  const int p0 = PT * pg;
  float acc[PT][QT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[i][j] = 0.f;

  auto products = [&](int kc) {
    const float* hrow = hs + (kc & 1) * T::H_STAGE + CK * kg * T::HP + p0;
    const float* wrow = ws + (kc & 1) * T::W_STAGE + CK * kg * 3 * TN + QT * q;
    float hv[2][PT + 2];  // h at positions l0 + p0 - 1 .. l0 + p0 + 12: all three taps
    float4 wv[2][3];
    auto fetch = [&](int s, int c) {
      const float* hp = hrow + c * T::HP;
#pragma unroll
      for (int v = 0; v < PT / 4; ++v) {
        const float4 h4 = *reinterpret_cast<const float4*>(hp + 4 * v);
        hv[s][4 * v] = h4.x;
        hv[s][4 * v + 1] = h4.y;
        hv[s][4 * v + 2] = h4.z;
        hv[s][4 * v + 3] = h4.w;
      }
      const float2 h2 = *reinterpret_cast<const float2*>(hp + PT);
      hv[s][PT] = h2.x;
      hv[s][PT + 1] = h2.y;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wv[s][k] = *reinterpret_cast<const float4*>(wrow + (c * 3 + k) * TN);
    };
    auto step = [&](int s) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          const float h = hv[s][i + k];
          acc[i][0] = fmaf(wv[s][k].x, h, acc[i][0]);
          acc[i][1] = fmaf(wv[s][k].y, h, acc[i][1]);
          acc[i][2] = fmaf(wv[s][k].z, h, acc[i][2]);
          acc[i][3] = fmaf(wv[s][k].w, h, acc[i][3]);
        }
    };
    fetch(0, 0);
#pragma unroll 2
    for (int c = 0; c < CK; c += 2) {
      fetch(1, c + 1);
      step(0);
      if (c + 2 < CK) fetch(0, c + 2);
      step(1);
    }
  };

  // prologue: chunk 0's copies (and chunk 1's raw x) fly while the group
  // statistics merge
  load_w(0);
  load_x(0);
  cp_async_commit();
  if (nk > 1) load_x(1);
  cp_async_commit();
  for (int g = tid; g < G; g += THREADS)
    merge_group(partial + ((int64_t)bi * G + g) * nchunks, nchunks, eps, &mean_s[g], &rstd_s[g]);
  cp_async_wait_all();  // chunk 0's copies, and chunk 1's raw x that transform(1) reads
  __syncthreads();
  transform(0);
  __syncthreads();

  for (int kc = 0; kc < nk; ++kc) {
    // into the buffers chunk kc - 1 freed: chunk kc + 1's weights, chunk
    // kc + 2's raw x, scale and bias
    if (kc + 1 < nk) load_w(kc + 1);
    if (kc + 2 < nk) load_x(kc + 2);
    cp_async_commit();
    if (kc + 1 < nk) transform(kc + 1);
    products(kc);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: y = (sums of K-group 0 + sums of K-group 1) + b, in that
  // order, through ys[co][m] over the weight stages (no copy in flight), then
  // stored along l
  float* ys = smem;
  if (kg == 1) {
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < QT; ++j) ys[(QT * q + j) * T::YP + p0 + i] = acc[i][j];
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int co = co0 + QT * q + j;
      const float bj = co < Cout ? b[co] : 0.f;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        float* o = ys + (QT * q + j) * T::YP + p0 + i;
        *o = (acc[i][j] + *o) + bj;
      }
    }
  }
  __syncthreads();
  float* yb = y + ((int64_t)bi * Cout + co0) * L + l0;
  for (int i = tid; i < TN * TL; i += THREADS) {
    const int n = i / TL, m = i % TL;
    if (co0 + n < Cout && l0 + m < L) yb[(int64_t)n * L + m] = ys[n * T::YP + m];
  }
}

template <int TN>
static cudaError_t launch_fp32(const float* x, const float3* part, int nchunks, const float* sc,
                               const float* bs, const float* wt, const float* b, float* y,
                               int B, int Cin, int Cout, int L, int G, float eps,
                               cudaStream_t stream) {
  using T = fp::Tile<TN>;
  auto kernel = gn_silu_conv3_fp32<TN>;
  constexpr int kMaxDevices = 64;  // the shared-memory opt-in, once per device
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const int flags = L % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? fp::kVecX : 0;
  const dim3 grid((L + T::TL - 1) / T::TL, (Cout + TN - 1) / TN, B);
  kernel<<<grid, fp::THREADS, T::SMEM, stream>>>(x, part, nchunks, sc, bs, wt, b, y, Cin, Cout,
                                                 L, G, eps, flags);
  return cudaSuccess;
}
template <typename T>
static cudaError_t launch(const void* x, const void* scale, const void* bias, const void* w,
                          const void* b, void* y, void* partial, int B, int Cin, int Cout, int L,
                          int G, float eps, int tile_n, int* form, cudaStream_t stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const int n = (Cin / G) * L;
    const int nchunks = stats_chunks(n);
    err = launch_partial_stats(static_cast<const T*>(x), B * G, n, static_cast<float3*>(partial),
                               stream);
    if (err != cudaSuccess) return err;
    const float3* part = static_cast<const float3*>(partial);
    const auto* xp = static_cast<const float*>(x);
    const auto* wp = static_cast<const float*>(w);
    const auto* bp = static_cast<const float*>(b);
    auto* yp = static_cast<float*>(y);
    if (tile_n == 128)
      err = launch_fp32<128>(xp, part, nchunks, sc, bs, wp, bp, yp, B, Cin, Cout, L, G, eps, stream);
    else if (tile_n == 64)
      err = launch_fp32<64>(xp, part, nchunks, sc, bs, wp, bp, yp, B, Cin, Cout, L, G, eps, stream);
    else
      return cudaErrorInvalidValue;
    if (err != cudaSuccess) return err;
  } else {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    const auto* bp = static_cast<const __nv_bfloat16*>(b);
    auto* yp = static_cast<__nv_bfloat16*>(y);
    if (tile_n != tc::KC) return cudaErrorInvalidValue;
    err = launch_tc(xp, static_cast<float2*>(partial), sc, bs, wp, bp, yp, B, Cin, Cout, L, G, eps,
                    form, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace sg

extern "C" {

// x: (B, Cin, L), b: (Cout,), y: (B, Cout, L), all contiguous in one dtype
// (0 = fp32, 1 = bf16); scale, bias: (Cin,) fp32. w: the kernel's tiles
// (fp32: see gn_silu_conv3_fp32; bf16: the swizzled tiles of
// gn_silu_conv3_tc), 16-byte aligned; tile_n: the tiles' last dimension,
// which for fp32 is the block's TN (64 or 128) and picks the kernel that
// reads them, and for bf16 is tc::KC; partial: scratch of
// sg_gn_scratch_floats floats (fp32) or 2 B ceil(Cin / KC) KC (bf16).
// *form: the bf16 path's load form (0: x through the tensor map, 1: element
// loads), -1 for fp32. Returns the cudaError_t of the launches (0 =
// success).
int sg_gn_silu_conv3(const void* x, const void* scale, const void* bias, const void* w,
                     const void* b, void* y, void* partial, int B, int Cin, int Cout, int L,
                     int G, float eps, int dtype, int tile_n, void* stream, int* form) {
  *form = -1;
  if (G <= 0 || G > sg::kMaxGroups || Cin % G != 0 || B <= 0 || L <= 0 || Cout <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch<float>(x, scale, bias, w, b, y, partial, B, Cin, Cout, L, G, eps,
                                  tile_n, form, s);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch<__nv_bfloat16>(x, scale, bias, w, b, y, partial, B, Cin, Cout, L, G,
                                          eps, tile_n, form, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
