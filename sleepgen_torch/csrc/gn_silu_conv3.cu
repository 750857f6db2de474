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
// The GroupNorm statistics come from the shared split reduction
// (gn_stats.cuh); the convolution kernels apply normalise, affine and SiLU
// while they stage their input, so h never goes to device memory.
//
//  * bf16 (the sampler's dtype): the TPU kernel's own formulation, y =
//    sum_k h[l + k - 1] @ W_k, with the positions as the M dimension of
//    the products and the three taps as row offsets 0, 1, 2 of one h tile
//    h[l0 - 1 .. l0 + TM] (zero outside [0, L)). A block owns TM = 192
//    positions x TN = 128 output channels of one batch row, three
//    warpgroups of 64 x 128 (192 divides every sampler length, 128 every
//    C_out), and walks C_in in chunks of 64 channels:
//      - weights: the wrapper lays them out once per weight as tiles
//        (conv_tiles in kernels/fused_resblock.py), each chunk's three
//        taps one contiguous 48 KB block, K-major, already in the 128-byte
//        swizzle that the products read; one thread copies a chunk with
//        one cp.async.bulk that completes on an mbarrier, into a two-stage
//        ring, two chunks ahead of the products;
//      - raw x[ci][l0 - 8 .. l0 + TM + 8): 16-byte cp.async into two
//        buffers, three chunks ahead (element loads where rows are not
//        16-byte aligned, L % 8 != 0);
//      - h: every thread turns raw x into the position-major h tile
//        [TM + 2][64 + 8] with one FMA and one tanh per element, silu(v) =
//        u + u tanh(u) for u = v / 2 = a'_c x + d'_c, from a per-channel
//        affine that folds mean, rstd, scale and bias; each element of h
//        is made once per block, for all taps and output channels;
//      - products: per warpgroup and chunk, twelve wgmma.mma_async
//        m64n128k16 bf16 -> fp32 (3 taps x 4 slices of 16 channels), A
//        from registers (each warp's 16 rows of h at row offset k, through
//        ldmatrix.x4), B through a shared-memory descriptor advanced 32
//        bytes per slice; while they run, the threads make the next
//        chunk's h into the other h buffer;
//      - epilogue: bias, round to bf16, transpose through shared memory,
//        16-byte stores of y[b][co][l] along l.
//    What bounds it now (PERF.md): per chunk the block spends about as
//    long in its two barriers and the copies' issue as in the products,
//    and a block's prologue and epilogue overlap nothing (one block per
//    SM); next come a producer warp and a persistent grid.
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
#include <type_traits>

#include "gn_stats.cuh"

namespace sg {

// -- bf16: tensor cores ---------------------------------------------------------

namespace tc {

constexpr int KC = 64;       // input channels per chunk: one 128-byte swizzled row
constexpr int TN = 128;      // output channels per block: one wgmma n128 per warpgroup
constexpr int HP = KC + 8;   // bf16 pitch of an h row (144 bytes: ldmatrix without conflicts)
constexpr int kVecX = 1;     // x rows are 16-byte aligned: 16-byte cp.async
constexpr int kVecY = 2;     // y rows are 16-byte aligned: 16-byte stores

// Three warpgroups, each 64 positions x TN output channels, over a TM x TN
// tile: every sampler length (192, 384, 768) is a whole number of tiles, as
// every C_out (128, 256, 512) is of TN.
struct Tile {
  static constexpr int MW = 3;                     // warpgroups
  static constexpr int TM = 64 * MW;               // positions per block
  static constexpr int THREADS = 128 * MW;
  static constexpr int XP = TM + 16;               // raw x row: positions l0 - 8 .. l0 + TM + 8
  static constexpr int XSEG = XP / 8;              // 16-byte segments per raw x row
  static constexpr int HROWS = TM + 2;             // h rows: positions l0 - 1 .. l0 + TM
  static constexpr int YP = TM + 8;                // bf16 pitch of an output row (epilogue)
  static constexpr int W_STAGE = 3 * TN * KC * 2;  // one chunk's weights, three taps
  static constexpr int X_STAGE = KC * XP * 2;
  static constexpr int H_STAGE = HROWS * HP * 2;
  static constexpr int OFF_X = 2 * W_STAGE;
  static constexpr int OFF_H = OFF_X + 2 * X_STAGE;
  static constexpr int OFF_AD = OFF_H + 2 * H_STAGE;
  static constexpr int OFF_STATS = OFF_AD + 2 * KC * 8;
  static constexpr int OFF_BAR = OFF_STATS + 2 * kMaxGroups * 4;
  static constexpr int SMEM = OFF_BAR + 2 * 8 + 1024;  // + base alignment
  static_assert(TN * YP * 2 <= 2 * W_STAGE, "the output tile fits the weight stages");
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
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// One thread: a bulk copy of `bytes` contiguous bytes that completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// Shared-memory descriptor of a K-major bf16 tile with the 128-byte swizzle:
// rows of 64 channels (128 bytes), 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across the async products.
__device__ __forceinline__ void fence_acc(float (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[j][r])::"memory");
}
// d[64 x 128] += A[64 x 16] (registers, per warp the mma.m16n8k16 A fragment
// of its 16 rows) x B[16 x 128] (K-major descriptor), fp32 accumulation.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc

// x (B, Cin, L), b (Cout,), y (B, Cout, L), all bf16; wt: the weights as
// tiles (ceil(Cout / TN), ceil(Cin / KC), 3, TN, KC) bf16, zero padded, each
// row's 16-byte chunk c at c ^ (row % 8) (the wrapper's conv_tiles), so one
// chunk's three taps are one contiguous, already swizzled 48 KB copy.
// Grid (ceil(L / TM), ceil(Cout / TN), B), Tile::THREADS threads.
//
// Per chunk kc of 64 input channels, in each iteration: the warpgroups load
// their A fragments from h[kc], wait for chunk kc's weights and issue its
// twelve products; while those run, every thread turns chunk kc + 1's raw
// x into h[kc + 1]; then the products are waited for, and the copies of
// chunk kc + 2's weights (one bulk copy, one thread) and chunk kc + 3's
// raw x (cp.async) go into the buffers that were freed.
__global__ void __launch_bounds__(tc::Tile::THREADS, 1)
gn_silu_conv3_tc(const __nv_bfloat16* __restrict__ x, const float3* __restrict__ partial,
                 int nchunks, const float* __restrict__ scale, const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ wt, const __nv_bfloat16* __restrict__ b,
                 __nv_bfloat16* __restrict__ y, int Cin, int Cout, int L, int G, float eps,
                 int flags) {
  using namespace tc;
  using T = Tile;
  constexpr int TM = T::TM, XP = T::XP, NT = T::THREADS, NWARP = NT / 32;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the weight tiles to it
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + T::OFF_X);   // [2][KC][XP]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + T::OFF_H);   // [2][HROWS][HP]
  float2* ad = reinterpret_cast<float2*>(smem + T::OFF_AD);                // [2][KC]
  float* mean_s = reinterpret_cast<float*>(smem + T::OFF_STATS);
  float* rstd_s = mean_s + kMaxGroups;
  const uint32_t bar0 = sbase + T::OFF_BAR;  // chunk kc's weights: bar0 + 8 (kc % 2)

  const int l0 = blockIdx.x * TM, co0 = blockIdx.y * TN, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = 16 * warp;  // warp's positions in the tile (warpgroup w: 64 w .. 64 w + 63)
  const int cpg = Cin / G;
  const int nk = (Cin + KC - 1) / KC;
  const __nv_bfloat16* xb = x + (int64_t)bi * Cin * L;
  const __nv_bfloat16* wtile = wt + (int64_t)blockIdx.y * nk * (3 * TN * KC);

  auto load_w = [&](int kc) {  // one thread
    bulk_load(sbase + (kc & 1) * T::W_STAGE, wtile + (int64_t)kc * (3 * TN * KC), T::W_STAGE,
              bar0 + 8 * (kc & 1));
  };
  // Raw x of chunk kc: xs[kc % 2][ci][e] = x[kc KC + ci][l0 - 8 + e], zeros outside.
  auto load_x = [&](int kc) {
    const int ci0 = kc * KC;
    if (flags & kVecX) {
      const uint32_t dst = sbase + T::OFF_X + (kc & 1) * T::X_STAGE;
      for (int i = tid; i < KC * T::XSEG; i += NT) {
        const int row = i / T::XSEG, s = i % T::XSEG;
        const int ci = ci0 + row, l = l0 - 8 + 8 * s;
        const bool ok = ci < Cin && l >= 0 && l < L;  // L % 8 == 0: all or none
        cp_async16(dst + (row * XP + 8 * s) * 2, ok ? xb + (int64_t)ci * L + l : xb, ok);
      }
    } else {
      __nv_bfloat16* dst = xs + (kc & 1) * (KC * XP);
      for (int i = tid; i < KC * T::HROWS; i += NT) {
        const int row = i / T::HROWS, j = i % T::HROWS;
        const int ci = ci0 + row, l = l0 - 1 + j;
        dst[row * XP + j + 7] =
            (ci < Cin && l >= 0 && l < L) ? xb[(int64_t)ci * L + l] : __float2bfloat16(0.f);
      }
    }
  };
  // Threads tid < KC, channel c = kc KC + tid: its scale and bias (fetched an
  // iteration ahead), then half its affine, (a / 2, d / 2) with a = rstd
  // scale, d = bias - mean a, so that u = v / 2 = a' x + d'; zero past Cin.
  auto fetch = [&](int kc, float& sc, float& bs) {
    const int c = kc * KC + tid;
    sc = c < Cin ? scale[c] : 0.f;
    bs = c < Cin ? bias[c] : 0.f;
  };
  auto affine = [&](int kc, float sc, float bs) {
    const int c = kc * KC + tid;
    float2 v = make_float2(0.f, 0.f);
    if (c < Cin) {
      const int g = c / cpg;
      const float a = rstd_s[g] * sc;
      v = make_float2(0.5f * a, 0.5f * (bs - mean_s[g] * a));
    }
    ad[(kc & 1) * KC + tid] = v;
  };
  // h[kc % 2][j][c] = bf16(silu(a_c x + d_c)) at position l0 - 1 + j, 0 outside
  // [0, L): one task is 8 channels x 32 positions, a lane per position.
  auto transform = [&](int kc) {
    const __nv_bfloat16* xsb = xs + (kc & 1) * (KC * XP) + 7;
    __nv_bfloat16* hb = hs + (kc & 1) * (T::HROWS * HP);
    const float2* adb = ad + (kc & 1) * KC;
    constexpr int NPB = (T::HROWS + 31) / 32;
    for (int task = warp; task < 8 * NPB; task += NWARP) {
      const int cg = task & 7, j = 32 * (task >> 3) + lane;
      if (j >= T::HROWS) continue;
      const int l = l0 - 1 + j;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (l >= 0 && l < L) {
        float h[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 av = adb[8 * cg + c];
          const float u = fmaf(av.x, __bfloat162float(xsb[(8 * cg + c) * XP + j]), av.y);
          h[c] = fmaf(u, tanh_approx(u), u);
        }
        out = make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]), pack_bf16(h[4], h[5]),
                         pack_bf16(h[6], h[7]));
      }
      *reinterpret_cast<uint4*>(hb + j * HP + 8 * cg) = out;
    }
  };

  // prologue: the first copies fly while the group statistics merge
  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_w(0);
    if (nk > 1) load_w(1);
  }
  load_x(0);
  cp_async_commit();
  if (nk > 1) load_x(1);
  cp_async_commit();
  for (int g = tid; g < G; g += NT)
    merge_group(partial + ((int64_t)bi * G + g) * nchunks, nchunks, eps, &mean_s[g], &rstd_s[g]);
  __syncthreads();
  float sc_n, bs_n;
  if (tid < KC)
    for (int kc = 0; kc < 2 && kc < nk; ++kc) {
      fetch(kc, sc_n, bs_n);
      affine(kc, sc_n, bs_n);
    }
  cp_async_wait_1();  // chunk 0's raw x
  __syncthreads();
  transform(0);
  __syncthreads();
  if (nk > 2) load_x(2);
  cp_async_commit();

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    // products: y[m][n] += h[m + k][ci] W_k[n][ci] over the chunk's 64 ci, as
    // twelve wgmma m64n128k16 per warpgroup, A from registers
    if (tid < KC && kc + 2 < nk) fetch(kc + 2, sc_n, bs_n);
    const uint32_t h_addr = sbase + T::OFF_H + (kc & 1) * T::H_STAGE;
    uint32_t a[3][4][4];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        ldmatrix_x4(a[k][s],
                    h_addr + ((m0 + k + (lane & 15)) * HP + 16 * s + 8 * (lane >> 4)) * 2);
    mbar_wait(bar0 + 8 * (kc & 1), (kc >> 1) & 1);
    const uint32_t w_addr = sbase + (kc & 1) * T::W_STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n128k16_rs(acc, a[k][s], sw128_desc(w_addr + k * (TN * KC * 2) + 32 * s));
    wgmma_commit();
    if (kc + 1 < nk) {  // while the products run: h of the next chunk
      cp_async_wait_1();
      __syncthreads();  // its raw x and affine are visible to every thread
      transform(kc + 1);
    }
    wgmma_wait_all();
    fence_acc(acc);
    // chunk kc's weights and h, and chunk kc + 1's raw x, are free
    __syncthreads();
    if (kc + 2 < nk) {
      if (tid == 0) load_w(kc + 2);
      if (tid < KC) affine(kc + 2, sc_n, bs_n);
    }
    if (kc + 3 < nk) load_x(kc + 3);
    cp_async_commit();
  }

  // epilogue: bias, bf16, transposed through shared memory into ys[co][m]
  // (over the weight stages, which no copy writes any more)
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = co0 + n < Cout ? __bfloat162float(b[co0 + n]) : 0.f;
      const float b1 = co0 + n + 1 < Cout ? __bfloat162float(b[co0 + n + 1]) : 0.f;
      ys[n * T::YP + m0 + g] = __float2bfloat16(acc[j][0] + b0);
      ys[(n + 1) * T::YP + m0 + g] = __float2bfloat16(acc[j][1] + b1);
      ys[n * T::YP + m0 + g + 8] = __float2bfloat16(acc[j][2] + b0);
      ys[(n + 1) * T::YP + m0 + g + 8] = __float2bfloat16(acc[j][3] + b1);
    }
  }
  __syncthreads();
  __nv_bfloat16* yb = y + ((int64_t)bi * Cout + co0) * L + l0;
  if (flags & kVecY) {
    for (int i = tid; i < TN * (TM / 8); i += NT) {
      const int n = i / (TM / 8), s = i % (TM / 8);
      if (co0 + n < Cout && l0 + 8 * s < L)
        *reinterpret_cast<uint4*>(yb + (int64_t)n * L + 8 * s) =
            *reinterpret_cast<const uint4*>(ys + n * T::YP + 8 * s);
    }
  } else {
    for (int i = tid; i < TN * TM; i += NT) {
      const int n = i / TM, m = i % TM;
      if (co0 + n < Cout && l0 + m < L) yb[(int64_t)n * L + m] = ys[n * T::YP + m];
    }
  }
}

static cudaError_t launch_tc(const __nv_bfloat16* x, const float3* part, int nchunks,
                             const float* sc, const float* bs, const __nv_bfloat16* wt,
                             const __nv_bfloat16* b, __nv_bfloat16* y, int B, int Cin, int Cout,
                             int L, int G, float eps, cudaStream_t stream) {
  using T = tc::Tile;
  auto kernel = gn_silu_conv3_tc;
  // The shared-memory opt-in holds per device for the process: set it once
  // per device, not at every launch.
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const bool rows16 = L % 8 == 0;
  const int flags = (rows16 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? tc::kVecX : 0) |
                    (rows16 && reinterpret_cast<uintptr_t>(y) % 16 == 0 ? tc::kVecY : 0);
  const dim3 grid((L + T::TM - 1) / T::TM, (Cout + tc::TN - 1) / tc::TN, B);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(x, part, nchunks, sc, bs, wt, b, y, Cin, Cout, L,
                                                G, eps, flags);
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
      tc::cp_async16(dst + 16 * i, src + 4 * i, true);
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
        tc::cp_async16(dst + (row * T::XP + 4 * s) * 4, ok ? xb + (int64_t)ci * L + l : xb, ok);
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
  tc::cp_async_commit();
  if (nk > 1) load_x(1);
  tc::cp_async_commit();
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
    tc::cp_async_commit();
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
                          int G, float eps, int tile_n, cudaStream_t stream) {
  const int n = (Cin / G) * L;
  const int nchunks = stats_chunks(n);
  cudaError_t err = launch_partial_stats(static_cast<const T*>(x), B * G, n,
                                         static_cast<float3*>(partial), stream);
  if (err != cudaSuccess) return err;
  const float3* part = static_cast<const float3*>(partial);
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorMisalignedAddress;
  if constexpr (std::is_same<T, float>::value) {
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
    err = launch_tc(xp, part, nchunks, sc, bs, wp, bp, yp, B, Cin, Cout, L, G, eps, stream);
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
// reads them, and for bf16 is tc::KC. Returns the cudaError_t of the
// launches (0 = success).
int sg_gn_silu_conv3(const void* x, const void* scale, const void* bias, const void* w,
                     const void* b, void* y, void* partial, int B, int Cin, int Cout, int L,
                     int G, float eps, int dtype, int tile_n, void* stream) {
  if (G <= 0 || G > sg::kMaxGroups || Cin % G != 0 || B <= 0 || L <= 0 || Cout <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sg::kFloat32)
    return (int)sg::launch<float>(x, scale, bias, w, b, y, partial, B, Cin, Cout, L, G, eps,
                                  tile_n, s);
  if (dtype == sg::kBFloat16)
    return (int)sg::launch<__nv_bfloat16>(x, scale, bias, w, b, y, partial, B, Cin, Cout, L, G,
                                          eps, tile_n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
