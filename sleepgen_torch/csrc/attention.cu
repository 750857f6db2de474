// K5: softmax attention of the UNet's attention blocks in bf16, for Hopper
// (sm_90a), without autograd.
//
// Replaces no TPU kernel: the JAX package's attention is jnp einsums
// (sleepgen/nn/layers.py:236-239, SelfAttention1d with mixed_precision, its
// fast-math path). It was added because at head dim 512 every fused SDPA
// backend refused the transposed views of the qkv convolution's output, so
// PyTorch's math backend upcast them to fp32, materialised the logits and ran
// both products on the CUDA cores (a quarter of a DM sampling batch).
//
// Computes, per batch row b and head j, with d the head dim, q, k and v the
// qkv convolution's output (B, 3C, L) read in place at channels [3jd, 3jd +
// d), [3jd + d, 3jd + 2d) and [3jd + 2d, 3(j + 1)d), each L-contiguous:
//   s   = q^T k                 bf16 products, fp32 sums (wgmma)
//   p   = bf16(softmax(s d^-1/2)) over the whole key row, fp32, exact
//   out = p v^T                 bf16 products, fp32 sums, rounded to bf16
// into out (B, C, L) at channels [jd, (j + 1) d). The reference scales q and k
// by d^-1/4 each and rounds them to bf16 before their product; here the
// product takes q and k as they are and the two scales are one fp32 factor
// of the logits (folded with log2 e into exp2), which rounds less.
//
// Bound on the card: operations at the DM's shape (B 64, L 768, d 512, one
// head): 4 L^2 d B = 77.3 GFLOP, 78 us at 989 TFLOP/s, over 201 MB read and
// written, 60 us at 3.35 TB/s; bytes at the LDM's (L 192): 50 MB, 15 us.
//
// Design. One block per (64-query tile, batch row x head), three
// warpgroups (384 threads, one block per SM, 168 registers a thread: a
// separate producer warp would cut that to 128, too few for a row of 128
// fp32 logits a thread):
//  - logits: warpgroup w owns key blocks [NT w, NT w + NT) of 64 keys (NT =
//    ceil(ceil(L / 64) / 3), so L <= 768 and the whole row of 64 x L fp32
//    logits lives in the three warpgroups' registers): for each chunk of KC
//    = 32 channels, two wgmma m64n(64 NT)k16 with both operands MN-major
//    (q and k are L-contiguous), fp32 accumulation;
//  - softmax: row maxima and sums merged across the warpgroups in shared
//    memory (in warpgroup order), exp2 of one FMA per logit, the normalised
//    weights rounded to bf16 into P (shared memory, 64 queries x 64 keys a
//    tile, rows of 128 bytes with the 128-byte swizzle: the K-major operand
//    layout), so the softmax is exact, not online;
//  - output: out^T = v^T p^T in slices of 64 channels, warpgroup w taking
//    slices w, w + 3, ...: wgmma m64n64k16 with v's TMA tiles (64 channels
//    x 64 keys, K-major) as A and P as B, so each accumulator is a (channel,
//    query) tile of out's own layout, stored from registers (bf16 pairs,
//    queries past L masked);
//  - operands stream through a ring of two 52 KB stages (a stage: q's 64 x
//    32 and k's L x 32 channels of one chunk, or v's tiles of two key blocks
//    for each warpgroup) in TMA boxes of a (L, 3C, B) tensor map (128-byte
//    swizzle; zeros past L); every warp frees a stage through an mbarrier
//    once its products have read it, and thread 0 then refills it; v's
//    first stages load during the softmax.
//  Shared memory: ring 104 KB, P 96 KB, row statistics 1.5 KB.
// What bounds it now (clock stamps on an H100): streaming k and v, 1.6 MB a
// block, at 17-20 bytes a clock an SM: at L 768 the warpgroups wait for data
// about half of a block's time, the products and the softmax the rest.
// Tried and slower: clusters of 2 and 4 blocks of one row sharing k and v by
// TMA multicast (which halves or quarters what L2 serves, but not what an SM
// takes in), and four stages of 16 channels in place of two of 32.
#include <algorithm>
#include <cmath>
#include <cstring>

#include "hopper.cuh"

namespace sg {
namespace attn {

using namespace hopper;

constexpr int WG = 3;                      // warpgroups
constexpr int THREADS = 128 * WG;
constexpr int TQ = 64;                     // queries of a block
constexpr int MAX_NT = 4;                  // key blocks of a warpgroup: wgmma n256
constexpr int MAX_KB = WG * MAX_NT;        // key blocks of 64 in a row
constexpr int KC = 32;                     // channels of a logits stage: two k16 steps
constexpr int BOX = KC * 128;              // a TMA box of 64 positions x KC channels
constexpr int VT = 64 * 128;               // a TMA box of v: 64 keys x 64 channels
constexpr int V_KB = 2;                    // key blocks of v a stage holds per warpgroup
constexpr int STAGE = BOX * (1 + MAX_KB);  // q's box and k's MAX_KB boxes: 52 KB
constexpr int STAGES = 2;
constexpr int P_TILE = TQ * 128;           // the weights of one key block: 64 x 64 bf16
constexpr int OFF_P = STAGES * STAGE;
constexpr int OFF_RED = OFF_P + MAX_KB * P_TILE;  // [2][WG][TQ] fp32: row maxima, row sums
constexpr int OFF_BAR = OFF_RED + 2 * WG * TQ * 4;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + base alignment
constexpr int ALL = 1;  // named barrier of the consumer warpgroups
static_assert(WG * V_KB * VT <= STAGE, "a stage holds v's tiles of every warpgroup");
static_assert(STAGE % 1024 == 0 && BOX % 1024 == 0 && OFF_P % 1024 == 0, "swizzle atoms");
static_assert(SMEM <= 232448, "shared memory of one block");

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 from shared memory (descriptors), fp32
// accumulation; TA, TB: 1 where the operand is MN-major; accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 from shared memory (descriptors), fp32
// accumulation; TA, TB: 1 where the operand is MN-major; accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 192] (+)= A[64 x 16] B[16 x 192], bf16 from shared memory (descriptors), fp32
// accumulation; TA, TB: 1 where the operand is MN-major; accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], bf16 from shared memory (descriptors), fp32
// accumulation; TA, TB: 1 where the operand is MN-major; accumulate = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}


// The logits' products of one k16 step: s[64 x 64 NT] (+)= q[64 x 16] k[16 x 64 NT].
template <int NT>
__device__ __forceinline__ void logits_step(float (&s)[32 * NT], uint64_t da, uint64_t db,
                                            int accumulate) {
  if constexpr (NT == 1)
    wgmma_n64<1, 1>(s, da, db, accumulate);
  else if constexpr (NT == 2)
    wgmma_n128<1, 1>(s, da, db, accumulate);
  else if constexpr (NT == 3)
    wgmma_n192<1, 1>(s, da, db, accumulate);
  else
    wgmma_n256<1, 1>(s, da, db, accumulate);
}

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// qk_map: qkv (B, 3C, L) bf16 as a tensor map over (L, 3C, B), box (64, KC,
// 1); v_map: the same tensor, box (64, 64, 1); both with the 128-byte
// swizzle. out (B, C, L) bf16, C = heads d. c = d^-1/2 log2 e. Grid: x the
// query tiles, y = B heads.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
attention_k5(const __grid_constant__ CUtensorMap qk_map, const __grid_constant__ CUtensorMap v_map,
             __nv_bfloat16* __restrict__ out, int heads, int d, int L, float c) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the stages to it
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto full = [&](int s) { return sbase + OFF_BAR + 8 * s; };
  auto empty = [&](int s) { return sbase + OFF_BAR + 8 * (STAGES + s); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * TQ;
  const int cq = 3 * h * d;  // q's first channel; k's at cq + d, v's at cq + 2 d
  const int nkb = (L + 63) / 64, chunks = d / KC, slices = d / 64;
  const int groups = (slices + WG - 1) / WG, pairs = (nkb + V_KB - 1) / V_KB;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every copy: stage j's (j < chunks: q's box and k's of
  // chunk j; then v's tiles of slice group (j - chunks) / pairs, key pair
  // (j - chunks) % pairs) once every warp freed its stage. (Warpgroup 0
  // running this together, its other threads predicated off, made the
  // compiler serialise every wgmma: 17 % slower.)
  const int loads = chunks + groups * pairs;
  auto issue = [&](int j) {
    if (tid != 0 || j >= loads) return;
    const int s = j % STAGES;
    const uint32_t st = sbase + s * STAGE;
    mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
    if (j < chunks) {
      mbar_expect_tx(full(s), BOX * (1 + nkb));
      tma_load_3d(st, &qk_map, q0, cq + j * KC, b, full(s));
      for (int kb = 0; kb < nkb; ++kb)
        tma_load_3d(st + BOX * (1 + kb), &qk_map, 64 * kb, cq + d + j * KC, b, full(s));
    } else {
      const int g = (j - chunks) / pairs, kp = (j - chunks) % pairs;
      const int nw = min(WG, slices - WG * g), ne = min(V_KB, nkb - V_KB * kp);
      mbar_expect_tx(full(s), VT * nw * ne);
      for (int w = 0; w < nw; ++w)
        for (int e = 0; e < ne; ++e)
          tma_load_3d(st + VT * (w * V_KB + e), &v_map, 64 * (V_KB * kp + e),
                      cq + 2 * d + 64 * (WG * g + w), b, full(s));
    }
  };
  for (int j = 0; j < STAGES; ++j) issue(j);

  // warpgroup w; the warp's accumulator rows g0 and g0 + 8 of the
  // warpgroup's 64, its columns 8 j + 2 t and + 1 (the wgmma fragment)
  // (w broadcast from lane 0, so that the compiler sees it uniform in the warp)
  const int w = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int t = lane & 3, g0 = 16 * (warp % 4) + (lane >> 2);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  // stage i's reads are done in this warp: free it, and refill it
  auto release = [&](int i) {
    mbar_arrive(empty(i % STAGES), lane == 0);
    issue(i + STAGES);
    __syncwarp();  // warp 0 together again for its next wgmma
  };
  float sacc[32 * NT];
  int i = 0;  // the block's stage count: stage i % STAGES, round i / STAGES
  for (int kc = 0; kc < chunks; ++kc, ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    {  // a warpgroup with no key below L reads stale tiles: its logits are masked
      const uint32_t st = sbase + s * STAGE;
      const uint64_t da = sw128_desc(st, BOX, 1024);
      const uint64_t db = sw128_desc(st + BOX * (1 + NT * w), BOX, 1024);
      fence_acc(sacc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)  // channels 16 k .. + 15: two 8-row atoms further
        logits_step<NT>(sacc, da + ((2048 * k) >> 4), db + ((2048 * k) >> 4), kc | k);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products: its stage is free
      fence_acc(sacc);
    }
    if (kc > 0) release(i - 1);
  }
  wgmma_wait<0>();
  fence_acc(sacc);
  release(i - 1);

  // softmax over the row: keys past L out, maxima and sums merged over the
  // warpgroups; the weights, bf16, into P
  const int key0 = 64 * NT * w + 2 * t;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (key0 + 8 * j + e >= L) sacc[4 * j + e] = sacc[4 * j + 2 + e] = -INFINITY;
      m0 = fmaxf(m0, sacc[4 * j + e]);
      m1 = fmaxf(m1, sacc[4 * j + 2 + e]);
    }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
  }
  if (t == 0) {
    red[w * TQ + g0] = m0;
    red[w * TQ + g0 + 8] = m1;
  }
  named_sync(ALL, THREADS);
  m0 = red[g0];
  m1 = red[g0 + 8];
#pragma unroll
  for (int v = 1; v < WG; ++v) {
    m0 = fmaxf(m0, red[v * TQ + g0]);
    m1 = fmaxf(m1, red[v * TQ + g0 + 8]);
  }
  const float mc0 = m0 * c, mc1 = m1 * c;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sacc[4 * j + e] = exp2_approx(fmaf(sacc[4 * j + e], c, -mc0));
      sacc[4 * j + 2 + e] = exp2_approx(fmaf(sacc[4 * j + 2 + e], c, -mc1));
      l0 += sacc[4 * j + e];
      l1 += sacc[4 * j + 2 + e];
    }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  float* sums = red + WG * TQ;
  if (t == 0) {
    sums[w * TQ + g0] = l0;
    sums[w * TQ + g0 + 8] = l1;
  }
  named_sync(ALL, THREADS);
  l0 = sums[g0];
  l1 = sums[g0 + 8];
#pragma unroll
  for (int v = 1; v < WG; ++v) {
    l0 += sums[v * TQ + g0];
    l1 += sums[v * TQ + g0 + 8];
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // P: key block kb's tile at kb P_TILE, query row r at r 128 bytes, its
  // 16-byte chunk x (keys 8 x .. + 7) at x ^ (r % 8); g0 and g0 + 8 share r % 8
  unsigned char* P = smem + OFF_P;
#pragma unroll
  for (int j = 0; j < 8 * NT; ++j) {
    const int kb = NT * w + j / 8;
    if (kb < nkb) {
      unsigned char* row = P + kb * P_TILE + g0 * 128 + (((j & 7) ^ (g0 & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(row) =
          pack_bf16(sacc[4 * j] * inv0, sacc[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(row + 8 * 128) =
          pack_bf16(sacc[4 * j + 2] * inv1, sacc[4 * j + 3] * inv1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // P, for the products
  named_sync(ALL, THREADS);

  // out^T = v^T p^T, warpgroup w's slices of 64 channels
  const uint32_t p_addr = sbase + OFF_P;
  for (int g = 0; g < groups; ++g) {
    const int slice = WG * g + w;
    float o[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) o[r] = 0.f;
    for (int kp = 0; kp < pairs; ++kp, ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      {  // a warpgroup past the last slice sums stale tiles it never stores
        const uint32_t st = sbase + s * STAGE + VT * V_KB * w;
        fence_acc(o);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < V_KB; ++e) {
          const int kb = V_KB * kp + e;
          if (kb < nkb) {
            const uint64_t da = sw128_desc(st + VT * e, 16, 1024);
            const uint64_t db = sw128_desc(p_addr + kb * P_TILE, 16, 1024);
#pragma unroll
            for (int k = 0; k < 4; ++k)  // keys 16 k .. + 15: 32 bytes along the rows
              wgmma_n64<0, 0>(o, da + 2 * k, db + 2 * k, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
      }
      release(i);
    }
    if (slice < slices) {
      __nv_bfloat16* ob = out + ((int64_t)blockIdx.y * d + 64 * slice + g0) * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = q0 + 8 * j + 2 * t;  // L % 8 == 0: a pair is all in or all out
        if (col < L) {
          *reinterpret_cast<uint32_t*>(ob + col) = pack_bf16(o[4 * j], o[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(ob + 8 * (int64_t)L + col) =
              pack_bf16(o[4 * j + 2], o[4 * j + 3]);
        }
      }
    }
  }
}

// The two tensor maps of a qkv tensor, a function of its address and shape
// alone: encoding one costs the host about 10 us, so the last few per
// thread are kept, which an eager sampler's loop finds again at every step.
struct Maps {
  const void* qkv;
  int L, C3, B;
  CUtensorMap qk, v;
};

static cudaError_t tensor_maps(const void* qkv, int L, int C3, int B, Maps* out) {
  constexpr int kMaps = 16;
  static thread_local Maps maps[kMaps];
  static thread_local int next_map = 0;
  for (int i = 0; i < kMaps; ++i)
    if (maps[i].qkv == qkv && maps[i].L == L && maps[i].C3 == C3 && maps[i].B == B) {
      *out = maps[i];
      return cudaSuccess;
    }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  Maps m;
  memset(&m, 0, sizeof(m));
  m.qkv = qkv;
  m.L = L;
  m.C3 = C3;
  m.B = B;
  const cuuint64_t dims[3] = {(cuuint64_t)L, (cuuint64_t)C3, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)L * 2, (cuuint64_t)C3 * L * 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  const cuuint32_t qk_box[3] = {64, KC, 1}, v_box[3] = {64, 64, 1};
  CUtensorMap* made[2] = {&m.qk, &m.v};
  const cuuint32_t* boxes[2] = {qk_box, v_box};
  for (int k = 0; k < 2; ++k)
    if (encode(made[k], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims,
               strides, boxes[k], unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  maps[next_map] = m;
  next_map = (next_map + 1) % kMaps;
  *out = m;
  return cudaSuccess;
}

template <int NT>
static cudaError_t launch(const Maps& maps, __nv_bfloat16* out, int B, int heads, int d, int L,
                          float c, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;  // the shared-memory opt-in, once per device
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    err = cudaFuncSetAttribute(attention_k5<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const dim3 grid((L + TQ - 1) / TQ, B * heads);
  attention_k5<NT><<<grid, THREADS, SMEM, stream>>>(maps.qk, maps.v, out, heads, d, L, c);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace sg

extern "C" {

// qkv: (B, 3C, L) bf16, contiguous, 16-byte aligned, C = heads d; out: (B,
// C, L) bf16, contiguous, 16-byte aligned, written. d a multiple of 64 up to
// 512; L a multiple of 8 up to 768; B heads up to 65535; c = d^-1/2 log2 e.
// Returns the cudaError_t of the launch (0 = success).
int sg_attention(const void* qkv, void* out, int B, int heads, int d, int L, float c,
                 void* stream) {
  using namespace sg::attn;
  if (B <= 0 || heads <= 0 || B > 65535 / heads || d <= 0 || d % 64 != 0 || d > 512 || L <= 0 ||
      L % 8 != 0 || L > 64 * MAX_KB ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nt = ((L + 63) / 64 + WG - 1) / WG;
  Maps maps;
  cudaError_t err = tensor_maps(qkv, L, 3 * heads * d, B, &maps);
  if (err != cudaSuccess) return (int)err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return (int)launch<1>(maps, o, B, heads, d, L, c, s);
    case 2: return (int)launch<2>(maps, o, B, heads, d, L, c, s);
    case 3: return (int)launch<3>(maps, o, B, heads, d, L, c, s);
    default: return (int)launch<4>(maps, o, B, heads, d, L, c, s);
  }
}

}  // extern "C"
