// Matmul against packed int4 weights with the nibbles unpacked on chip:
//
//   y[M, N] = (x[:, :K/2] @ lo(P) + x[:, K/2:] @ hi(P)) * s      (fp32 sum)
//
// P [K/2, N] int8 holds two signed nibbles per byte in the split-half layout
// of ops/quant.py: the low nibble of byte (k, n) is weight row k, the high
// nibble weight row K/2 + k. s [N] fp32 is the per-output-channel scale,
// applied to the fp32 sum in the epilogue, followed by one rounding to x's
// dtype (fp32 or bf16).
//
// Replaces the TPU kernel ops/int4_matmul.py:_kernel_stacked of the JAX
// package (wrappers _int4_matmul_stacked / _int4_matmul_2d). The TPU kernel
// picked the layer inside its grid because XLA would copy a scanned slice
// before an opaque call; here the caller passes the pointer of a layer view
// of the stacked payload, which costs nothing.
//
// Bound on the card. The serving path meets two shapes:
//   - small M (decode: 8 slots; the LM head: at most a few rows, fp32 x):
//     bound by the packed weight bytes, half a byte per weight;
//   - large M (admission prefill, the mixed step's [R, Qmax] lattice: up to
//     thousands of rows): bound by arithmetic, 2 * M * K * N operations,
//     which only the tensor cores' wgmma reaches at full rate.
// So there are four instances. The wrapper (ops/int4_matmul.py,
// int4_instance) picks one from the shapes, the dtype and the pointers'
// 16-byte alignment alone, and names it here; this entry point checks
// that the instance takes the call and never falls back:
//   gemv  (M <= 16, any dtype): one launch of a cluster GEMV on the tensor
//         cores, the packed rows split over a thread-block cluster of up to
//         8 and reduced in distributed shared memory, the packed tiles by
//         TMA, an fp32 x split into three exact bf16 terms (see the section
//         below).
//   wgmma (M > 16, bf16, K/2 % 8 == 0, N % 16 == 0, x and P 16-byte
//         aligned: every Llama-3-8B projection): TMA loads into a
//         shared-memory ring tracked by mbarriers, one producer thread;
//         two consumer warpgroups unpack the packed tile straight into
//         wgmma A fragments in registers (the weights are the 64-row
//         operand, the tokens wgmma's N) and accumulate in fp32 registers
//         (see the section below). 128 columns by 64, 128 or 256 tokens
//         (ops/int4_matmul.py, wgmma_tile). Swapping the operands keeps the
//         unpacked weights out of shared memory: no unpacked-tile stores,
//         no proxy fence and no barrier between the consumers, and the
//         token count, which is small for most calls, only has to fill
//         wgmma's N (a multiple of 8) instead of its 64-row M.
//   wmma  (M > 16, bf16, the shapes TMA cannot address): 128 x 128 tiles
//         with 8 warps of nvcuda::wmma 16x16x16 fragments, the packed tile
//         unpacked into shared memory beside the x tiles, the next step's
//         global loads in registers during the products; every load
//         element-wise and bounds-checked.
//   simt  (M > 16, fp32, the fp32 parity engines only): the same tiling on
//         CUDA cores, a 64 x 64 tile per block, 4 x 4 outputs per thread.
//
// Unpacking. A nibble of signed value v has unsigned bits u = v & 15, and
// u ^ 8 = v + 8 for every v in [-8, 7]. So the kernels flip bit 3 of every
// nibble once per 32-bit word (x ^ 0x88888888) and rebuild the value from
// float bits: fp32 0x4B000000 | (v + 8) is 2^23 + v + 8; bf16 0x4300 |
// (v + 8) is 128 + v + 8. One subtraction then gives v exactly. A zero
// byte (TMA's fill past an edge) unpacks to weight 0.
//
// Left: the wgmma instance is not persistent (a block's epilogue does not
// overlap the next tile's loads), spends the consumers' issue slots on the
// unpack (about 1.5 integer operations per weight beside each wgmma: the
// likeliest cause of the gap to the operations bound at large M, not yet
// measured apart), and at M <= 64 with N = 4096 runs 32 blocks on 132 SMs
// (no split-K yet). The simt instance is as in its first version.
#include <cuda.h>
#include <mma.h>

#include "common.cuh"

namespace die {
namespace {

// instance codes shared with the wrapper (ops/int4_matmul.py INSTANCES)
constexpr int kInstGemv = 0;
constexpr int kInstWgmma = 1;
constexpr int kInstWmma = 2;
constexpr int kInstSimt = 3;

// ------------------------------------------------------------- unpacking

// value of a nibble holding v + 8 (see above), as fp32
__device__ __forceinline__ float nib_f(unsigned int biased) {
  return __int_as_float(0x4B000000u | biased) - 8388616.0f;  // 2^23 + 8
}

// bf16 pair (as its 32 bits) of the biased nibbles at bits [0, 4) and
// [8, 12) of x
__device__ __forceinline__ unsigned int nib_pair_bf16(unsigned int x) {
  union {
    unsigned int u;
    __nv_bfloat162 h;
  } v;
  v.u = (x & 0xFu) | ((x & 0xF00u) << 8) | 0x43004300u;  // 128 + v + 8
  v.h = __hsub2(v.h, __floats2bfloat162_rn(136.0f, 136.0f));
  return v.u;
}

// ------------------------------- M > 16, bf16, TMA-addressable: wgmma
//
// Operands swapped: the weights are wgmma's 64-row A operand, unpacked
// straight into registers, and the tokens are its N, so that y^T [N, M] =
// W^T [N, K] x^T [K, M] is summed in fp32 registers and no unpacked weight
// passes through shared memory. A block computes 128 output columns (two
// consumer warpgroups of 64) by NT tokens (64, 128 or 256), with one
// producer warpgroup of which one thread issues the loads. Per k-step of
// kWgBK packed rows a stage of the shared-memory ring holds three TMA
// tiles: x[m0:, kb:kb+64] (lo half) and x[m0:, K/2+kb:...] (hi half), both
// from one 3-D tensor map over x seen as [M][2][K/2] with the 128-byte
// swizzle a K-major wgmma B operand takes, and the packed bytes
// [kb:kb+64, n0:n0+128]. TMA zero-fills the M, N and K/2 edges; a zero byte
// unpacks to weight 0, so the loop has no bounds check. Each consumer
// unpacks its own fragments of the stage (half an ldmatrix.x4.trans and 16
// bf16 pairs per k16 step, unpack_fragments) and issues 8 wgmma (4 k16 steps for each half); the
// fragments are double-buffered in registers, so step k's unpack runs while
// step k - 1's wgmma are in flight, and the warpgroups never wait for each
// other.

constexpr int kWgBN = 128;       // output columns per block
constexpr int kWgBK = 64;        // packed rows per stage (128 bytes of x)
constexpr int kWgPTile = kWgBN * kWgBK;       // packed bytes

template <int NT>
struct WgLayout {
  static constexpr int kXTile = NT * kWgBK * 2;           // one half, bytes
  static constexpr int kStage = 2 * kXTile + kWgPTile;    // TMA bytes
  static constexpr int kFit = 216 * 1024 / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[N / 2] += A (64 x 16 bf16, in registers: the per-warp layout of
// mma.m16n8k16's A fragment, warp w holding rows 16 w .. 16 w + 15) x B (16 x
// N, K-major, 128-byte swizzle, through a descriptor); one warpgroup,
// asynchronous until wgmma.wait_group, which the A registers must outlive
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// bf16 pair (as its 32 bits) of the biased nibbles at bits [0, 4) and
// [16, 20) of t: the unpack of nib_pair_bf16 for words whose bytes are
// laid out so that both nibbles of a pair sit in one 16-bit lane
__device__ __forceinline__ unsigned int nib_lanes_bf16(unsigned int t) {
  union {
    unsigned int u;
    __nv_bfloat162 h;
  } v;
  v.u = (t & 0x000F000Fu) | 0x43004300u;  // 128 + v + 8
  v.h = __hsub2(v.h, __floats2bfloat162_rn(136.0f, 136.0f));
  return v.u;
}

// The A fragments of one 16-row m-tile of weight columns col16 .. col16 +
// 15 (a multiple of 16: one 16-byte chunk of each packed row) from a stage's
// packed tile [64 k][128 n], which arrives by TMA with the 128-byte swizzle
// (16-byte chunk j of row k stored at chunk j ^ (k & 7)). The thread's
// fragment rows are weight columns nrow = col16 + 2q and nrow + 1 (q =
// lane / 4), its fragment columns k = 2c, 2c + 1, 2c + 8, 2c + 9 (c = lane
// % 4) of each k16 step: fr[kk] the lo weights of step kk, fr[4 + kk] the hi
// ones. Two bytes (columns nrow, nrow + 1) of packed rows k and k + 1 make
// one word [k n, k n+1, k+1 n, k+1 n+1], which ldmatrix.trans, reading the
// tile as b16 pairs, hands lane l for rows 2c, 2c + 1 of an 8-row matrix;
// one ldmatrix.x4.trans brings the words of two k16 steps (conflict-free:
// the swizzle puts a matrix's 8 rows in distinct banks). The word's lo
// nibbles at bits 0 and 16 are the bf16 pair of column nrow, at bits 8 and
// 24 that of nrow + 1, and the hi nibbles four bits up.
__device__ __forceinline__ void unpack_fragments(const unsigned char* pt,
                                                 int col16, int lane,
                                                 uint32_t (&fr)[8][4]) {
#pragma unroll
  for (int kp = 0; kp < kWgBK / 32; ++kp) {
    // matrix lane / 8: rows kp 32 + 8 (lane / 8) .. + 7
    const int k = kp * 32 + lane;
    uint32_t t[4];
    ldsm_x4_trans(t, pt + k * 128 + (((col16 >> 4) ^ (k & 7)) << 4));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 2 * kp + h;
      const unsigned int t01 = t[2 * h] ^ 0x88888888u;      // rows 2c, 2c + 1
      const unsigned int t89 = t[2 * h + 1] ^ 0x88888888u;  // rows 2c + 8, + 9
      fr[kk][0] = nib_lanes_bf16(t01);
      fr[kk][1] = nib_lanes_bf16(t01 >> 8);
      fr[kk][2] = nib_lanes_bf16(t89);
      fr[kk][3] = nib_lanes_bf16(t89 >> 8);
      fr[4 + kk][0] = nib_lanes_bf16(t01 >> 4);
      fr[4 + kk][1] = nib_lanes_bf16(t01 >> 12);
      fr[4 + kk][2] = nib_lanes_bf16(t89 >> 4);
      fr[4 + kk][3] = nib_lanes_bf16(t89 >> 12);
    }
  }
}

// keeps A fragment registers live (and in place) until the wgmma that
// read them has been waited for
__device__ __forceinline__ void fence_fragments(uint32_t (&fr)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(fr[i][j])::"memory");
}

// 384 threads, one block per SM: ptxas gives each thread 168 registers,
// which setmaxnreg moves from the producer warpgroup (40) to the two
// consumer warpgroups (232)
template <int NT>
__global__ void __launch_bounds__(384, 1)
    int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap pmap,
                      const float* __restrict__ s,
                      __nv_bfloat16* __restrict__ out, int m, int k2, int n) {
  using L = WgLayout<NT>;
  constexpr int kS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: the swizzle pattern repeats every 1024 bytes
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kS;
  const int m0 = blockIdx.x * NT;
  const int n0 = blockIdx.y * kWgBN;
  const int nk = (k2 + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kS;
        mbar_wait(&empty[st], ((kt / kS) & 1) ^ 1);
        unsigned char* stage = smem + st * L::kStage;
        mbar_expect_tx(&full[st], L::kStage);
        const int kb = kt * kWgBK;
        tma_load_3d(stage, &xmap, kb, 0, m0, &full[st]);
        tma_load_3d(stage + L::kXTile, &xmap, kb, 1, m0, &full[st]);
        tma_load_2d(stage + 2 * L::kXTile, &pmap, n0, kb, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x & 31;
    const int w = (threadIdx.x & 127) >> 5;
    const int q = lane >> 2;
    const int c = lane & 3;
    // this thread's fragment rows: weight columns nrow, nrow + 1 of the tile
    const int nrow = wg * 64 + w * 16 + 2 * q;
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    uint32_t fa[8][4], fb[8][4];

    // one k-step into fragments `cur` while step kt - 1's wgmma, reading
    // `prev`, are in flight
    auto step = [&](int kt, uint32_t(&cur)[8][4], uint32_t(&prev)[8][4]) {
      const int st = kt % kS;
      unsigned char* stage = smem + st * L::kStage;
      mbar_wait(&full[st], (kt / kS) & 1);
      unpack_fragments(stage + 2 * L::kXTile, wg * 64 + w * 16, lane, cur);
      const uint32_t x_lo = smem_u32(stage);
      const uint32_t x_hi = x_lo + L::kXTile;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_rs<NT>(acc, cur[kk], sw128_desc(x_lo + kk * 32));
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_rs<NT>(acc, cur[4 + kk], sw128_desc(x_hi + kk * 32));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // step kt - 1's products are done: its fragments may be overwritten
      // and its stage goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_fragments(prev);
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kS]);
    };
    for (int kt = 0; kt < nk; kt += 2) {
      step(kt, fa, fb);
      if (kt + 1 < nk) step(kt + 1, fb, fa);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_fragments(fa);
    fence_fragments(fb);
    fence_acc(acc);

    // epilogue: accumulator rows are weight columns (row q: nrow, row
    // q + 8: nrow + 1), its columns tokens: acc[4 j + {0, 1}] are tokens
    // 8 j + 2 c + {0, 1} of column nrow, acc[4 j + {2, 3}] of nrow + 1
    const int col = n0 + nrow;
    if (col < n) {  // n % 16 == 0: nrow + 1 < n too
      const float s0 = s[col], s1 = s[col + 1];
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = m0 + 8 * j + 2 * c + e;
          if (r < m)
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<long long>(r) * n + col) =
                __floats2bfloat162_rn(acc[4 * j + e] * s0,
                                      acc[4 * j + 2 + e] * s1);
        }
      }
    }
  }
}

template <int NT>
cudaError_t wgmma_launch(const __nv_bfloat16* x, const int8_t* p,
                         const float* s, __nv_bfloat16* out, int m, int k2,
                         int n, cudaStream_t st) {
  using L = WgLayout<NT>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap, pmap;
  // x [M, K] seen as [M][2][K/2]: the halves' tiles zero-fill past K/2
  const cuuint64_t xdim[3] = {static_cast<cuuint64_t>(k2), 2,
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t xstride[2] = {static_cast<cuuint64_t>(k2) * 2,
                                 static_cast<cuuint64_t>(k2) * 4};
  const cuuint32_t xbox[3] = {kWgBK, 1, NT};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<__nv_bfloat16*>(x), xdim, xstride, xbox,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t pdim[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(k2)};
  const cuuint64_t pstride[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t pbox[2] = {kWgBN, kWgBK};
  r = encode(&pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(p), pdim, pstride, pbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int4_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  // tokens fastest: the blocks of one wave share weight tiles through L2
  dim3 grid((m + NT - 1) / NT, (n + kWgBN - 1) / kWgBN);
  int4_wgmma_kernel<NT><<<grid, 384, L::kBytes, st>>>(xmap, pmap, s, out, m,
                                                      k2, n);
  return cudaGetLastError();
}

cudaError_t wgmma_by_tile(const __nv_bfloat16* x, const int8_t* p,
                          const float* s, __nv_bfloat16* out, int m, int k2,
                          int n, int tile, cudaStream_t st) {
  switch (tile) {
    case 64: return wgmma_launch<64>(x, p, s, out, m, k2, n, st);
    case 128: return wgmma_launch<128>(x, p, s, out, m, k2, n, st);
    case 256: return wgmma_launch<256>(x, p, s, out, m, k2, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------- M <= 16: the GEMV, on tensor cores
//
// Decode (8 slots), the LM head and the mixed step's unembed rows. A block
// owns 128 output columns, the M <= 16 tokens (one or two n8 tiles) and a
// chunk of the packed rows; the chunks of one column tile are the blocks of
// one thread-block cluster of up to 8 (ops/int4_matmul.py int4_gemv_plan),
// which reduce their fp32 partials through distributed shared memory in rank
// order and apply the scale and the one rounding in the same launch: no
// workspace, no second kernel.
//
// Each block streams its packed rows through a ring of 2 stages of 64 rows x
// 128 columns (8 KB, as matmul_residual's two 8 KB stages; 3 and 4 stages
// measured no faster on the H100, a tuning script not kept), by TMA into the
// wgmma instance's 128-byte-swizzled tile where N % 16 == 0 and the payload
// is 16-byte aligned, else by bounds-checked byte loads through registers
// into the same layout (chosen from the shape and the pointer before the
// launch). Beside each stage sit both halves' x slices, x[:, k0 : k0 + 64]
// for the low nibbles and x[:, K/2 + k0 : ...] for the high ones, as bf16:
// a bf16 x by cp.async (16-byte pieces where K/2 and x allow); an fp32 x
// split exactly into three bf16 terms hi + mid + lo (each rounding's
// remainder is exact in fp32, and the three carry more than fp32's 24
// bits), each an n8 tile of its own, and x in element loads, both through
// registers, loaded one stage ahead and stored after the current stage's
// products.
//
// The products run on mma.sync.m16n8k16 with the weights as M (16 columns a
// fragment) and the tokens as N: each warp owns 32 columns (two m-tiles)
// and unpacks its A fragments straight from the packed bytes in registers
// (unpack_fragments: one 16-row byte tile gives the lo fragment against the
// x rows [k0, k0 + 16) and the hi fragment against [K/2 + k0, ...)), the
// tokens' B fragments come from the x slices by ldmatrix. int4 values are
// exact in bf16 and each product is exact in fp32, so the result differs
// from the plain version only in the order of the fp32 sum. The mma
// accumulators restart from 0 each stage and are added to fp32 totals on
// the CUDA cores (round to nearest), so no long chain of tensor-core
// accumulation carries an fp32 x's sum.
//
// What bounds it: the packed bytes, half a byte a weight. At M 8 a CUDA-
// core design needs 16 FMAs a packed byte, more than the card's FMA rate
// allows at the bytes rate (for the fp32 head, such a design on this same
// cluster core measured 3x slower than the three bf16 terms); here a byte
// costs about one integer operation of unpacking and 1/64 of an mma (3/64
// for fp32 x). Measured (PERF.md): about 56% of the bytes bound at gate|up,
// 41% at w_down and 63% at the fp32 head, plus a fixed cost a launch (fill,
// cluster barriers, reduce) of several microseconds that weighs at the
// small projections.

constexpr int kGvThreads = 128;           // 4 warps
constexpr int kGvCols = 128;              // output columns a block
constexpr int kGvK = 64;                  // packed rows a stage
constexpr int kGvStages = 2;
constexpr int kGvPBytes = kGvCols * kGvK; // packed bytes a stage
static_assert(kGvK == kWgBK && kGvCols == kWgBN,
              "the stage's packed tile is the wgmma instance's TMA tile");

// Stage geometry for x of type T and NT 8-token tiles: the 8 KB packed tile
// (1024-byte aligned for the swizzle), then the x slices [half][term][kBt]
// rows of 64 bf16 padded by 16 bytes (conflict-free ldmatrix); after the
// loop the ring holds the block's fp32 partial [kBt][kGvCols].
template <typename T, int NT>
struct GvGeo {
  static constexpr int kTerms = sizeof(T) == 4 ? 3 : 1;  // bf16 terms of x
  static constexpr int kBt = 8 * NT;
  static constexpr int kXStride = kGvK * 2 + 16;
  static constexpr int kXTile = kBt * kXStride;          // one (half, term)
  static constexpr int kStage =
      (kGvPBytes + 2 * kTerms * kXTile + 1023) / 1024 * 1024;
  static constexpr int kPart = kBt * kGvCols * 4;
  static constexpr int kRing = kGvStages * kStage;
  static constexpr int kSmem = (kRing > kPart ? kRing : kPart) + 1024;
};

// x's three bf16 terms: v = hi + mid + lo, each remainder exact in fp32
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16(v);
  const float r1 = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16(r1);
  t[2] = __float2bfloat16(r1 - __bfloat162float(t[1]));
}

// A stage's bf16 x slices by cp.async, 16 bytes a piece (K/2 % 8 == 0, x
// aligned); zeros past m and at or past k_end.
template <int NT>
__device__ __forceinline__ void stage_x_async(const __nv_bfloat16* x,
                                              unsigned char* xs, int k0,
                                              int k_end, int m, int k2) {
  using G = GvGeo<__nv_bfloat16, NT>;
  constexpr int kRow = kGvK / 8;   // 16-byte pieces a (half, token) row
  for (int i = threadIdx.x; i < 2 * G::kBt * kRow; i += kGvThreads) {
    const int row = i / kRow;      // half * kBt + token
    const int half = row / G::kBt;
    const int tok = row - half * G::kBt;
    const int c = i - row * kRow;
    const int k = k0 + c * 8;
    const bool ok = tok < m && k < k_end;
    const __nv_bfloat16* src = x + static_cast<long long>(tok) * 2 * k2 +
                               static_cast<long long>(half) * k2 + k;
    cp_async16(xs + half * G::kXTile + tok * G::kXStride + c * 16,
               ok ? src : x, ok);
  }
}

// A stage's x slices through registers: load() reads pieces of kE elements
// along k of one (half, token) row (16 bytes when kVec, else one element;
// zeros past m and at or past k_end), store() writes them as bf16 terms.
template <typename T, int NT, bool kVec>
struct GvX {
  using G = GvGeo<T, NT>;
  static constexpr int kE = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int kRow = kGvK / kE;                 // pieces a row
  static constexpr int kPieces = 2 * G::kBt * kRow;
  static constexpr int kPer = (kPieces + kGvThreads - 1) / kGvThreads;
  uint4 v[kPer];    // kVec
  T e[kPer];        // element loads

  __device__ __forceinline__ void load(const T* x, int k0, int k_end, int m,
                                       int k2) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kGvThreads;
      const int row = i / kRow;                 // half * kBt + token
      const int half = row / G::kBt;
      const int tok = row - half * G::kBt;
      const int k = k0 + (i - row * kRow) * kE;
      const bool ok = i < kPieces && tok < m && k < k_end;
      const T* src = x + static_cast<long long>(tok) * 2 * k2 +
                     static_cast<long long>(half) * k2 + k;
      if constexpr (kVec) {
        v[j] = ok ? __ldg(reinterpret_cast<const uint4*>(src))
                  : make_uint4(0, 0, 0, 0);
      } else {
        e[j] = ok ? src[0] : from_f<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* xs) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kGvThreads;
      if (i >= kPieces) break;
      const int row = i / kRow;
      const int half = row / G::kBt;
      const int tok = row - half * G::kBt;
      const int kk = (i - row * kRow) * kE;
      unsigned char* dst = xs + half * G::kTerms * G::kXTile +
                           tok * G::kXStride + kk * 2;
      if constexpr (G::kTerms == 1) {
        if constexpr (kVec) {
          *reinterpret_cast<uint4*>(dst) = v[j];
        } else {
          *reinterpret_cast<T*>(dst) = e[j];
        }
      } else {
        const float* f = kVec ? reinterpret_cast<const float*>(&v[j])
                              : reinterpret_cast<const float*>(&e[j]);
        alignas(8) __nv_bfloat16 t[3][kE];
#pragma unroll
        for (int q = 0; q < kE; ++q) {
          __nv_bfloat16 s[3];
          split3(f[q], s);
          t[0][q] = s[0];
          t[1][q] = s[1];
          t[2][q] = s[2];
        }
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          if constexpr (kE == 4) {
            *reinterpret_cast<uint2*>(dst + term * G::kXTile) =
                *reinterpret_cast<const uint2*>(t[term]);
          } else {
            *reinterpret_cast<__nv_bfloat16*>(dst + term * G::kXTile) =
                t[term][0];
          }
        }
      }
    }
  }
};

// A stage's packed tile through registers where TMA cannot address it:
// 16-byte chunks of one row read byte by byte (zeros at or past k_end or n)
// and stored where the 128-byte swizzle puts them (chunk j of row r at chunk
// j ^ (r % 8)), the layout TMA writes.
struct GvP {
  static constexpr int kChunks = kGvK * kGvCols / 16;
  static constexpr int kPer = kChunks / kGvThreads;
  uint4 v[kPer];

  __device__ __forceinline__ void load(const int8_t* p, int k0, int k_end,
                                       int n0, int n) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kGvThreads;
      const int r = i / (kGvCols / 16);
      const int c0 = n0 + (i - r * (kGvCols / 16)) * 16;
      const int k = k0 + r;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(p) +
                                 static_cast<long long>(k) * n + c0;
      unsigned int w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned int word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = 4 * q + b;
          const unsigned int byte =
              k < k_end && c0 + c < n ? __ldg(src + c) : 0u;
          word |= byte << (8 * b);
        }
        w[q] = word;
      }
      v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  __device__ __forceinline__ void store(unsigned char* pt) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kGvThreads;
      const int r = i / (kGvCols / 16);
      const int c = i - r * (kGvCols / 16);
      *reinterpret_cast<uint4*>(pt + r * 128 + ((c ^ (r & 7)) << 4)) = v[j];
    }
  }
};

// kTma: thread 0 brings each stage's packed tile by TMA (pmap: the payload
// as [k2 rows][n columns] bytes, boxes of 128 x 64, 128-byte swizzle, zeros
// past k2 and n), tracked by an mbarrier a stage; else pmap is not read.
// kXVec: x's (half, token) rows are whole 16-byte pieces (K/2 % (16 /
// sizeof(T)) == 0, x aligned); a bf16 x then comes by cp.async beside the
// packed tile, else (an fp32 x, which is split, or element loads) through
// registers, loaded one stage ahead and stored after the current stage's
// products.
template <typename T, int NT, bool kTma, bool kXVec>
__global__ void __launch_bounds__(kGvThreads)
int4_gemv_mma_kernel(const __grid_constant__ CUtensorMap pmap,
                     const T* __restrict__ x, const int8_t* __restrict__ p,
                     const float* __restrict__ s, T* __restrict__ out, int m,
                     int k2, int n, int chunk) {
  using G = GvGeo<T, NT>;
  constexpr bool kXAsync = kXVec && G::kTerms == 1;
  extern __shared__ __align__(16) unsigned char gv_smem_raw[];
  unsigned char* smem =
      gv_smem_raw + ((1024u - (smem_u32(gv_smem_raw) & 1023u)) & 1023u);
  __shared__ __align__(8) uint64_t full[kGvStages];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int ks = static_cast<int>(cl.num_blocks());  // along x
  const int rank = static_cast<int>(cl.block_rank());
  const int n0 = (blockIdx.x / ks) * kGvCols;
  const int k_begin = rank * chunk;
  const int k_end = min(k2, k_begin + chunk);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kGvK - 1) / kGvK : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kGvStages; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  GvX<T, NT, kXVec> xr;
  GvP pr;
  // tile t: its packed tile by TMA (or into registers) and its x slices
  // by cp.async (or into registers); put() stores what came through
  // registers
  auto issue = [&](int t) {
    unsigned char* st = smem + (t % kGvStages) * G::kStage;
    const int k0 = k_begin + t * kGvK;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &full[t % kGvStages];
        mbar_expect_tx(bar, kGvPBytes);
        tma_load_2d(st, &pmap, n0, k0, bar);
      }
    } else {
      pr.load(p, k0, k_end, n0, n);
    }
    if constexpr (kXAsync) {
      stage_x_async<NT>(x, st + kGvPBytes, k0, k_end, m, k2);
    } else {
      xr.load(x, k0, k_end, m, k2);
    }
  };
  auto put = [&](int t) {
    unsigned char* st = smem + (t % kGvStages) * G::kStage;
    if constexpr (!kTma) pr.store(st);
    if constexpr (!kXAsync) xr.store(st + kGvPBytes);
  };

  float tot[2][NT][4];   // the block's sums (fp32, CUDA cores)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.f;

  // the first kGvStages - 1 tiles in flight before the loop; each tile's
  // register-staged part is stored as soon as it arrives
#pragma unroll
  for (int t = 0; t < kGvStages - 1; ++t) {
    if (t < n_kt) {
      issue(t);
      put(t);
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_kt; ++t) {
    const int tn = t + kGvStages - 1;
    if (tn < n_kt) issue(tn);
    cp_async_commit();
    cp_async_wait<kGvStages - 1>();  // tile t's copies landed (this thread's)
    if constexpr (kTma) mbar_wait(&full[t % kGvStages], (t / kGvStages) & 1);
    __syncthreads();   // tile t's packed tile and x slices in place
    const unsigned char* st = smem + (t % kGvStages) * G::kStage;
    const unsigned char* xs = st + kGvPBytes;
    // the warp's two m-tiles: columns 32 warp + 16 mt + 2 (lane / 4) (+1)
    // are fragment rows lane / 4 (+8) (unpack_fragments)
    uint32_t fr[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      unpack_fragments(st, 32 * warp + 16 * mt, lane, fr[mt]);
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kq = 0; kq < kGvK / 32; ++kq)
#pragma unroll
        for (int term = 0; term < G::kTerms; ++term)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // the tokens' B fragments of k16 steps 2kq and 2kq + 1
            uint32_t xb[4];
            ldsm_x4(xb, xs + (half * G::kTerms + term) * G::kXTile +
                            (8 * nt + (lane & 7)) * G::kXStride +
                            (kq * 32 + (lane >> 3) * 8) * 2);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16_16816(acc[mt][nt], fr[mt][4 * half + 2 * kq], xb[0],
                             xb[1]);
              mma_bf16_16816(acc[mt][nt], fr[mt][4 * half + 2 * kq + 1],
                             xb[2], xb[3]);
            }
          }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mt][nt][e] += acc[mt][nt][e];
    if (tn < n_kt) put(tn);   // that stage was freed by the last barrier
    __syncthreads();          // stage t is free again
  }
  cp_async_wait<0>();

  // the block's partial [kBt][kGvCols]: accumulator row lane/4 (+8) is
  // weight column nrow (+1), its columns tokens 8nt + 2 (lane % 4) (+1)
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(8 * nt + 2 * (lane & 3) + (e & 1)) * kGvCols + 32 * warp +
             16 * mt + 2 * (lane >> 2) + (e >> 1)] = tot[mt][nt][e];
  // the cluster's sums, scaled and rounded once
  cluster_reduce<kGvCols, kGvThreads>(
      part, G::kBt, [&](int tok, int c, float sum) {
        const int col = n0 + c;
        if (tok < m && col < n)
          out[static_cast<long long>(tok) * n + col] =
              from_f<T>(sum * s[col]);
      });
}

template <typename T, int NT, bool kTma, bool kXVec>
cudaError_t gemv_launch(const T* x, const int8_t* p, const float* s, T* out,
                        int m, int k2, int n, int ks, int chunk,
                        cudaStream_t st) {
  using G = GvGeo<T, NT>;
  CUtensorMap pmap = {};
  if constexpr (kTma) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k2)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n)};
    const cuuint32_t box[2] = {kGvCols, kGvK};
    const cuuint32_t ones[2] = {1, 1};
    if (encode(&pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
               const_cast<int8_t*>(p), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return launch_cluster<int4_gemv_mma_kernel<T, NT, kTma, kXVec>>(
      dim3(((n + kGvCols - 1) / kGvCols) * ks, 1, 1), kGvThreads, ks,
      G::kSmem, st, pmap, x, p, s, out, m, k2, n, chunk);
}

template <typename T, bool kTma, bool kXVec>
cudaError_t gemv_by_rows(const T* x, const int8_t* p, const float* s, T* out,
                         int m, int k2, int n, int ks, int chunk,
                         cudaStream_t st) {
  if (m <= 8)
    return gemv_launch<T, 1, kTma, kXVec>(x, p, s, out, m, k2, n, ks, chunk,
                                          st);
  return gemv_launch<T, 2, kTma, kXVec>(x, p, s, out, m, k2, n, ks, chunk,
                                        st);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// the GEMV's copy routes, from the shape and the pointers: the packed tile
// by TMA (N % 16 == 0, payload aligned), x in 16-byte pieces
template <typename T>
cudaError_t gemv_t(const void* xv, const int8_t* p, const float* s,
                   void* outv, int m, int k2, int n, int ks, int chunk,
                   cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const bool tma = n % 16 == 0 && aligned16(p);
  const bool xvec = k2 % (16 / static_cast<int>(sizeof(T))) == 0 &&
                    aligned16(x);
  if (tma)
    return xvec ? gemv_by_rows<T, true, true>(x, p, s, out, m, k2, n, ks, chunk, st)
                : gemv_by_rows<T, true, false>(x, p, s, out, m, k2, n, ks, chunk, st);
  return xvec ? gemv_by_rows<T, false, true>(x, p, s, out, m, k2, n, ks, chunk, st)
              : gemv_by_rows<T, false, false>(x, p, s, out, m, k2, n, ks, chunk, st);
}

// ------------------- M > 16, bf16, shapes TMA cannot address: wmma

constexpr int kMmaM = 128, kMmaN = 128, kMmaK = 32;  // kMmaK packed rows
constexpr int kMmaThreads = 256;                     // 8 warps: 4 (M) x 2 (N)
constexpr int kApad = 8, kBpad = 8;                  // bf16 elements
// two resident blocks per SM (at most 128 registers a thread): with one,
// the next step's global loads have only one block's products to hide
// behind
constexpr int kMmaBlocksPerSm = 2;

__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSm)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ p, const float* __restrict__ s,
                __nv_bfloat16* __restrict__ out, int m, int k2, int n) {
  using namespace nvcuda;
  // [lo/hi][row][k] activations, [lo/hi][k][col] unpacked weights
  __shared__ __align__(128) __nv_bfloat16 a_s[2][kMmaM][kMmaK + kApad];
  __shared__ __align__(128) __nv_bfloat16 b_s[2][kMmaK][kMmaN + kBpad];
  __shared__ __align__(128) float c_s[kMmaThreads / 32][16][16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;   // rows wm * 32 .. + 32
  const int wn = warp >> 2;  // cols wn * 64 .. + 64
  const int m0 = blockIdx.y * kMmaM;
  const int n0 = blockIdx.x * kMmaN;
  const long long kdim = 2LL * k2;

  // global -> register staging: 4 x 16 B of activations (2 halves x 128
  // rows x 4 segments of 8 values / 256 threads) and 16 B of packed weights
  // (32 rows x 8 segments of 16 bytes / 256 threads) per thread per step
  uint4 a_reg[4];
  uint4 b_reg;

  auto load_tiles = [&](int kt) {
    const int kb = kt * kMmaK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int half = idx >> 9;
      const int row = (idx >> 2) & (kMmaM - 1);
      const int seg = idx & 3;
      const int gr = m0 + row;
      const int gk = kb + seg * 8;
      const __nv_bfloat16* src = x + gr * kdim + half * k2 + gk;
      unsigned int h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = (gr < m && gk + e < k2)
                   ? __ldg(reinterpret_cast<const unsigned short*>(src) + e)
                   : 0u;
      a_reg[i] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                            h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
    const int row = tid >> 3;
    const int seg = tid & 7;
    const int gk = kb + row;
    const int gc = n0 + seg * 16;
    const int8_t* src = p + static_cast<long long>(gk) * n + gc;
    // out-of-range weights unpack to 0 (bytes 0x88 after the flip)
    unsigned int w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned int word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * q + b;
        const unsigned int byte =
            (gk < k2 && gc + c < n)
                ? static_cast<unsigned char>(__ldg(src + c))
                : 0u;
        word |= byte << (8 * b);
      }
      w[q] = word;
    }
    b_reg = make_uint4(w[0], w[1], w[2], w[3]);
  };

  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int half = idx >> 9;
      const int row = (idx >> 2) & (kMmaM - 1);
      const int seg = idx & 3;
      *reinterpret_cast<uint4*>(&a_s[half][row][seg * 8]) = a_reg[i];
    }
    const int row = tid >> 3;
    const int seg = tid & 7;
    const unsigned int words[4] = {b_reg.x, b_reg.y, b_reg.z, b_reg.w};
    unsigned int lo[8], hi[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned int t = words[q] ^ 0x88888888u;
      lo[2 * q] = nib_pair_bf16(t);             // columns 4q, 4q + 1
      lo[2 * q + 1] = nib_pair_bf16(t >> 16);   // columns 4q + 2, 4q + 3
      hi[2 * q] = nib_pair_bf16(t >> 4);
      hi[2 * q + 1] = nib_pair_bf16(t >> 20);
    }
    uint4* dlo = reinterpret_cast<uint4*>(&b_s[0][row][seg * 16]);
    uint4* dhi = reinterpret_cast<uint4*>(&b_s[1][row][seg * 16]);
    dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (k2 + kMmaK - 1) / kMmaK;
  load_tiles(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous step's products are done with smem
    store_tiles();
    __syncthreads();
    if (kt + 1 < nk) load_tiles(kt + 1);  // in flight during the products
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int kk = 0; kk < kMmaK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], &a_s[half][wm * 32 + i * 16][kk],
                                 kMmaK + kApad);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(bf[j], &b_s[half][kk][wn * 64 + j * 16],
                                 kMmaN + kBpad);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
    }
  }

  // epilogue: each fragment through the warp's 16 x 16 scratch, scaled per
  // column in fp32 and rounded once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&c_s[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int cb = (lane & 1) * 8;
      const int gr = m0 + wm * 32 + i * 16 + r;
      const int gc = n0 + wn * 64 + j * 16 + cb;
      if (gr < m) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (gc + c < n)
            out[static_cast<long long>(gr) * n + gc + c] =
                __float2bfloat16(c_s[warp][r][cb + c] * s[gc + c]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------- large M, fp32: CUDA cores

constexpr int kSimtM = 64, kSimtN = 64, kSimtK = 16;  // kSimtK packed rows
constexpr int kSimtThreads = 256;                     // 16 x 16, 4 x 4 each

__global__ void __launch_bounds__(kSimtThreads)
int4_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ p,
                 const float* __restrict__ s, float* __restrict__ out, int m,
                 int k2, int n) {
  __shared__ __align__(16) float a_s[2][kSimtK][kSimtM + 4];  // [half][k][row]
  __shared__ __align__(16) float b_s[2][kSimtK][kSimtN + 4];  // [half][k][col]
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int m0 = blockIdx.y * kSimtM;
  const int n0 = blockIdx.x * kSimtN;
  const long long kdim = 2LL * k2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < k2; kb += kSimtK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * kSimtM * kSimtK / kSimtThreads; ++i) {
      const int idx = tid + i * kSimtThreads;
      const int half = idx / (kSimtM * kSimtK);
      const int rem = idx - half * kSimtM * kSimtK;
      const int row = rem / kSimtK;
      const int kk = rem - row * kSimtK;
      const int gr = m0 + row;
      const int gk = kb + kk;
      a_s[half][kk][row] =
          (gr < m && gk < k2) ? __ldg(x + gr * kdim + half * k2 + gk) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSimtK * kSimtN / kSimtThreads; ++i) {
      const int idx = tid + i * kSimtThreads;
      const int kk = idx / kSimtN;
      const int c = idx - kk * kSimtN;
      const int gk = kb + kk;
      const int gc = n0 + c;
      const unsigned int t =
          ((gk < k2 && gc < n)
               ? static_cast<unsigned char>(
                     __ldg(p + static_cast<long long>(gk) * n + gc))
               : 0u) ^ 0x88u;
      b_s[0][kk][c] = (gk < k2 && gc < n) ? nib_f(t & 0xFu) : 0.f;
      b_s[1][kk][c] = (gk < k2 && gc < n) ? nib_f(t >> 4) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int kk = 0; kk < kSimtK; ++kk) {
        float a[4], b[4];
        lds_row<4>(&a_s[half][kk][ty * 4], a);
        lds_row<4>(&b_s[half][kk][tx * 4], b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx * 4 + j;
      if (gc < n) out[static_cast<long long>(gr) * n + gc] = acc[i][j] * s[gc];
    }
  }
}

}  // namespace
}  // namespace die

// x [M, K] (K = 2 * k2, dtype code `dtype`), packed [k2, N] int8, scale [N]
// fp32, out [M, N] in x's dtype. `instance` names the kernel that runs
// (kInstGemv .. kInstSimt, chosen by the wrapper from shapes and
// alignment); a call it does not take returns cudaErrorInvalidValue. tile:
// the wgmma instance's tokens per block (64, 128 or 256, the wrapper's
// wgmma_tile), unused by the others. ks, chunk: the GEMV's cluster size (1,
// 2, 4 or 8) and packed rows a block (a multiple of 64, ks * chunk >= k2;
// the wrapper's int4_gemv_plan), unused by the others. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int die_int4_matmul(const void* x, const void* packed,
                               const void* scale, void* out, int m, int k2,
                               int n, int ks, int chunk, int dtype,
                               int instance, int tile, void* stream) {
  using namespace die;
  if (m <= 0 || n <= 0) return 0;
  if (k2 <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const bool bf16 = dtype == kBF16;
  if (!bf16 && dtype != kF32) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (instance) {
    case kInstGemv:
      if (m > 16 || ks < 1 || ks > kMaxCluster || (ks & (ks - 1)) ||
          chunk < kGvK || chunk % kGvK ||
          static_cast<long long>(ks) * chunk < k2)
        return cudaErrorInvalidValue;
      err = bf16 ? gemv_t<__nv_bfloat16>(x, p, s, out, m, k2, n, ks, chunk, st)
                 : gemv_t<float>(x, p, s, out, m, k2, n, ks, chunk, st);
      break;
    case kInstWgmma:
      if (!bf16 || m <= 16 || k2 % 8 || n % 16 || !aligned16(x) ||
          !aligned16(packed))
        return cudaErrorInvalidValue;
      err = wgmma_by_tile(xb, p, s, ob, m, k2, n, tile, st);
      break;
    case kInstWmma: {
      if (!bf16 || m <= 16) return cudaErrorInvalidValue;
      dim3 grid((n + kMmaN - 1) / kMmaN, (m + kMmaM - 1) / kMmaM);
      int4_mma_kernel<<<grid, kMmaThreads, 0, st>>>(xb, p, s, ob, m, k2, n);
      err = cudaGetLastError();
      break;
    }
    case kInstSimt: {
      if (bf16 || m <= 16) return cudaErrorInvalidValue;
      dim3 grid((n + kSimtN - 1) / kSimtN, (m + kSimtM - 1) / kSimtM);
      int4_simt_kernel<<<grid, kSimtThreads, 0, st>>>(
          static_cast<const float*>(x), p, s, static_cast<float*>(out), m, k2,
          n);
      err = cudaGetLastError();
      break;
    }
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
