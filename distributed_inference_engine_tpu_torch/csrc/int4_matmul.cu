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
//   gemv  (M <= 16, any dtype): a block owns 256 output columns (32 lanes x
//         8 adjacent columns, one 8-byte load per lane per packed row,
//         coalesced along N) and a chunk of the contraction; its 8 warps
//         take interleaved packed rows of the chunk and are summed in
//         shared memory at the end. The activations of the chunk sit in
//         shared memory as fp32, so every weight byte loaded feeds all M
//         rows from registers. The contraction is split over enough blocks
//         to fill the card (split-K, fp32 partials summed by a second
//         kernel, which applies the scale), as csrc/fused_decode.cu does.
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
// unpack (about 2.5 integer operations per weight beside each wgmma: the
// likeliest cause of the gap to the operations bound at large M, not yet
// measured apart), and at M <= 64 with N = 4096 runs 32 blocks on 132 SMs
// (no split-K yet). The GEMV and simt instances are as in their first
// version.
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

// ------------------------------------------------------------------ GEMV

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvCols = 8;                  // columns (bytes) per lane
constexpr int kGemvBlockCols = 32 * kGemvCols;
constexpr int kGemvSlice = 64;                // packed rows staged per pass

template <typename T, int BT, bool VEC>
__global__ void __launch_bounds__(kGemvThreads)
int4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ p,
                 const float* __restrict__ s, float* __restrict__ ws,
                 T* __restrict__ out, int m, int k2, int n, int chunk) {
  __shared__ float xs[2][kGemvSlice][BT];
  __shared__ float red[kGemvWarps][kGemvBlockCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kGemvBlockCols + lane * kGemvCols;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k2, k_begin + chunk);
  const long long kdim = 2LL * k2;

  float acc[BT][kGemvCols];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) acc[r][c] = 0.f;

  for (int ks = k_begin; ks < k_end; ks += kGemvSlice) {
    const int kn = min(kGemvSlice, k_end - ks);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kGemvSlice * BT; i += kGemvThreads) {
      const int half = i / (kGemvSlice * BT);
      const int rem = i - half * kGemvSlice * BT;
      const int kk = rem / BT;
      const int r = rem - kk * BT;
      float v = 0.f;
      if (kk < kn && r < m)
        v = to_f(x[r * kdim + static_cast<long long>(half) * k2 + ks + kk]);
      xs[half][kk][r] = v;
    }
    __syncthreads();
    if (c0 >= n) continue;
#pragma unroll 4
    for (int kk = warp; kk < kn; kk += kGemvWarps) {
      const int8_t* row = p + static_cast<long long>(ks + kk) * n + c0;
      unsigned int words[kGemvCols / 4];
      if constexpr (VEC) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
        words[0] = v.x;
        words[1] = v.y;
      } else {
#pragma unroll
        for (int w = 0; w < kGemvCols / 4; ++w) {
          unsigned int word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = 4 * w + b;
            const unsigned int byte =
                c0 + c < n ? static_cast<unsigned char>(__ldg(row + c)) : 0u;
            word |= byte << (8 * b);
          }
          words[w] = word;
        }
      }
      float lo[kGemvCols], hi[kGemvCols];
#pragma unroll
      for (int w = 0; w < kGemvCols / 4; ++w) {
        const unsigned int t = words[w] ^ 0x88888888u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          lo[4 * w + b] = nib_f((t >> (8 * b)) & 0xFu);
          hi[4 * w + b] = nib_f((t >> (8 * b + 4)) & 0xFu);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float xl = xs[0][kk][r];
        const float xh = xs[1][kk][r];
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c)
          acc[r][c] = fmaf(xl, lo[c], fmaf(xh, hi[c], acc[r][c]));
      }
    }
  }

  // sum the warps' partials, one batch row at a time
  const int col = blockIdx.x * kGemvBlockCols + threadIdx.x;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    if (r >= m) break;  // uniform across the block
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c)
      red[warp][lane * kGemvCols + c] = acc[r][c];
    __syncthreads();
    if (col < n) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) sum += red[w][threadIdx.x];
      const long long o = static_cast<long long>(r) * n + col;
      if (gridDim.z > 1)
        ws[static_cast<long long>(blockIdx.z) * m * n + o] = sum;
      else
        out[o] = from_f<T>(sum * s[col]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
int4_splitk_reduce_kernel(const float* __restrict__ ws,
                          const float* __restrict__ s, T* __restrict__ out,
                          int ks, int n, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int k = 0; k < ks; ++k) sum += ws[k * total + i];
  out[i] = from_f<T>(sum * s[i % n]);
}

template <typename T, bool VEC>
cudaError_t gemv_by_rows(const T* x, const int8_t* p, const float* s,
                         float* ws, T* out, int m, int k2, int n, int ks,
                         int chunk, cudaStream_t st) {
  dim3 grid((n + kGemvBlockCols - 1) / kGemvBlockCols, 1, ks);
#define DIE_GEMV(BT)                                                      \
  int4_gemv_kernel<T, BT, VEC>                                            \
      <<<grid, kGemvThreads, 0, st>>>(x, p, s, ws, out, m, k2, n, chunk)
  if (m <= 1)
    DIE_GEMV(1);
  else if (m <= 2)
    DIE_GEMV(2);
  else if (m <= 4)
    DIE_GEMV(4);
  else if (m <= 8)
    DIE_GEMV(8);
  else
    DIE_GEMV(16);
#undef DIE_GEMV
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return err;
  const long long total = static_cast<long long>(m) * n;
  int4_splitk_reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256),
                                 256, 0, st>>>(ws, s, out, ks, n, total);
  return cudaGetLastError();
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
// unpacks its own fragments of the stage (four 2-byte loads and 16 bf16
// pairs per k16 step) and issues 8 wgmma (4 k16 steps for each half); the
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

// The packed tile [64 k][128 n] arrives by TMA with the 128-byte swizzle
// (16-byte chunk j of row k stored at chunk j ^ (k & 7)), so that the
// fragment loads below, four rows apart in k, hit distinct banks.
__device__ __forceinline__ unsigned int packed_pair(const unsigned char* pt,
                                                    int k, int nrow) {
  return *reinterpret_cast<const unsigned short*>(
      pt + k * 128 + ((((nrow >> 4) ^ (k & 7))) << 4) + (nrow & 15));
}

// The A fragments of one stage for the thread whose fragment rows are
// weight columns nrow and nrow + 1 (q = lane / 4) and whose fragment
// columns are k = 2c, 2c + 1, 2c + 8, 2c + 9 (c = lane % 4) of each k16
// step: fr[kk] the lo weights of step kk, fr[4 + kk] the hi ones. Two bytes
// (columns nrow, nrow + 1) of packed rows k and k + 1 make one word
// [k n, k n+1, k+1 n, k+1 n+1]; its lo nibbles at bits 0 and 16 are the
// bf16 pair of column nrow, at bits 8 and 24 that of nrow + 1, and the hi
// nibbles four bits up.
__device__ __forceinline__ void unpack_fragments(const unsigned char* pt,
                                                 int nrow, int c,
                                                 uint32_t (&fr)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    const int k0 = kk * 16 + 2 * c;
    const unsigned int t01 = (packed_pair(pt, k0, nrow) |
                              (packed_pair(pt, k0 + 1, nrow) << 16)) ^
                             0x88888888u;
    const unsigned int t89 = (packed_pair(pt, k0 + 8, nrow) |
                              (packed_pair(pt, k0 + 9, nrow) << 16)) ^
                             0x88888888u;
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
      unpack_fragments(stage + 2 * L::kXTile, nrow, c, cur);
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

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace
}  // namespace die

// x [M, K] (K = 2 * k2, dtype code `dtype`), packed [k2, N] int8, scale [N]
// fp32, out [M, N] in x's dtype. `instance` names the kernel that runs
// (kInstGemv .. kInstSimt, chosen by the wrapper from shapes and
// alignment); a call it does not take returns cudaErrorInvalidValue. tile:
// the wgmma instance's tokens per block (64, 128 or 256, the wrapper's
// wgmma_tile), unused by the others. ws:
// fp32 [ks, M, N] scratch for the GEMV's split contraction (unused when
// ks == 1); chunk: packed rows per split. Returns cudaGetLastError() of the
// launches (0 on success).
extern "C" int die_int4_matmul(const void* x, const void* packed,
                               const void* scale, void* out, void* ws, int m,
                               int k2, int n, int ks, int chunk, int dtype,
                               int instance, int tile, void* stream) {
  using namespace die;
  if (m <= 0 || n <= 0) return 0;
  if (k2 <= 0 || ks < 1 || chunk < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const bool bf16 = dtype == kBF16;
  if (!bf16 && dtype != kF32) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (instance) {
    case kInstGemv: {
      if (m > 16 || (ks > 1 && ws == nullptr)) return cudaErrorInvalidValue;
      float* w = static_cast<float*>(ws);
      const bool vec = n % kGemvCols == 0 && aligned16(packed);
      if (bf16) {
        err = vec ? gemv_by_rows<__nv_bfloat16, true>(xb, p, s, w, ob, m, k2, n, ks, chunk, st)
                  : gemv_by_rows<__nv_bfloat16, false>(xb, p, s, w, ob, m, k2, n, ks, chunk, st);
      } else {
        const auto* xf = static_cast<const float*>(x);
        auto* of = static_cast<float*>(out);
        err = vec ? gemv_by_rows<float, true>(xf, p, s, w, of, m, k2, n, ks, chunk, st)
                  : gemv_by_rows<float, false>(xf, p, s, w, of, m, k2, n, ks, chunk, st);
      }
      break;
    }
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
