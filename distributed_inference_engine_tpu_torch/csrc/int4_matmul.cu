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
//     thousands of rows): bound by arithmetic, 2 * M * K * N operations.
// So there are three instances, chosen by the host entry point:
//   1. M <= 16, any dtype: a GEMV. A block owns 256 output columns (32 lanes
//      x 8 adjacent columns, one 8-byte load per lane per packed row,
//      coalesced along N) and a chunk of the contraction; its 8 warps take
//      interleaved packed rows of the chunk and are summed in shared memory
//      at the end. The activations of the chunk sit in shared memory as
//      fp32, so every weight byte loaded feeds all M rows from registers.
//      The contraction is split over enough blocks to fill the card
//      (split-K, fp32 partials summed by a second kernel, which applies the
//      scale), as csrc/fused_decode.cu does.
//   2. M > 16, bf16: tensor cores, in the simplest form that is right. A
//      block computes a 128 x 128 tile of y with 8 warps (nvcuda::wmma bf16
//      16x16x16 fragments, fp32 accumulators). Per step it unpacks a 32 x 128
//      packed tile into lo and hi bf16 tiles in shared memory (the nibbles
//      are small integers, exact in bf16) beside the matching x[:, :K/2] and
//      x[:, K/2:] tiles; the next step's global loads are issued into
//      registers before the current step's products. No TMA, no wgmma, no
//      multi-stage pipeline yet.
//   3. M > 16, fp32 (the fp32 parity engines only): the same tiling on CUDA
//      cores, a 64 x 64 tile per block, 4 x 4 outputs per thread.
//
// Unpacking. A nibble of signed value v has unsigned bits u = v & 15, and
// u ^ 8 = v + 8 for every v in [-8, 7]. So the kernels flip bit 3 of every
// nibble once per 32-bit word (x ^ 0x88888888) and rebuild the value from
// float bits: fp32 0x4B000000 | (v + 8) is 2^23 + v + 8; bf16 0x4300 |
// (v + 8) is 128 + v + 8. One subtraction then gives v exactly.
//
// Edges. Every edge is bounds-checked: any M, any N, any K/2. Vector loads
// are used where the host entry point finds the shapes and pointers aligned
// for them; otherwise the same kernels load element by element.
#include <mma.h>

#include "common.cuh"

namespace die {
namespace {

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

// ------------------------------------------- large M, bf16: tensor cores

constexpr int kMmaM = 128, kMmaN = 128, kMmaK = 32;  // kMmaK packed rows
constexpr int kMmaThreads = 256;                     // 8 warps: 4 (M) x 2 (N)
constexpr int kApad = 8, kBpad = 8;                  // bf16 elements
// two resident blocks per SM (at most 128 registers a thread): with one,
// the next step's global loads have only one block's products to hide
// behind
constexpr int kMmaBlocksPerSm = 2;

template <bool VEC>
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
      if constexpr (VEC) {
        a_reg[i] = (gr < m && gk < k2)
                       ? __ldg(reinterpret_cast<const uint4*>(src))
                       : make_uint4(0, 0, 0, 0);
      } else {
        unsigned int h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = (gr < m && gk + e < k2)
                     ? __ldg(reinterpret_cast<const unsigned short*>(src) + e)
                     : 0u;
        a_reg[i] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                              h[4] | (h[5] << 16), h[6] | (h[7] << 16));
      }
    }
    const int row = tid >> 3;
    const int seg = tid & 7;
    const int gk = kb + row;
    const int gc = n0 + seg * 16;
    const int8_t* src = p + static_cast<long long>(gk) * n + gc;
    if constexpr (VEC) {
      // out-of-range weights unpack to 0 (bytes 0x88 after the flip)
      b_reg = (gk < k2 && gc < n) ? __ldg(reinterpret_cast<const uint4*>(src))
                                  : make_uint4(0, 0, 0, 0);
    } else {
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
    }
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
// fp32, out [M, N] in x's dtype. ws: fp32 [ks, M, N] scratch for a split
// contraction (M <= 16 only; unused when ks == 1); chunk: packed rows per
// split. Returns cudaGetLastError() of the launches (0 on success).
extern "C" int die_int4_matmul(const void* x, const void* packed,
                               const void* scale, void* out, void* ws, int m,
                               int k2, int n, int ks, int chunk, int dtype,
                               void* stream) {
  using namespace die;
  if (m <= 0 || n <= 0) return 0;
  if (k2 <= 0 || ks < 1 || chunk < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (m <= 16) {
    if (ks > 1 && ws == nullptr) return cudaErrorInvalidValue;
    const bool vec = n % kGemvCols == 0 && aligned16(packed);
    if (dtype == kBF16) {
      const auto* xb = static_cast<const __nv_bfloat16*>(x);
      auto* ob = static_cast<__nv_bfloat16*>(out);
      err = vec ? gemv_by_rows<__nv_bfloat16, true>(xb, p, s, w, ob, m, k2, n, ks, chunk, st)
                : gemv_by_rows<__nv_bfloat16, false>(xb, p, s, w, ob, m, k2, n, ks, chunk, st);
    } else if (dtype == kF32) {
      const auto* xf = static_cast<const float*>(x);
      auto* of = static_cast<float*>(out);
      err = vec ? gemv_by_rows<float, true>(xf, p, s, w, of, m, k2, n, ks, chunk, st)
                : gemv_by_rows<float, false>(xf, p, s, w, of, m, k2, n, ks, chunk, st);
    } else {
      err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
  }
  if (dtype == kBF16) {
    const bool vec = k2 % 8 == 0 && n % 16 == 0 && aligned16(x) &&
                     aligned16(packed);
    dim3 grid((n + kMmaN - 1) / kMmaN, (m + kMmaM - 1) / kMmaM);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (vec)
      int4_mma_kernel<true><<<grid, kMmaThreads, 0, st>>>(xb, p, s, ob, m, k2, n);
    else
      int4_mma_kernel<false><<<grid, kMmaThreads, 0, st>>>(xb, p, s, ob, m, k2, n);
    err = cudaGetLastError();
  } else if (dtype == kF32) {
    dim3 grid((n + kSimtN - 1) / kSimtN, (m + kSimtM - 1) / kSimtM);
    int4_simt_kernel<<<grid, kSimtThreads, 0, st>>>(
        static_cast<const float*>(x), p, s, static_cast<float*>(out), m, k2,
        n);
    err = cudaGetLastError();
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
