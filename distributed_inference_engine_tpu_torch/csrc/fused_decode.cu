// Decode-step GEMVs with the RMSNorm folded into the prologue
// (norm_matmul) or the residual add folded into the epilogue
// (matmul_residual).
//
// Replaces the TPU kernels ops/fused_decode.py:_norm_matmul_kernel
// (wrapper norm_matmul) and ops/fused_decode.py:_matmul_residual_kernel
// (wrapper matmul_residual) of the JAX package:
//
//   norm_matmul(x, g, w)       = (rms_norm(x, g; eps, plus_one) -> x.dtype) @ w
//   matmul_residual(x, w, res) = res + x @ w
//
// x [B, D], g [D], w [D, N], res/out [B, N], all fp32 or all bf16. The
// norm runs in fp32 in the order of ops/norms.py: mean of squares, then
// x * (1 / sqrt(ms + eps)), times the gain (+1 with plus_one), cast to x's
// dtype; the product accumulates in fp32 and is cast to x's dtype; the
// residual is added to that cast product and cast again, as `res + x @ w`
// rounds in the JAX graph.
//
// Bound on the card: at decode (B <= 64) these are GEMVs, bound by the
// weight bytes (D * N * itemsize, read once) over 3.35 TB/s.
//
// norm_matmul. The TPU kernel kept the whole [B, D] activation resident in
// VMEM and streamed [D, bn] weight blocks over a sequential grid. A block
// here owns 256 output columns (128 threads x 2 adjacent columns: one 4-
// or 8-byte load per thread per weight row, coalesced along N) and a
// chunk of the contraction axis; its batch rows' normalised activations
// for the current 128-row slice of the chunk sit in shared memory as
// [d][b], so every weight element loaded feeds all B rows from registers.
// The contraction is split over enough blocks to fill the card (split-K),
// and a second small kernel sums the fp32 partials. The inverse RMS of
// each row is computed once by a prologue kernel rather than by every
// block, which would re-read [B, D] per block.
//
// matmul_residual (matmul_residual_kernel). A block owns 128 output columns,
// a tile of 8, 16 or 32 tokens and a chunk of the contraction axis; the
// chunks of one column tile are the blocks of one thread-block cluster (up to
// 8, ops/fused_decode.py matmul_residual_plan). Each block streams its weight
// rows at full width through a ring of 2 stages of 8 KB, one in flight while
// the other is used (deeper or wider rings measured slower on the H100, with
// a tuning script not kept): bf16 weights whose rows are whole 16-byte pieces
// by TMA (two boxes of 64 columns a stage, the 128-byte swizzle, zeros past
// the matrix, one thread issuing, an mbarrier a stage; it measured faster
// than 16-byte cp.async copies), the others by cp.async (16 bytes a thread, 4
// where a row of w or x is not a whole number of 16-byte pieces), the x tile
// beside them by cp.async. bf16 runs on the tensor cores with the weights as
// the M operand and the tokens as N (mma.sync.m16n8k16: a transposed
// 16-column x 16-k weight tile from ldmatrix.trans on the swizzled boxes, the
// tokens as n8 tiles from ldmatrix), fp32 on the CUDA cores (a thread a
// column, x broadcast from shared memory); both accumulate in fp32. The
// cluster then reduces its partials through distributed shared memory in the
// same launch: each block sums the cluster's partials of 128 / cluster-size
// columns in rank order (its remote loads issued together) and applies the
// epilogue (round, add res, round). No global scratch and no second kernel.
// Batches above 32 rows tile over blockIdx.y and re-read the weights once per
// tile. Any D and even N are taken; tails are zero-filled. The x tile is
// staged by stage_tile alone, so a normalising prologue can take its place
// there. What bounds it: the weight bytes, at about four fifths of the
// data-sheet rate at K 14336 on the H100 (PERF.md), plus a fixed cost a
// launch (fill, cluster barriers, reduce) that weighs at small K.
//
// Dropped from the TPU design: the 16-row batch pad (the kernels mask rows
// >= B) and the VMEM budget gate (any D and even N are taken; at 8B the
// down projection, which the TPU left unfused, runs here too).
#include <type_traits>

#include "common.cuh"

namespace die {
namespace {

// ------------------------------------------------------------ norm_matmul

constexpr int kThreads = 128;
constexpr int kCols = 2;    // adjacent output columns per thread
constexpr int kSlice = 128; // contraction rows staged in shared memory

template <typename T>
__global__ void __launch_bounds__(256)
rms_inv_kernel(const T* __restrict__ x, float* __restrict__ rinv, int d,
               float eps) {
  __shared__ float part[8];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(x[static_cast<long long>(b) * d + i]);
    s += v * v;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < (blockDim.x >> 5); ++i) tot += part[i];
    const float ms = tot / static_cast<float>(d);
    rinv[b] = 1.0f / sqrtf(ms + eps);
  }
}

// x is normalised with rinv/gain in the prologue. Writes fp32 partials to
// ws[z, b, n] when the contraction is split (gridDim.z > 1), else the
// finished output.
template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ gain,
            const float* __restrict__ rinv, int plus_one,
            const T* __restrict__ w, float* __restrict__ ws,
            T* __restrict__ out, int bsz, int d, int n, int chunk) {
  __shared__ float hs[kSlice][BT];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int b0 = blockIdx.y * BT;
  const int d_begin = blockIdx.z * chunk;
  const int d_end = min(d, d_begin + chunk);
  float acc[BT][kCols];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int ds = d_begin; ds < d_end; ds += kSlice) {
    const int dn = min(kSlice, d_end - ds);
    __syncthreads();
    for (int i = threadIdx.x; i < kSlice * BT; i += kThreads) {
      const int dd = i / BT;
      const int r = i - dd * BT;
      const int b = b0 + r;
      float hv = 0.f;
      if (dd < dn && b < bsz) {
        const float xv = to_f(x[static_cast<long long>(b) * d + ds + dd]);
        float g = to_f(gain[ds + dd]);
        if (plus_one) g += 1.0f;
        hv = to_f(from_f<T>((xv * rinv[b]) * g));
      }
      hs[dd][r] = hv;
    }
    __syncthreads();
    if (n0 < n) {
      const T* wp = w + static_cast<long long>(ds) * n + n0;
#pragma unroll 16
      for (int dd = 0; dd < dn; ++dd) {
        float wv[kCols];
        load_row<T, kCols>(wp + static_cast<long long>(dd) * n, wv);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float hv = hs[dd][r];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] += hv * wv[c];
        }
      }
    }
  }
  if (n0 >= n) return;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int b = b0 + r;
    if (b >= bsz) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const long long o = static_cast<long long>(b) * n + n0 + c;
      if (gridDim.z > 1) {
        ws[static_cast<long long>(blockIdx.z) * bsz * n + o] = acc[r][c];
      } else {
        out[o] = from_f<T>(acc[r][c]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                     int ks, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < ks; ++k) s += ws[k * total + i];
  out[i] = from_f<T>(s);
}

template <typename T, int BT>
cudaError_t gemv(const T* x, const T* gain, const float* rinv, int plus_one,
                 const T* w, float* ws, T* out, int bsz, int d, int n,
                 int ks, int chunk, cudaStream_t st) {
  dim3 grid((n + kThreads * kCols - 1) / (kThreads * kCols),
            (bsz + BT - 1) / BT, ks);
  gemv_kernel<T, BT><<<grid, kThreads, 0, st>>>(
      x, gain, rinv, plus_one, w, ws, out, bsz, d, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return err;
  const long long total = static_cast<long long>(bsz) * n;
  splitk_reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256,
                            0, st>>>(ws, out, ks, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t norm_matmul_t(const void* xv, const void* gainv, const void* wv,
                          void* outv, float* rinv, float* ws, int bsz, int d,
                          int n, float eps, int plus_one, int ks, int chunk,
                          cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* g = static_cast<const T*>(gainv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
  rms_inv_kernel<T><<<bsz, 256, 0, st>>>(x, rinv, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bsz <= 1) return gemv<T, 1>(x, g, rinv, plus_one, w, ws, out, bsz, d, n, ks, chunk, st);
  if (bsz <= 2) return gemv<T, 2>(x, g, rinv, plus_one, w, ws, out, bsz, d, n, ks, chunk, st);
  if (bsz <= 4) return gemv<T, 4>(x, g, rinv, plus_one, w, ws, out, bsz, d, n, ks, chunk, st);
  if (bsz <= 8) return gemv<T, 8>(x, g, rinv, plus_one, w, ws, out, bsz, d, n, ks, chunk, st);
  if (bsz <= 16) return gemv<T, 16>(x, g, rinv, plus_one, w, ws, out, bsz, d, n, ks, chunk, st);
  return gemv<T, 32>(x, g, rinv, plus_one, w, ws, out, bsz, d, n, ks, chunk, st);
}

// -------------------------------------------------------- matmul_residual

constexpr int kRThreads = 128;   // 4 warps
constexpr int kRCols = 128;      // output columns a block
constexpr int kRWarpCols = kRCols / 4;
constexpr int kRMt = kRWarpCols / 16;  // 16-column m-tiles a warp
constexpr int kRStages = 2;
constexpr int kRStageW = 8192;   // weight bytes a stage
constexpr int kRMaxCluster = 8;  // the portable cluster size
static_assert(kRCols == kRThreads && kRWarpCols % 16 == 0,
              "a column a thread (fp32), whole m-tiles a warp (bf16)");

// Ring geometry for storage type T and NT 8-token tiles: a stage holds kK
// weight rows of kRCols columns (8 KB) and the [kBt][kK] x tile (rows
// padded by 16 bytes, so ldmatrix is conflict-free), stages 1 KB-aligned;
// after the loop the ring holds the block's fp32 partial [kBt][kRCols].
// bf16 weights sit in two boxes of 64 columns, 128-byte rows whose 16-byte
// chunks are XOR-swizzled by row (TMA's 128-byte swizzle: what a TMA copy
// writes, and conflict-free for ldmatrix.trans); fp32 weights in rows
// padded by 16 bytes.
template <typename T, int NT>
struct RGeo {
  static constexpr bool kSwz = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kBt = 8 * NT;
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kK = kRStageW / (kRCols * kSize);   // bf16 32, fp32 16
  static constexpr int kBox = kK * 128;
  static constexpr int kWStride = kRCols * kSize + 16;
  static constexpr int kWBytes = kSwz ? 2 * kBox : kK * kWStride;
  static constexpr int kXStride = kK * kSize + 16;
  static constexpr int kStageBytes =
      (kWBytes + kBt * kXStride + 1023) / 1024 * 1024;
  static constexpr int kPartBytes = kBt * kRCols * 4;
  static constexpr int kRing = kRStages * kStageBytes;
  static constexpr int kSmem =
      (kRing > kPartBytes ? kRing : kPartBytes) + 1024;  // + alignment
};

// Byte offset of bf16 weight element (k, col), col a multiple of 2, in a
// stage's swizzled boxes.
__device__ __forceinline__ int swz_offset(int k, int col) {
  constexpr int kBox = RGeo<__nv_bfloat16, 1>::kBox;
  return (col / 64) * kBox + k * 128 +
         ((((col % 64) / 8) ^ (k & 7)) << 4) + (col % 8) * 2;
}

// Stage weight rows [k0, k0 + kK) of columns [n0, n0 + kRCols) and the x
// tile of tokens [b0, b0 + kBt) over the same rows into dst; rows at or
// past k_end, columns past n and tokens past bsz are zeros. The weights
// come by cp.async here unless kTma (bf16 rows of whole 16-byte pieces:
// the TMA copy of matmul_residual_kernel brings them): 16-byte copies
// when kVec (rows of w and x are whole 16-byte pieces), else 4-byte copies
// (N is even) and element loads of x.
template <typename T, int NT, bool kVec, bool kTma>
__device__ __forceinline__ void stage_tile(const T* x, const T* w,
                                           char* dst, int k0, int k_end,
                                           int n0, int b0, int bsz, int d,
                                           int n) {
  using G = RGeo<T, NT>;
  if constexpr (!kTma) {
    constexpr int kPiece = kVec ? 16 : 4;
    constexpr int kPerRow = kRCols * G::kSize / kPiece;
    constexpr int kElems = kPiece / G::kSize;
    for (int i = threadIdx.x; i < G::kK * kPerRow; i += kRThreads) {
      const int row = i / kPerRow;
      const int c = i - row * kPerRow;
      const int k = k0 + row;
      const int col = n0 + c * kElems;
      const bool ok = k < k_end && col < n;
      const T* src = ok ? w + static_cast<long long>(k) * n + col : w;
      char* dd = dst + (G::kSwz ? swz_offset(row, c * kElems)
                                : row * G::kWStride + c * kPiece);
      if constexpr (kVec) {
        cp_async16(dd, src, ok);
      } else {
        cp_async4(dd, src, ok);
      }
    }
  }
  char* xd = dst + G::kWBytes;
  if constexpr (kVec) {
    constexpr int kXPer = G::kK * G::kSize / 16;
    for (int i = threadIdx.x; i < G::kBt * kXPer; i += kRThreads) {
      const int tok = i / kXPer;
      const int c = i - tok * kXPer;
      const int k = k0 + c * (16 / G::kSize);
      const bool ok = b0 + tok < bsz && k < k_end;
      const T* src = ok ? x + static_cast<long long>(b0 + tok) * d + k : x;
      cp_async16(xd + tok * G::kXStride + c * 16, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < G::kBt * G::kK; i += kRThreads) {
      const int tok = i / G::kK;
      const int kk = i - tok * G::kK;
      const int k = k0 + kk;
      T v = from_f<T>(0.f);
      if (b0 + tok < bsz && k < k_end)
        v = x[static_cast<long long>(b0 + tok) * d + k];
      reinterpret_cast<T*>(xd + tok * G::kXStride)[kk] = v;
    }
  }
}

// bf16, tensor cores: warp w owns columns [w kRWarpCols, (w + 1)
// kRWarpCols) of the tile, 16-column m-tiles; acc[mt][nt] holds (column w
// kRWarpCols + 16mt + lane/4 (+8), token 8nt + 2 (lane % 4) (+1)) in the
// mma.sync accumulator layout.
template <int NT>
__device__ __forceinline__ void mma_tile(const char* st,
                                         float (&acc)[kRMt][NT][4]) {
  using G = RGeo<__nv_bfloat16, NT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const char* xt = st + G::kWBytes;
#pragma unroll
  for (int kq = 0; kq < G::kK / 32; ++kq) {
    // the tokens' B fragments of k-steps 2kq and 2kq + 1
    uint32_t xb[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      ldsm_x4(xb[nt], xt + (8 * nt + lane % 8) * G::kXStride +
                          (kq * 32 + (lane / 8) * 8) * 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kq * 32 + h * 16 + lane % 8 + (lane / 16) * 8;
#pragma unroll
      for (int mt = 0; mt < kRMt; ++mt) {
        // A = w^T: 16 columns x 16 k, transposed by ldmatrix
        uint32_t wa[4];
        ldsm_x4_trans(wa, st + swz_offset(row, kRWarpCols * warp + 16 * mt +
                                                   ((lane / 8) % 2) * 8));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16_16816(acc[mt][nt], wa, xb[nt][2 * h], xb[nt][2 * h + 1]);
      }
    }
  }
}

// fp32, CUDA cores: thread t owns column t of the tile, acc[b] of token b.
template <int NT>
__device__ __forceinline__ void simt_tile(const char* st,
                                          float (&acc)[8 * NT]) {
  using G = RGeo<float, NT>;
  const char* xt = st + G::kWBytes;
#pragma unroll 2
  for (int k = 0; k < G::kK; k += 4) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = reinterpret_cast<const float*>(st + (k + i) * G::kWStride)
          [threadIdx.x];
#pragma unroll
    for (int b = 0; b < G::kBt; ++b) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xt + b * G::kXStride + k * 4);
      acc[b] += xv.x * wv[0];
      acc[b] += xv.y * wv[1];
      acc[b] += xv.z * wv[2];
      acc[b] += xv.w * wv[3];
    }
  }
}

// kTma (bf16, rows of whole 16-byte pieces): thread 0 brings each stage's
// weight boxes by TMA (wmap: w as [d rows][n columns], boxes of 64 x kK,
// 128-byte swizzle, zeros past d and n), tracked by an mbarrier a stage;
// the x tile still comes by cp.async. Otherwise wmap is not read.
template <typename T, int NT, bool kVec>
__global__ void __launch_bounds__(kRThreads)
matmul_residual_kernel(const __grid_constant__ CUtensorMap wmap,
                       const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ res, T* __restrict__ out,
                       int bsz, int d, int n, int chunk) {
  using G = RGeo<T, NT>;
  constexpr bool kMma = G::kSwz;
  constexpr bool kTma = kMma && kVec;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  __shared__ __align__(8) uint64_t full[kRStages];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int ks = static_cast<int>(cl.num_blocks());  // along x
  const int rank = static_cast<int>(cl.block_rank());
  const int n0 = (blockIdx.x / ks) * kRCols;
  const int b0 = blockIdx.y * G::kBt;
  const int k_begin = rank * chunk;
  const int k_end = min(d, k_begin + chunk);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + G::kK - 1) / G::kK
                                   : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kRStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // stage tile t: its weights (TMA or cp.async) and x tile (cp.async)
  auto issue = [&](int t) {
    char* st = smem + (t % kRStages) * G::kStageBytes;
    const int k0 = k_begin + t * G::kK;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &full[t % kRStages];
        mbar_expect_tx(bar, G::kWBytes);
        tma_load_2d(st, &wmap, n0, k0, bar);
        tma_load_2d(st + G::kBox, &wmap, n0 + 64, k0, bar);
      }
    }
    stage_tile<T, NT, kVec, kTma>(x, w, st, k0, k_end, n0, b0, bsz, d, n);
  };

  float acc_m[kRMt][NT][4];
  float acc_s[8 * NT];
  if constexpr (kMma) {
#pragma unroll
    for (int mt = 0; mt < kRMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_m[mt][nt][e] = 0.f;
  } else {
#pragma unroll
    for (int b = 0; b < 8 * NT; ++b) acc_s[b] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kRStages - 1; ++t) {
    if (t < n_kt) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_kt; ++t) {
    const int tn = t + kRStages - 1;
    if (tn < n_kt) issue(tn);
    cp_async_commit();
    cp_async_wait<kRStages - 1>();  // tile t's copies landed (this thread's)
    if constexpr (kTma) mbar_wait(&full[t % kRStages], (t / kRStages) & 1);
    __syncthreads();                // ... and every thread's
    const char* st = smem + (t % kRStages) * G::kStageBytes;
    if constexpr (kMma) {
      mma_tile<NT>(st, acc_m);
    } else {
      simt_tile<NT>(st, acc_s);
    }
    __syncthreads();                // the stage is free again
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's partial [kBt][kRCols] over the ring
  float* part = reinterpret_cast<float*>(smem);
  if constexpr (kMma) {
#pragma unroll
    for (int mt = 0; mt < kRMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(8 * nt + 2 * (lane % 4) + (e & 1)) * kRCols +
               kRWarpCols * warp + 16 * mt + lane / 4 + 8 * (e >> 1)] =
              acc_m[mt][nt][e];
  } else {
#pragma unroll
    for (int b = 0; b < 8 * NT; ++b)
      part[b * kRCols + threadIdx.x] = acc_s[b];
  }
  cl.sync();   // every partial of the cluster written

  // block `rank` sums the cluster's partials of its kRCols / ks columns
  // and writes them: round the product, add res, round again
  const int per = kRCols / ks;
  for (int i = threadIdx.x; i < G::kBt * per; i += kRThreads) {
    const int tok = i / per;
    const int c = rank * per + (i - tok * per);
    const float s = cluster_sum<kRMaxCluster>(part, tok * kRCols + c);
    const int b = b0 + tok;
    const int col = n0 + c;
    if (b < bsz && col < n) {
      const long long o = static_cast<long long>(b) * n + col;
      out[o] = from_f<T>(to_f(from_f<T>(s)) + to_f(res[o]));
    }
  }
  cl.sync();   // no block leaves while its partial is read
}

template <typename T, int NT, bool kVec>
cudaError_t launch_residual(const T* x, const T* w, const T* res, T* out,
                            int bsz, int d, int n, int ks, int chunk,
                            cudaStream_t st) {
  using G = RGeo<T, NT>;
  CUtensorMap wmap = {};
  if constexpr (G::kSwz && kVec) {
    // w as [d rows][n columns], boxes of 64 columns x kK rows
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(d)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * G::kSize};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(G::kK)};
    const cuuint32_t ones[2] = {1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<T*>(w), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  static bool attr_set = false;  // per instantiation (one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_residual_kernel<T, NT, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + kRCols - 1) / kRCols) * ks,
                     (bsz + G::kBt - 1) / G::kBt, 1);
  cfg.blockDim = dim3(kRThreads, 1, 1);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, matmul_residual_kernel<T, NT, kVec>, wmap, x,
                         w, res, out, bsz, d, n, chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t residual_by_tile(const void* x, const void* w, const void* res,
                             void* out, int bsz, int d, int n, int ks,
                             int chunk, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (bsz <= 8)
    return launch_residual<T, 1, kVec>(xt, wt, rt, ot, bsz, d, n, ks, chunk,
                                       st);
  if (bsz <= 16)
    return launch_residual<T, 2, kVec>(xt, wt, rt, ot, bsz, d, n, ks, chunk,
                                       st);
  return launch_residual<T, 4, kVec>(xt, wt, rt, ot, bsz, d, n, ks, chunk,
                                     st);
}

template <typename T>
cudaError_t residual_t(const void* x, const void* w, const void* res,
                       void* out, int bsz, int d, int n, int ks, int chunk,
                       cudaStream_t st) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  if ((static_cast<long long>(n) * kSize) % 16 == 0 &&
      (static_cast<long long>(d) * kSize) % 16 == 0)
    return residual_by_tile<T, true>(x, w, res, out, bsz, d, n, ks, chunk,
                                     st);
  return residual_by_tile<T, false>(x, w, res, out, bsz, d, n, ks, chunk,
                                    st);
}

}  // namespace
}  // namespace die

// rinv: fp32 [B] scratch; ws: fp32 [ks, B, N] scratch (unused when
// ks == 1). Returns cudaGetLastError() of the launches (0 on success).
extern "C" int die_norm_matmul(const void* x, const void* gain,
                               const void* w, void* out, void* rinv,
                               void* ws, int bsz, int d, int n, float eps,
                               int plus_one, int ks, int chunk, int dtype,
                               void* stream) {
  using namespace die;
  if (bsz <= 0 || n <= 0) return 0;
  if (n % kCols || ks < 1 || chunk < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rinv);
  float* p = static_cast<float*>(ws);
  cudaError_t err;
  if (dtype == kBF16)
    err = norm_matmul_t<__nv_bfloat16>(x, gain, w, out, r, p, bsz, d, n, eps, plus_one, ks, chunk, st);
  else if (dtype == kF32)
    err = norm_matmul_t<float>(x, gain, w, out, r, p, bsz, d, n, eps, plus_one, ks, chunk, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// One launch: ks blocks of a cluster split the contraction into chunks of
// `chunk` rows (a multiple of the stage depth: 32 bf16, 16 fp32) and
// reduce through distributed shared memory. ks is 1, 2, 4 or 8 and ks *
// chunk covers d (ops/fused_decode.py matmul_residual_plan). bf16 runs
// the tensor cores, fp32 the CUDA cores. Returns the launch's error (0 on
// success).
extern "C" int die_matmul_residual(const void* x, const void* w,
                                   const void* res, void* out, int bsz,
                                   int d, int n, int ks, int chunk,
                                   int dtype, void* stream) {
  using namespace die;
  if (bsz <= 0 || n <= 0) return 0;
  const int depth = dtype == kBF16 ? RGeo<__nv_bfloat16, 1>::kK
                                    : RGeo<float, 1>::kK;
  if (n % 2 || d <= 0 || ks < 1 || ks > kRMaxCluster || (ks & (ks - 1)) ||
      chunk < depth || chunk % depth ||
      static_cast<long long>(ks) * chunk < d)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16)
    err = residual_t<__nv_bfloat16>(x, w, res, out, bsz, d, n, ks, chunk, st);
  else if (dtype == kF32)
    err = residual_t<float>(x, w, res, out, bsz, d, n, ks, chunk, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
