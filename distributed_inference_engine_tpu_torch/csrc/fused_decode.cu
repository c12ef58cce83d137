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
// One core, cluster_gemv, serves both (kernels norm_matmul_kernel and
// matmul_residual_kernel). A block owns 128 output columns, a tile of 8, 16
// or 32 tokens and a chunk of the contraction axis; the chunks of one column
// tile are the blocks of one thread-block cluster (up to 8,
// ops/fused_decode.py gemv_plan). Each block streams its weight rows at full
// width through a ring of 2 stages of 8 KB, one in flight while the other is
// used (deeper or wider rings measured slower on the H100, with a tuning
// script not kept): bf16 weights whose rows are whole 16-byte pieces by TMA
// (two boxes of 64 columns a stage, the 128-byte swizzle, zeros past the
// matrix, one thread issuing, an mbarrier a stage; it measured faster than
// 16-byte cp.async copies), the others by cp.async (16 bytes a thread, 4
// where a row of w or x is not a whole number of 16-byte pieces). bf16 runs
// on the tensor cores with the weights as the M operand and the tokens as N
// (mma.sync.m16n8k16: a transposed 16-column x 16-k weight tile from
// ldmatrix.trans on the swizzled boxes, the tokens as n8 tiles from
// ldmatrix), fp32 on the CUDA cores (a thread a column, x broadcast from
// shared memory); both accumulate in fp32. The cluster then reduces its
// partials through distributed shared memory in the same launch: each block
// sums the cluster's partials of 128 / cluster-size columns in rank order
// (its remote loads issued together) and applies the epilogue. No global
// scratch and no second kernel. Batches above 32 rows tile over blockIdx.y
// and re-read the weights once per tile. Any D and even N are taken; tails
// are zero-filled.
//
// What the two differ in:
//   matmul_residual: the x tile of a stage comes by cp.async beside the
//     weights; the epilogue rounds the product, adds res and rounds again.
//   norm_matmul: the row's inverse RMS needs all of D, of which each block
//     of the cluster holds one chunk. So the block issues its first weight
//     stage, then sums the squares of its own x chunk for its tokens in fp32
//     (sum_squares), the cluster exchanges these partials through
//     distributed shared memory, and every block adds them in rank order,
//     so each block gets the same 1 / sqrt(ms + eps) for a row. The x tile
//     of a stage then goes through registers (NormX): loaded from global one
//     stage ahead, beside the stage's weight copy, and after the current
//     stage's products normalised, h = to_T((x * rinv) * (g (+1))), and
//     stored into the next stage where the tile code reads x. The epilogue
//     rounds the product once. So the norm costs one read of the block's x
//     chunk (L2) and one cluster barrier before the loop, overlapped with
//     the first weight stage, and no extra kernel, barrier or scratch.
//
// What bounds it: the weight bytes, at about four fifths of the data-sheet
// rate at K 14336 on the H100 (PERF.md), plus a fixed cost a launch (fill,
// cluster barriers, reduce; the norm's prologue) that weighs at small K or
// N.
//
// Dropped from the TPU design: the 16-row batch pad (the kernels mask rows
// >= B) and the VMEM budget gate (any D and even N are taken; at 8B the
// down projection, which the TPU left unfused, runs here too).
#include <type_traits>

#include "common.cuh"

namespace die {
namespace {

constexpr int kRThreads = 128;   // 4 warps
constexpr int kRCols = 128;      // output columns a block
constexpr int kRWarpCols = kRCols / 4;
constexpr int kRMt = kRWarpCols / 16;  // 16-column m-tiles a warp
constexpr int kRStages = 2;
constexpr int kRStageW = 8192;   // weight bytes a stage
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

// Stage weight rows [k0, k0 + kK) of columns [n0, n0 + kRCols) into dst by
// cp.async; rows at or past k_end and columns past n are zeros. 16-byte
// copies when kVec (rows of w are whole 16-byte pieces), else 4-byte copies
// (N is even). (bf16 rows of whole 16-byte pieces come by TMA instead.)
template <typename T, int NT, bool kVec>
__device__ __forceinline__ void stage_w(const T* w, char* dst, int k0,
                                        int k_end, int n0, int n) {
  using G = RGeo<T, NT>;
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

// Stage the x tile of tokens [b0, b0 + kBt) over rows [k0, k0 + kK) beside
// the weights in dst (matmul_residual); tokens past bsz and rows at or past
// k_end are zeros. cp.async of 16 bytes when kVec, else element loads.
template <typename T, int NT, bool kVec>
__device__ __forceinline__ void stage_x(const T* x, char* dst, int k0,
                                        int k_end, int b0, int bsz, int d) {
  using G = RGeo<T, NT>;
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

// norm_matmul's x tile through registers: load() reads a stage's x and gain
// pieces from global (16 bytes each when kVec, else one element), store()
// writes h = to_T((x * rinv[tok]) * (g + plus)) where the tile code reads x.
// A thread holds kPer pieces; tokens past bsz and rows at or past k_end are
// zeros (so h is 0 there).
template <typename T, int NT, bool kVec>
struct NormX {
  using G = RGeo<T, NT>;
  static constexpr int kE = kVec ? 16 / G::kSize : 1;  // elements a piece
  static constexpr int kRow = G::kK / kE;               // pieces a token
  static constexpr int kPieces = G::kBt * kRow;
  static constexpr int kPer = (kPieces + kRThreads - 1) / kRThreads;
  uint4 xv[kPer];   // kVec
  uint4 gv[kPer];
  T xe[kPer];       // element loads
  T ge[kPer];

  __device__ __forceinline__ void load(const T* x, const T* gain, int k0,
                                       int k_end, int b0, int bsz, int d) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kRThreads;
      const int tok = i / kRow;
      const int k = k0 + (i - tok * kRow) * kE;
      const bool ok = i < kPieces && b0 + tok < bsz && k < k_end;
      const long long o = static_cast<long long>(b0 + tok) * d + k;
      if constexpr (kVec) {
        xv[j] = ok ? __ldg(reinterpret_cast<const uint4*>(x + o))
                   : make_uint4(0, 0, 0, 0);
        gv[j] = ok ? __ldg(reinterpret_cast<const uint4*>(gain + k))
                   : make_uint4(0, 0, 0, 0);
      } else {
        xe[j] = ok ? x[o] : from_f<T>(0.f);
        ge[j] = ok ? gain[k] : from_f<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void store(char* xd, const float* rinv,
                                        float plus) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kRThreads;
      if (i >= kPieces) break;
      const int tok = i / kRow;
      const int kk = (i - tok * kRow) * kE;
      const float r = rinv[tok];
      char* dst = xd + tok * G::kXStride + kk * G::kSize;
      if constexpr (kVec) {
        const T* xs = reinterpret_cast<const T*>(&xv[j]);
        const T* gs = reinterpret_cast<const T*>(&gv[j]);
        alignas(16) T h[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e)
          h[e] = from_f<T>((to_f(xs[e]) * r) * (to_f(gs[e]) + plus));
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
      } else {
        *reinterpret_cast<T*>(dst) =
            from_f<T>((to_f(xe[j]) * r) * (to_f(ge[j]) + plus));
      }
    }
  }
};

// fp32 sums of squares of x[b0 + tok][k_begin, k_end) into ss[tok] for the
// block's kBt tokens (0 past bsz): warp w takes tokens w, w + 4, ..., its
// lanes 16-byte pieces (one element unless kVec) strided along k.
template <typename T, int NT, bool kVec>
__device__ __forceinline__ void sum_squares(const T* x, float* ss,
                                            int k_begin, int k_end, int b0,
                                            int bsz, int d) {
  using G = RGeo<T, NT>;
  constexpr int kE = kVec ? 16 / G::kSize : 1;
  constexpr int kTok = G::kBt / 4;   // tokens a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[kTok];
#pragma unroll
  for (int j = 0; j < kTok; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int k = k_begin + lane * kE; k < k_end; k += 32 * kE) {
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int b = b0 + warp + 4 * j;
      if (b < bsz) {
        float v[kE];
        load_row<T, kE>(x + static_cast<long long>(b) * d + k, v);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[j] = fmaf(v[e], v[e], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) ss[warp + 4 * j] = s;
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

// The core of both kernels (kNorm: norm_matmul, else matmul_residual). kTma
// (bf16, rows of whole 16-byte pieces): thread 0 brings each stage's weight
// boxes by TMA (wmap: w as [d rows][n columns], boxes of 64 x kK, 128-byte
// swizzle, zeros past d and n), tracked by an mbarrier a stage. Otherwise
// wmap is not read. res is read only by matmul_residual; gain, eps and plus
// (1 with plus_one, else 0) only by norm_matmul.
template <typename T, int NT, bool kVec, bool kNorm>
__device__ __forceinline__ void cluster_gemv(
    const CUtensorMap* wmap, const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ res, const T* __restrict__ gain, T* __restrict__ out,
    int bsz, int d, int n, int chunk, float eps, float plus) {
  using G = RGeo<T, NT>;
  constexpr bool kMma = G::kSwz;
  constexpr bool kTma = kMma && kVec;
  static_assert(!kNorm || kRStages == 2,
                "NormX holds one stage's x: the one stage issued ahead");
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  __shared__ __align__(8) uint64_t full[kRStages];
  __shared__ float ss[G::kBt];     // norm: this block's sums of squares
  __shared__ float rinv[G::kBt];   // norm: each token's 1 / rms
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
  NormX<T, NT, kVec> hx;
  // stage tile t: its weights (TMA or cp.async) and its x tile (cp.async;
  // for the norm, into registers, stored by put_h)
  auto issue = [&](int t) {
    char* st = smem + (t % kRStages) * G::kStageBytes;
    const int k0 = k_begin + t * G::kK;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &full[t % kRStages];
        mbar_expect_tx(bar, G::kWBytes);
        tma_load_2d(st, wmap, n0, k0, bar);
        tma_load_2d(st + G::kBox, wmap, n0 + 64, k0, bar);
      }
    } else {
      stage_w<T, NT, kVec>(w, st, k0, k_end, n0, n);
    }
    if constexpr (kNorm) {
      hx.load(x, gain, k0, k_end, b0, bsz, d);
    } else {
      stage_x<T, NT, kVec>(x, st, k0, k_end, b0, bsz, d);
    }
  };
  auto put_h = [&](int t) {
    hx.store(smem + (t % kRStages) * G::kStageBytes + G::kWBytes, rinv,
             plus);
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
  if constexpr (kNorm) {
    // the rows' inverse RMS over all of D: this block's partial sums of
    // squares, exchanged in the cluster and added in rank order
    sum_squares<T, NT, kVec>(x, ss, k_begin, k_end, b0, bsz, d);
    cl.sync();
    if (threadIdx.x < G::kBt) {
      const float s = cluster_sum(ss, threadIdx.x);
      rinv[threadIdx.x] = 1.0f / sqrtf(s / static_cast<float>(d) + eps);
    }
    __syncthreads();
    if (n_kt > 0) put_h(0);
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
    if constexpr (kNorm) {
      if (tn < n_kt) put_h(tn);     // that stage was freed by the last barrier
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
  // the cluster's sums (no block leaves while its partial, or ss, is
  // read): norm_matmul rounds the product; matmul_residual rounds it, adds
  // res and rounds again
  cluster_reduce<kRCols, kRThreads>(
      part, G::kBt, [&](int tok, int c, float s) {
        const int b = b0 + tok;
        const int col = n0 + c;
        if (b >= bsz || col >= n) return;
        const long long o = static_cast<long long>(b) * n + col;
        if constexpr (kNorm) {
          out[o] = from_f<T>(s);
        } else {
          out[o] = from_f<T>(to_f(from_f<T>(s)) + to_f(res[o]));
        }
      });
}

template <typename T, int NT, bool kVec>
__global__ void __launch_bounds__(kRThreads)
matmul_residual_kernel(const __grid_constant__ CUtensorMap wmap,
                       const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ res, T* __restrict__ out,
                       int bsz, int d, int n, int chunk) {
  cluster_gemv<T, NT, kVec, false>(&wmap, x, w, res, nullptr, out, bsz, d, n,
                                   chunk, 0.f, 0.f);
}

template <typename T, int NT, bool kVec>
__global__ void __launch_bounds__(kRThreads)
norm_matmul_kernel(const __grid_constant__ CUtensorMap wmap,
                   const T* __restrict__ x, const T* __restrict__ gain,
                   const T* __restrict__ w, T* __restrict__ out, int bsz,
                   int d, int n, int chunk, float eps, float plus) {
  cluster_gemv<T, NT, kVec, true>(&wmap, x, w, nullptr, gain, out, bsz, d, n,
                                  chunk, eps, plus);
}

// One launch of the kNorm (norm_matmul) or residual kernel instance: a grid
// of column tiles x ks (one cluster each) by token tiles.
template <typename T, int NT, bool kVec, bool kNorm>
cudaError_t launch_gemv(const T* x, const T* w, const T* res, const T* gain,
                        T* out, int bsz, int d, int n, int ks, int chunk,
                        float eps, float plus, cudaStream_t st) {
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
  const dim3 grid(((n + kRCols - 1) / kRCols) * ks,
                  (bsz + G::kBt - 1) / G::kBt, 1);
  if constexpr (kNorm) {
    return launch_cluster<norm_matmul_kernel<T, NT, kVec>>(
        grid, kRThreads, ks, G::kSmem, st, wmap, x, gain, w, out, bsz, d, n,
        chunk, eps, plus);
  } else {
    return launch_cluster<matmul_residual_kernel<T, NT, kVec>>(
        grid, kRThreads, ks, G::kSmem, st, wmap, x, w, res, out, bsz, d, n,
        chunk);
  }
}

template <typename T, bool kVec, bool kNorm>
cudaError_t gemv_by_tile(const void* x, const void* w, const void* res,
                         const void* gain, void* out, int bsz, int d, int n,
                         int ks, int chunk, float eps, float plus,
                         cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* rt = static_cast<const T*>(res);
  const T* gt = static_cast<const T*>(gain);
  T* ot = static_cast<T*>(out);
  if (bsz <= 8)
    return launch_gemv<T, 1, kVec, kNorm>(xt, wt, rt, gt, ot, bsz, d, n, ks,
                                          chunk, eps, plus, st);
  if (bsz <= 16)
    return launch_gemv<T, 2, kVec, kNorm>(xt, wt, rt, gt, ot, bsz, d, n, ks,
                                          chunk, eps, plus, st);
  return launch_gemv<T, 4, kVec, kNorm>(xt, wt, rt, gt, ot, bsz, d, n, ks,
                                        chunk, eps, plus, st);
}

// kVec: rows of w and x (and the gain's pieces) are whole 16-byte pieces
template <typename T, bool kNorm>
cudaError_t gemv_t(const void* x, const void* w, const void* res,
                   const void* gain, void* out, int bsz, int d, int n, int ks,
                   int chunk, float eps, float plus, cudaStream_t st) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  if ((static_cast<long long>(n) * kSize) % 16 == 0 &&
      (static_cast<long long>(d) * kSize) % 16 == 0)
    return gemv_by_tile<T, true, kNorm>(x, w, res, gain, out, bsz, d, n, ks,
                                        chunk, eps, plus, st);
  return gemv_by_tile<T, false, kNorm>(x, w, res, gain, out, bsz, d, n, ks,
                                       chunk, eps, plus, st);
}

// The launch plan's checks shared by both entry points: ks is 1, 2, 4 or
// 8, chunk a multiple of the stage depth (32 rows bf16, 16 fp32) and ks *
// chunk covers d (ops/fused_decode.py gemv_plan); N is even.
bool plan_ok(int d, int n, int ks, int chunk, int dtype) {
  const int depth = dtype == kBF16 ? RGeo<__nv_bfloat16, 1>::kK
                                    : RGeo<float, 1>::kK;
  return n % 2 == 0 && d > 0 && ks >= 1 && ks <= kMaxCluster &&
         (ks & (ks - 1)) == 0 && chunk >= depth && chunk % depth == 0 &&
         static_cast<long long>(ks) * chunk >= d;
}

}  // namespace
}  // namespace die

// One launch: ks blocks of a cluster split the contraction into chunks of
// `chunk` rows and reduce through distributed shared memory, the norm's
// inverse RMS exchanged the same way. bf16 runs the tensor cores, fp32 the
// CUDA cores. plus_one adds 1 to the gain (in fp32). Returns the launch's
// error (0 on success).
extern "C" int die_norm_matmul(const void* x, const void* gain,
                               const void* w, void* out, int bsz, int d,
                               int n, float eps, int plus_one, int ks,
                               int chunk, int dtype, void* stream) {
  using namespace die;
  if (bsz <= 0 || n <= 0) return 0;
  if (!plan_ok(d, n, ks, chunk, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float plus = plus_one ? 1.0f : 0.0f;
  cudaError_t err;
  if (dtype == kBF16)
    err = gemv_t<__nv_bfloat16, true>(x, w, nullptr, gain, out, bsz, d, n, ks,
                                      chunk, eps, plus, st);
  else if (dtype == kF32)
    err = gemv_t<float, true>(x, w, nullptr, gain, out, bsz, d, n, ks, chunk,
                              eps, plus, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The same core with the residual epilogue (no norm). Returns the launch's
// error (0 on success).
extern "C" int die_matmul_residual(const void* x, const void* w,
                                   const void* res, void* out, int bsz,
                                   int d, int n, int ks, int chunk,
                                   int dtype, void* stream) {
  using namespace die;
  if (bsz <= 0 || n <= 0) return 0;
  if (!plan_ok(d, n, ks, chunk, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16)
    err = gemv_t<__nv_bfloat16, false>(x, w, res, nullptr, out, bsz, d, n, ks,
                                       chunk, 0.f, 0.f, st);
  else if (dtype == kF32)
    err = gemv_t<float, false>(x, w, res, nullptr, out, bsz, d, n, ks, chunk,
                               0.f, 0.f, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
