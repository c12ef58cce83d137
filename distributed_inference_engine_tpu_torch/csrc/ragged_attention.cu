// Ragged mixed-batch attention with the fresh K/V written into the pages.
//
// Replaces the TPU kernel ops/ragged_attention.py:_ragged_kernel of the
// JAX package (wrapper ragged_attention_pallas). Row r of a launch carries
// q_lens[r] fresh queries (0: an inert row, 1: a decode row, more: a
// prefill chunk) at absolute positions ctx_lens[r] + i, and ctx_lens[r]
// context tokens already in its pages (page p of layer l at row
// layer_base + page_table[r, p] of the stacked [L*N, P, Hkv*Dh] pools).
// Query i sees every context key j < ctx_lens[r] and the row's fresh keys
// j <= i; output rows i >= q_lens[r] are 0. The fresh K/V of query i,
// rounded to the pool dtype, lands at position ctx_lens[r] + i of the
// row's pages, straddling pages through the table, in place.
//
// Bound on the card: a decode row is bound by its context bytes (one
// Hkv*Dh row of K and of V per key, ~1 FLOP per byte). A prefill row of
// 256-512 queries does ~4*H*Dh*q*(ctx + q/2) FLOPs against 2*ctx*Hkv*Dh
// bytes of context, far above the ridge: compute-bound. This kernel runs
// that arithmetic on the CUDA cores in fp32, far from the tensor cores'
// rate; wgmma tiles for the chunk rows are the speed work that follows.
//
// Design. One block per (row, KV head, tile of 64 (query, head) pairs):
// the tile holds 64/g queries of the g = H/Hkv heads that share a K/V
// head, so every K/V element a block stages in shared memory feeds all of
// them. The block streams the row's context keys and then its fresh keys
// in tiles of 32 through shared memory (fp32); each of its 8 warps owns 8
// (query, head) rows and keeps their fp32 (m, l, acc) in registers; lane j
// scores key j of the tile against the warp's rows (q broadcast from
// shared memory), and the P.V product passes each lane's probabilities
// around the warp with shuffles while lane i accumulates Dh/32 output
// columns. What the TPU kernel needed and this one does not: the
// double-buffered page DMAs and cross-row prefetch state (blocks run in
// parallel; the warp scheduler hides load latency), the pages-per-block
// table, the per-head matmul unroll and _seg finalize matmuls (Mosaic's
// rank-2 rule), the per-token DMA writeback unroll and the lane-width-128
// check.
//
// Races. A launch reads pool positions < ctx_lens[r] only and writes
// positions >= ctx_lens[r] only; a row's last context page is both read
// and written in the same launch, so no block loads a pool element at a
// position >= ctx_lens[r]: the load is guarded, not masked after it. The
// fresh keys are attended from the fresh operand (after the same rounding
// to the pool dtype), never read back from the pool. Rows own disjoint
// pages (engine/paged_kv.py:ensure_backed); an inert row points at page 0,
// which is live in another slot, and neither reads nor writes it. Each
// fresh K/V element is written by exactly one block: the tile that owns
// its query. Pool loads are plain (coherent) loads, as the pools are
// written during the launch.
#include <type_traits>

#include "common.cuh"

namespace die {
namespace {

constexpr float kNegInf = -1e30f;       // finite, as in ops/attention.py
constexpr int kRows = 64;               // (query, head) rows per block
constexpr int kKeys = 32;               // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kThreads = 32 * kWarps;

struct RaggedArgs {
  const void* q;          // [R, Qmax, H, Dh] q dtype
  const void* fresh_k;    // [R, Qmax, Hkv, Dh] q dtype
  const void* fresh_v;
  void* k_pages;          // stacked [L*N, P, Hkv*Dh] kv dtype, in place
  void* v_pages;
  const int* page_table;  // [R, MP]
  const int* ctx_lens;    // [R]
  const int* q_lens;      // [R]
  void* out;              // [R, Qmax, H, Dh] q dtype
  int qmax, h, hkv, page_size, mp, n_tiles;
  long long layer_base;
  float scale;
};

// A pool value as the plain version attends it: cast to the query dtype.
template <typename TQ, typename TKV>
__device__ __forceinline__ float ctx_value(float x) {
  if constexpr (std::is_same<TQ, TKV>::value) {
    return x;
  } else {
    return through<TQ>(x);
  }
}

// A fresh value as the plain version attends it: rounded to the pool
// dtype, then cast to the query dtype.
template <typename TQ, typename TKV>
__device__ __forceinline__ float fresh_value(float x) {
  if constexpr (std::is_same<TQ, TKV>::value) {
    return x;
  } else {
    return through<TQ>(through<TKV>(x));
  }
}

template <typename TQ, typename TKV, int E>
__global__ void __launch_bounds__(kThreads) ragged_kernel(RaggedArgs a) {
  constexpr int kDh = 32 * E;
  constexpr int kKStride = kDh + 1;     // K rows padded: lane j reads row j
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][kDh]
  float* ks = qs + kRows * kDh;         // [kKeys][kDh + 1]
  float* vs = ks + kKeys * kKStride;    // [kKeys][kDh]

  const int g = a.h / a.hkv;
  const int tq = kRows / g;             // queries per tile
  const int tile = blockIdx.x % a.n_tiles;
  const int rk = blockIdx.x / a.n_tiles;
  const int kh = rk % a.hkv;
  const int r = rk / a.hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = tile * tq;
  const int qlen = a.q_lens[r];
  const int ctx = a.ctx_lens[r];
  const long long fused = static_cast<long long>(a.hkv) * kDh;
  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* out = static_cast<TQ*>(a.out);
  // [R, Qmax, H, Dh] offset of (query qi, head kh*g + gi)
  auto qo_off = [&](int qi, int gi) {
    return ((static_cast<long long>(r) * a.qmax + qi) * a.h + kh * g + gi) *
           kDh;
  };

  if (q0 >= qlen) {
    // no query of this tile is live: its output rows are 0
    for (int idx = threadIdx.x; idx < kRows * kDh; idx += kThreads) {
      const int rr = idx / kDh;
      const int qi = q0 + rr / g;
      if (qi < a.qmax) out[qo_off(qi, rr % g) + idx % kDh] = from_f<TQ>(0.f);
    }
    return;
  }

  // the tile's queries, (query, head)-major: block row rr = (qi - q0)*g + gi
  for (int idx = threadIdx.x; idx < kRows * kDh; idx += kThreads) {
    const int rr = idx / kDh;
    const int qi = q0 + rr / g;
    qs[idx] = qi < qlen ? to_f(q[qo_off(qi, rr % g) + idx % kDh]) : 0.f;
  }

  const int r0 = warp * kRowsPerWarp;   // this warp's first block row
  int qidx[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qidx[i] = q0 + (r0 + i) / g;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  const bool warp_live = qidx[0] < qlen;

  const TKV* kp = static_cast<const TKV*>(a.k_pages);
  const TKV* vp = static_cast<const TKV*>(a.v_pages);
  const TQ* fk = static_cast<const TQ*>(a.fresh_k);
  const TQ* fv = static_cast<const TQ*>(a.fresh_v);
  const int* table = a.page_table + static_cast<long long>(r) * a.mp;
  // fresh K/V [R, Qmax, Hkv, Dh] offset of query qi, this KV head
  auto fresh_off = [&](int qi) {
    return ((static_cast<long long>(r) * a.qmax + qi) * a.hkv + kh) * kDh;
  };
  const int n_ctx_tiles = (ctx + kKeys - 1) / kKeys;
  const int fresh_end = min(q0 + tq, qlen);   // fresh keys the tile sees
  const int n_tiles = n_ctx_tiles + (fresh_end + kKeys - 1) / kKeys;

  for (int it = 0; it < n_tiles; ++it) {
    const bool fresh = it >= n_ctx_tiles;
    const int key0 = (fresh ? it - n_ctx_tiles : it) * kKeys;
    __syncthreads();                  // the previous tile is consumed
    for (int jj = warp; jj < kKeys; jj += kWarps) {
      const int t = key0 + jj;
      float kr[E], vr[E];
      if (!fresh && t < ctx) {
        // guarded: positions >= ctx are being written by this launch
        const int pg = table[t / a.page_size];
        const long long off =
            ((a.layer_base + pg) * a.page_size + t % a.page_size) * fused +
            static_cast<long long>(kh) * kDh + lane * E;
        load_row<TKV, E, false>(kp + off, kr);
        load_row<TKV, E, false>(vp + off, vr);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[e] = ctx_value<TQ, TKV>(kr[e]);
          vr[e] = ctx_value<TQ, TKV>(vr[e]);
        }
      } else if (fresh && t < fresh_end) {
        const long long off = fresh_off(t) + lane * E;
        load_row<TQ, E>(fk + off, kr);
        load_row<TQ, E>(fv + off, vr);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kr[e] = fresh_value<TQ, TKV>(kr[e]);
          vr[e] = fresh_value<TQ, TKV>(vr[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[e] = vr[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ks[jj * kKStride + lane * E + e] = kr[e];
        vs[jj * kDh + lane * E + e] = vr[e];
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    // keys of this tile visible to each row: lane < lim[i]
    int lim[kRowsPerWarp];
    int lim_max = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      lim[i] = (fresh ? min(qidx[i] + 1, qlen) : ctx) - key0;
      lim_max = max(lim_max, lim[i]);
    }
    lim_max = min(lim_max, kKeys);

    // scores of the warp's rows against key `lane`
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = ks + lane * kKStride;
    for (int d = 0; d < kDh; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2],
                  k3 = krow[d + 3];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + i) * kDh + d);
        s[i] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }
    // online softmax; masked keys get probability exactly 0
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool ok = lane < lim[i];
      const float sc = ok ? s[i] * a.scale : kNegInf;
      const float mn = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(m[i] - mn);
      p[i] = ok ? expf(sc - mn) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    }
    // acc += P . V: lane owns output columns [lane*E, lane*E + E)
    for (int j = 0; j < lim_max; ++j) {
      float vr[E];
      lds_row<E>(vs + j * kDh + lane * E, vr);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += pj * vr[e];
      }
    }
  }

  // outputs: rows of live queries divided by their softmax sums, others 0
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rr = r0 + i;
    const int qi = qidx[i];
    if (qi >= a.qmax) continue;
    const float den = fmaxf(l[i], 1e-30f);
    TQ* o = out + qo_off(qi, rr % g) + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[e] = from_f<TQ>(qi < qlen ? acc[i][e] / den : 0.f);
  }

  // writeback: the fresh K/V of this tile's queries -> pool positions
  // ctx + qi (the logical page clamped to the table, as the plain version)
  TKV* kw = static_cast<TKV*>(a.k_pages);
  TKV* vw = static_cast<TKV*>(a.v_pages);
  for (int qi = q0 + warp; qi < fresh_end; qi += kWarps) {
    const int pos = ctx + qi;
    const int pg = table[min(pos / a.page_size, a.mp - 1)];
    const long long dst =
        ((a.layer_base + pg) * a.page_size + pos % a.page_size) * fused +
        static_cast<long long>(kh) * kDh + lane * E;
    const long long src = fresh_off(qi) + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kw[dst + e] = from_f<TKV>(to_f(fk[src + e]));
      vw[dst + e] = from_f<TKV>(to_f(fv[src + e]));
    }
  }
}

template <typename TQ, typename TKV, int E>
cudaError_t launch(const RaggedArgs& a, int r, cudaStream_t stream) {
  constexpr int kDh = 32 * E;
  constexpr int kSmem = static_cast<int>(sizeof(float)) *
                        (kRows * kDh + kKeys * (kDh + 1) + kKeys * kDh);
  static bool attr_set = false;        // per instantiation (one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_kernel<TQ, TKV, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  ragged_kernel<TQ, TKV, E>
      <<<r * a.hkv * a.n_tiles, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t by_width(int e, const RaggedArgs& a, int r, cudaStream_t st) {
  switch (e) {
    case 1: return launch<TQ, TKV, 1>(a, r, st);
    case 2: return launch<TQ, TKV, 2>(a, r, st);
    case 4: return launch<TQ, TKV, 4>(a, r, st);
    case 8: return launch<TQ, TKV, 8>(a, r, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace die

// q [R, Qmax, H, Dh] and fresh_k/fresh_v [R, Qmax, Hkv, Dh] in q_dtype;
// the stacked pools [L*N, P, Hkv*Dh] in kv_dtype, written in place at
// positions [ctx_lens[r], ctx_lens[r] + q_lens[r]) of row r's pages; out
// [R, Qmax, H, Dh] in q_dtype. (H/Hkv) must divide 64. Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int die_ragged_attention(
    const void* q, const void* fresh_k, const void* fresh_v, void* k_pages,
    void* v_pages, const int* page_table, const int* ctx_lens,
    const int* q_lens, void* out, int r, int qmax, int h, int hkv, int dh,
    int page_size, int mp, long long layer_base, int q_dtype, int kv_dtype,
    void* stream) {
  using namespace die;
  if (r <= 0 || qmax <= 0) return 0;
  if (hkv <= 0 || h % hkv || kRows % (h / hkv) || dh % 32)
    return cudaErrorInvalidValue;
  RaggedArgs a{};
  a.q = q;
  a.fresh_k = fresh_k;
  a.fresh_v = fresh_v;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = page_table;
  a.ctx_lens = ctx_lens;
  a.q_lens = q_lens;
  a.out = out;
  a.qmax = qmax;
  a.h = h;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  const int tq = kRows / (h / hkv);
  a.n_tiles = (qmax + tq - 1) / tq;
  a.layer_base = layer_base;
  a.scale = 1.0f / sqrtf(static_cast<float>(dh));
  const int e = dh / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    err = by_width<__nv_bfloat16, __nv_bfloat16>(e, a, r, st);
  else if (q_dtype == kF32 && kv_dtype == kF32)
    err = by_width<float, float>(e, a, r, st);
  else if (q_dtype == kBF16 && kv_dtype == kF32)
    err = by_width<__nv_bfloat16, float>(e, a, r, st);
  else if (q_dtype == kF32 && kv_dtype == kBF16)
    err = by_width<float, __nv_bfloat16>(e, a, r, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
