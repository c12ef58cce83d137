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
// bytes of context, far above the ridge: compute-bound, on the tensor
// cores.
//
// Items. An item is a (row, KV head, query tile); a tile holds
// floor(rows_per_block / g) queries of the g = H/Hkv heads that share a
// K/V head, its (query, head) pairs are the block's rows, so every K/V
// element a block stages feeds all of them. Any g, as the TPU kernel
// takes: where g does not divide the rows, the rows past the tile's
// queries are dead (Qwen2's g = 7: 18 queries, 126 of 128 rows live on
// the tensor cores; 9 queries, 63 of 64, on the CUDA cores), computed on
// zeros and never stored. Above 64 heads a KV head's g heads are cut into
// sub-groups of at most 64 (n_sub; the last one's rows past g dead), each
// sub-group a KV head of its own to the items (the "virtual" heads, vh =
// hkv * n_sub of them); the first sub-group alone writes the fresh K/V
// back. The tile count comes from the host
// (ops/ragged_attention.py ragged_plan), from shapes only: the lengths
// live on the card. block_of orders the items from the highest query tile
// to the lowest, the rows from the last (the engine puts its prefill rows
// after its decode rows) to the first (ragged_block on the host).
//
// bf16 q over bf16 pools: the tensor-core instance (ragged_mma_kernel),
// FlashAttention-2 on mma.sync.m16n8k16.
// - Persistent: one block an SM (8 warps, the block's 128 rows as 8
//   16-row m-tiles). Each block reads the rows' lengths once, ranks the
//   (row, query tile) pairs by their key tiles (pair_cost; a chunk's tile
//   counts twice a decode row's) and takes the items in a snake over the
//   blocks, heaviest first, the dead ones (no live query: zero stores
//   only) last (ragged_schedule on the host). One block per item would
//   launch the engine's lattice (~80% padding) as mostly empty blocks,
//   each holding an SM's shared memory, and static orders put two heavy
//   items on one block.
// - The row's context keys and then the tile's fresh keys stream in tiles
//   of 64 keys (32 at Dh 256) through a ring of cp.async stages (5; 4 at
//   Dh 256), 16 bytes a thread, each thread finding the sources of all
//   its rows first (page and offset stepped along, no division a row).
//   Context rows come through the page table (its ids staged in shared
//   memory) and are guarded below ctx_lens[r] (zero-filled past it).
// - Warps to m-tiles: a full tile gives each warp one m-tile and the whole
//   key tile; a tile with few live rows (a decode row's g) gives each live
//   m-tile up to 4 warps, each a 16-key slice of every key tile, merged
//   at the end through shared memory. Each warp takes S = Q K^T with Q
//   and K from ldmatrix (the next K-step's fragments loaded before the
//   current one's mma.sync), an online softmax in exp2 units, P kept in
//   registers as bf16 (the S accumulator's layout is the A operand's) and
//   O += P V with V through ldmatrix.trans. The causal and length masks
//   apply only to slices that straddle the diagonal or the context's end;
//   a slice past every row's diagonal is skipped. Masked keys weigh
//   exactly 0. Rows of the tiles are padded by 16 bytes, so ldmatrix is
//   conflict-free.
// - What bounds it now (clock64 stamps per phase of the tile loop, taken
//   with a tuning script not kept): the per-warp chain of a tile, not the
//   bytes, whose loads the ring hides. A full tile costs most in its 8
//   warps' mma.sync and softmax; a decode tile splits its time between
//   that and the cp.async issue of its context rows; the kernel ends with
//   its heaviest item, the longest chunk tile or the longest decode row,
//   10-17 key tiles one after another. Splitting an item's keys over two
//   blocks of a cluster (merged through distributed shared memory) halved
//   the longest items but raised the total more, and two m-tiles a warp
//   (halving ldmatrix traffic) left the tile cost unchanged; both were
//   measured and dropped.
//
// e4m3 and e5m2 pools (the fp8 instances; the TPU kernel upcasts the
// staged pages, ops/ragged_attention.py:272-273, and lands the fresh K/V
// in the pool's dtype, :386-387, attending to those bits as
// ragged_attention_xla does, :108-112). bf16 q keeps the tensor cores and
// the bf16 instance's items, schedule and warp_tile (both fp8 formats are
// exact in bf16), fed by a producer warpgroup (ragged_fp8_kernel, below):
// the producers copy the fp8 context tiles (one byte a value: half the
// context bytes) and the fresh bf16 tiles into a ring of their own with
// the Tensor Memory Accelerator, widen each context tile into one of two
// buffers (K in bf16, V in f16) and round each fresh tile through the pool
// dtype as the writeback stores it (JAX's rounding: e4m3's NaN past 464,
// e5m2's +-inf from 61,440 and its NaN bytes, common.cuh bf16x8_to_f8x8),
// and hand each buffer to the mma warps on a named barrier; setmaxnreg
// gives the mma warps the registers. So the widening and the rounding
// leave the mma warps' chain, with the block barrier they took there, and
// more keys are in flight. fp32 q over fp8 pools takes
// the CUDA-core instance, which widens each value as it loads it and rounds
// each fresh value the same way.
//
// Every other dtype pair (fp32, whose 1e-4 tolerance TF32 would break;
// bf16 with fp32 pools and back): the CUDA-core instance
// (ragged_simt_kernel), 64 rows a block; each of its 8 warps owns 8
// (query, head) rows and keeps their fp32 (m, l, acc) in registers; tiles
// of 32 keys staged in fp32; lane j scores key j of the tile against the
// warp's rows, and the P.V product passes each lane's probabilities
// around the warp with shuffles while lane i accumulates Dh/32 output
// columns.
//
// What the TPU kernel needed and these do not: the double-buffered page
// DMAs and cross-row prefetch state (blocks run in parallel; the copies
// of the next tiles are in flight while one is used), the pages-per-block
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
// its query. Pool loads are coherent (plain loads; cp.async.cg reads
// through L2), as the pools are written during the launch.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace die {
namespace ra {

constexpr float kNegInf = -1e30f;       // finite, as in ops/attention.py
constexpr int kRows = 64;               // simt: (query, head) rows a block
constexpr int kKeys = 32;               // simt: keys per tile, one a lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kMmaWarps = 8;            // mma: one 16-row m-tile a warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMaxPages = 256;          // a row's page ids in shared memory
constexpr int kMaxRows = 256;           // rows whose lengths are staged
constexpr int kMaxPairs = 512;          // (row, query tile) pairs ranked

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
  int r, qmax, h, hkv, page_size, mp, n_tiles;
  int g;                  // H / Hkv
  int gs, n_sub, vh;      // heads an item, sub-groups a KV head, hkv*n_sub
  long long layer_base;
  float scale;
};

// The block's (row, KV head, sub-group, query tile): heavy tiles first,
// the highest query tile of every row, the rows from the last; the host's
// ragged_block (ops/ragged_attention.py) is the same rule over the vh
// virtual heads. gl of the sub-group's gs heads are live, the first at
// query head head0 of the row.
struct Block {
  int r, kh, sub, tile, gl, head0;
};

__device__ __forceinline__ Block block_of(const RaggedArgs& a, int item) {
  const int per_tile = a.r * a.vh;
  const int i = item / per_tile;
  const int rem = item - i * per_tile;
  Block b;
  b.tile = a.n_tiles - 1 - i;
  b.r = a.r - 1 - rem / a.vh;
  const int v = rem - (rem / a.vh) * a.vh;
  b.kh = v / a.n_sub;
  b.sub = v - b.kh * a.n_sub;
  b.gl = min(a.gs, a.g - b.sub * a.gs);
  b.head0 = b.kh * a.g + b.sub * a.gs;
  return b;
}

// Block row rr of an item ((query, head)-major: rr = (qi - q0) * gs + gi)
// holds a live head of one of the tile's tq queries.
__device__ __forceinline__ bool row_ok(const RaggedArgs& a, const Block& bk,
                                       int tq, int rr) {
  return rr < tq * a.gs && rr % a.gs < bk.gl;
}

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

// ---------------------------------------------------------------- simt

// Two blocks an SM where their shared memory allows it (Dh <= 128), which
// caps the registers at 128: left to itself ptxas took 146 at Dh 128 in
// fp32, one block an SM, 16% slower on the card; at Dh 256 one block
// fills the shared memory.
template <typename TQ, typename TKV, int E>
__global__ void __launch_bounds__(kThreads, E <= 4 ? 2 : 1)
    ragged_simt_kernel(RaggedArgs a) {
  constexpr int kDh = 32 * E;
  constexpr int kKStride = kDh + 1;     // K rows padded: lane j reads row j
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][kDh]
  float* ks = qs + kRows * kDh;         // [kKeys][kDh + 1]
  float* vs = ks + kKeys * kKStride;    // [kKeys][kDh]

  const int g = a.gs;                   // heads an item
  const int tq = kRows / g;             // queries per tile
  const Block bk = block_of(a, blockIdx.x);
  const int tile = bk.tile;
  const int kh = bk.kh;
  const int r = bk.r;
  const int head0 = bk.head0;
  const int n_live = tq * g;            // rows of the tile's queries
  const int gl = bk.gl;                 // live heads of a query
  const bool writes = bk.sub == 0;      // the KV head's first sub-group
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = tile * tq;
  const int qlen = a.q_lens[r];
  const int ctx = a.ctx_lens[r];
  const long long fused = static_cast<long long>(a.hkv) * kDh;
  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* out = static_cast<TQ*>(a.out);
  // [R, Qmax, H, Dh] offset of (query qi, head head0 + gi)
  auto qo_off = [&](int qi, int gi) {
    return ((static_cast<long long>(r) * a.qmax + qi) * a.h + head0 + gi) *
           kDh;
  };

  if (q0 >= qlen) {
    // no query of this tile is live: its output rows are 0
    for (int idx = threadIdx.x; idx < kRows * kDh; idx += kThreads) {
      const int rr = idx / kDh;
      const int qi = q0 + rr / g;
      const int gi = rr % g;
      if (rr < n_live && gi < gl && qi < a.qmax)
        out[qo_off(qi, gi) + idx % kDh] = from_f<TQ>(0.f);
    }
    return;
  }

  // the tile's queries, (query, head)-major: block row rr = (qi - q0)*g +
  // gi; dead rows are zeros
  for (int idx = threadIdx.x; idx < kRows * kDh; idx += kThreads) {
    const int rr = idx / kDh;
    const int qi = q0 + rr / g;
    const int gi = rr % g;
    qs[idx] = rr < n_live && gi < gl && qi < qlen
                  ? to_f(q[qo_off(qi, gi) + idx % kDh])
                  : 0.f;
  }

  const int r0 = warp * kRowsPerWarp;   // this warp's first block row
  int qidx[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
  bool warp_live = false;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qidx[i] = q0 + (r0 + i) / g;
    warp_live = warp_live ||
                (r0 + i < n_live && (r0 + i) % g < gl && qidx[i] < qlen);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

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
    if (rr >= n_live || rr % g >= gl || qi >= a.qmax) continue;
    const float den = fmaxf(l[i], 1e-30f);
    TQ* o = out + qo_off(qi, rr % g) + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[e] = from_f<TQ>(qi < qlen ? acc[i][e] / den : 0.f);
  }

  // writeback: the fresh K/V of this tile's queries -> pool positions
  // ctx + qi (the logical page clamped to the table, as the plain version),
  // by the KV head's first sub-group alone
  TKV* kw = static_cast<TKV*>(a.k_pages);
  TKV* vw = static_cast<TKV*>(a.v_pages);
  for (int qi = q0 + warp; writes && qi < fresh_end; qi += kWarps) {
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


// ---------------------------------------------------------- tensor cores

// Staged tile geometry of the bf16 instance at head width DH: K and V
// tiles of kKeys rows, the block's 128 query rows, rows padded by 16
// bytes (ldmatrix is then conflict-free); one block an SM, so the ring
// takes as many stages as fit (5 below Dh 256, 4 at it): the cp.async
// issue of a context tile stalls on the SM's outstanding loads, and more
// tiles in flight shorten it. After a tile loop the same bytes hold the
// warps' partial states.
template <int DH>
struct Geo {
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kKeys = DH <= 128 ? 64 : 32;
  static constexpr int kTileBytes = 2 * kKeys * kStride;   // K, then V
  static constexpr int kQBytes = kMmaRows * kStride;
  static constexpr int kStages = DH <= 128 ? 5 : 4;
  static constexpr int kSmem = kQBytes + kStages * kTileBytes;
  // the warps' partial states, fp32: warp w's 16 rows of acc[DH] at
  // w kPart, their (m, l) at kMl + 32 w; then the merge weights
  static constexpr int kPart = 16 * DH;
  static constexpr int kMl = kMmaWarps * kPart;
  static constexpr int kWts = kMl + 32 * kMmaWarps;
  static_assert(kRowBytes % 16 == 0 && kKeys % 16 == 0,
                "whole 16-byte pieces and mma tiles");
  static_assert((kWts + kMmaRows * 4) * 4 <= kSmem,
                "partials and weights fit the ring");
};

// Zero rows [q0, q0 + tq) of the block's live heads (those below qmax),
// 16 bytes a store: a query's gl heads from head0 are gl*DH contiguous
// elements of out.
template <int DH>
__device__ __forceinline__ void zero_tile(const RaggedArgs& a,
                                          const Block& bk, int q0, int tq) {
  const int per_q = bk.gl * DH * 2 / 16;
  const int nq = min(tq, a.qmax - q0);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  for (int i = threadIdx.x; i < nq * per_q; i += kMmaThreads) {
    const int qi = q0 + i / per_q;
    const long long o =
        ((static_cast<long long>(bk.r) * a.qmax + qi) * a.h + bk.head0) * DH;
    reinterpret_cast<uint4*>(out + o)[i % per_q] = make_uint4(0, 0, 0, 0);
  }
}

// Stage key tile `tile` of the block's sequence (the context tiles, then
// the fresh ones) into dst: K rows, then V rows. Context rows are guarded
// below ctx and fresh rows below fresh_end; others are zero-filled. Each
// thread copies 16-byte piece c of rows row0, row0 + kRowsPass, ...: it
// finds all their sources first (the page and offset stepped along, one
// division a tile), then issues the copies together.
template <int DH>
__device__ __forceinline__ void stage_keys(const RaggedArgs& a,
                                           const int* pg_ids, int r, int kh,
                                           int ctx, int n_ctx_tiles,
                                           int fresh_end, char* dst,
                                           int tile) {
  using G = Geo<DH>;
  constexpr int kChunks = G::kRowBytes / 16;
  constexpr int kRowsPass = kMmaThreads / kChunks;
  constexpr int kPasses = (G::kKeys + kRowsPass - 1) / kRowsPass;
  static_assert(kMmaThreads % kChunks == 0, "a pass covers whole rows");
  const int c = threadIdx.x % kChunks;
  const int row0 = threadIdx.x / kChunks;
  const bool fresh = tile >= n_ctx_tiles;
  const int key0 = (fresh ? tile - n_ctx_tiles : tile) * G::kKeys;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k_pages);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v_pages);
  const __nv_bfloat16* fk = static_cast<const __nv_bfloat16*>(a.fresh_k);
  const __nv_bfloat16* fv = static_cast<const __nv_bfloat16*>(a.fresh_v);
  long long src[kPasses];
  bool ok[kPasses];
  if (!fresh) {
    const long long fused = static_cast<long long>(a.hkv) * DH;
    const long long head = static_cast<long long>(kh) * DH + c * 8;
    const int t0 = key0 + row0;
    int pg = t0 / a.page_size;
    int off = t0 - pg * a.page_size;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      // guarded: positions >= ctx are being written by this launch
      ok[i] = t0 + i * kRowsPass < ctx;
      src[i] = ok[i] ? ((a.layer_base + pg_ids[pg]) * a.page_size + off) *
                               fused + head
                     : 0;
      off += kRowsPass;
      while (off >= a.page_size) {
        off -= a.page_size;
        ++pg;
      }
    }
  } else {
    const long long row_stride = static_cast<long long>(a.hkv) * DH;
    const long long base =
        (static_cast<long long>(r) * a.qmax * a.hkv + kh) * DH + c * 8;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int t = key0 + row0 + i * kRowsPass;
      ok[i] = t < fresh_end;
      src[i] = ok[i] ? base + t * row_stride : 0;
    }
  }
  const __nv_bfloat16* ks = fresh ? fk : kp;
  const __nv_bfloat16* vs = fresh ? fv : vp;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int row = row0 + i * kRowsPass;
    if (row < G::kKeys) {
      char* d = dst + row * G::kStride + c * 16;
      cp_async16(d, ks + src[i], ok[i]);
      cp_async16(d + G::kKeys * G::kStride, vs + src[i], ok[i]);
    }
  }
}

// A K-step's A and B fragments for S = Q K^T: Q rows q_row0 .. + 15 and
// NK keys from key row kb of the tile.
template <int DH, int NK>
__device__ __forceinline__ void qk_frags(const char* qt, const char* kt,
                                         int q_row0, int kb, int kk,
                                         uint32_t (&qa)[4],
                                         uint32_t (&kf)[NK / 16][4]) {
  constexpr int kS = Geo<DH>::kStride;
  const int lane = threadIdx.x & 31;
  ldsm_x4(qa, qt + (q_row0 + lane % 16) * kS + (kk * 16 + (lane / 16) * 8) * 2);
#pragma unroll
  for (int j = 0; j < NK / 16; ++j)
    ldsm_x4(kf[j], kt + (kb + j * 16 + (lane / 16) * 8 + lane % 8) * kS +
                       (kk * 16 + ((lane / 8) % 2) * 8) * 2);
}

// One online-softmax step of a warp's 16 rows (Q rows q_row0 .. + 15)
// over NK keys from key row kb of the staged tile (kt: K rows, vt: V
// rows). Lane i holds rows i / 4 and i / 4 + 8 (h = 0, 1) and, per 8-wide
// column tile n of the output, the columns 8n + 2 (i % 4) and + 1. With
// `masked`, key kb + c of the tile is visible to row h iff kb + c <
// lim[h]; invisible keys weigh exactly 0. The next K-step's (and V
// column tile's) fragments are loaded before the current ones' mma.sync
// issue, so their shared-memory latency overlaps the tensor cores. With
// kF16V the V rows are f16 and P V runs on the f16 core (the fp8
// instance's: both fp8 formats are exact in f16, and P keeps 3 more bits).
template <int DH, int NK, bool kF16V = false>
__device__ __forceinline__ void mma_step(const char* qt, const char* kt,
                                         const char* vt, int q_row0, int kb,
                                         bool masked, const int (&lim)[2],
                                         float scale2, float (&m)[2],
                                         float (&l)[2],
                                         float (&acc)[DH / 8][4]) {
  constexpr int kS = Geo<DH>::kStride;
  constexpr int kN = NK / 8;            // 8-key column tiles of S
  constexpr int kJ = NK / 16;           // 16-key K-steps of P V
  constexpr int kD = DH / 16;
  const int lane = threadIdx.x & 31;
  float s[kN][4];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  // S = Q K^T
  uint32_t qa[2][4], kf[2][kJ][4];
  qk_frags<DH, NK>(qt, kt, q_row0, kb, 0, qa[0], kf[0]);
#pragma unroll
  for (int kk = 0; kk < kD; ++kk) {
    if (kk + 1 < kD)
      qk_frags<DH, NK>(qt, kt, q_row0, kb, kk + 1, qa[(kk + 1) & 1],
                       kf[(kk + 1) & 1]);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      mma_bf16_16816(s[2 * j], qa[kk & 1], kf[kk & 1][j][0],
                     kf[kk & 1][j][1]);
      mma_bf16_16816(s[2 * j + 1], qa[kk & 1], kf[kk & 1][j][2],
                     kf[kk & 1][j][3]);
    }
  }
  // scale (log2 units), mask, row maxima over the quad
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[i][e] * scale2;
      if (masked && kb + 8 * i + 2 * (lane % 4) + (e & 1) >= lim[e >> 1])
        v = kNegInf;
      s[i][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = fast_exp2(m[h] - mn);
    m[h] = mn;
  }
  float rs[2] = {0.f, 0.f};
  uint32_t pa[kJ][4];                  // P in bf16 (f16), the A operand of P V
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool off = masked &&
          kb + 8 * i + 2 * (lane % 4) + (e & 1) >= lim[e >> 1];
      p[e] = off ? 0.f : fast_exp2(s[i][e] - m[e >> 1]);
      rs[e >> 1] += p[e];
    }
    if constexpr (kF16V) {
      pa[i / 2][2 * (i % 2)] = pack_f16(p[0], p[1]);
      pa[i / 2][2 * (i % 2) + 1] = pack_f16(p[2], p[3]);
    } else {
      pa[i / 2][2 * (i % 2)] = pack_bf16(p[0], p[1]);
      pa[i / 2][2 * (i % 2) + 1] = pack_bf16(p[2], p[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  // O += P V: step i takes K-step i / kD of P and V column tile i % kD
  uint32_t vb[2][4];
  ldsm_x4_trans(vb[0], vt + (kb + lane % 16) * kS + ((lane / 16) * 8) * 2);
#pragma unroll
  for (int i = 0; i < kJ * kD; ++i) {
    if (i + 1 < kJ * kD) {
      const int j = (i + 1) / kD;
      const int n2 = (i + 1) % kD;
      ldsm_x4_trans(vb[(i + 1) & 1],
                    vt + (kb + j * 16 + lane % 16) * kS +
                        (n2 * 16 + (lane / 16) * 8) * 2);
    }
    const int j = i / kD;
    const int n2 = i % kD;
    if constexpr (kF16V) {
      mma_f16_16816(acc[2 * n2], pa[j], vb[i & 1][0], vb[i & 1][1]);
      mma_f16_16816(acc[2 * n2 + 1], pa[j], vb[i & 1][2], vb[i & 1][3]);
    } else {
      mma_bf16_16816(acc[2 * n2], pa[j], vb[i & 1][0], vb[i & 1][1]);
      mma_bf16_16816(acc[2 * n2 + 1], pa[j], vb[i & 1][2], vb[i & 1][3]);
    }
  }
}

// A warp's keys of one staged tile: NK keys from key row slot * NK (NK =
// kKeys / wpm), for the rows of m-tile mt; skips the keys no row of the
// m-tile sees, masks the ones that straddle a row's limit.
template <int DH, int NK, bool kF16V = false>
__device__ __forceinline__ void warp_tile(const char* q_tile, const char* kt,
                                          const char* vt, int mt, int slot,
                                          bool fresh, int key0, int ctx,
                                          const int (&qrow)[2], int qw_lo,
                                          int qw_hi, float scale2,
                                          float (&m)[2], float (&l)[2],
                                          float (&acc)[DH / 8][4]) {
  const int kb = slot * NK;
  const int k_lo = key0 + kb;
  const int k_hi = k_lo + NK - 1;
  if (fresh ? k_lo > qw_hi : k_lo >= ctx) return;
  const bool masked = fresh ? k_hi > qw_lo : k_hi >= ctx;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = fresh ? qrow[h] + 1 - key0 : ctx - key0;
  mma_step<DH, NK, kF16V>(q_tile, kt, vt, 16 * mt, kb, masked, lim, scale2,
                          m, l, acc);
}

// The fresh K/V of a tile's queries [q0, fresh_end) into the pool at
// positions ctx_raw + qi (the logical page clamped to the table, as the
// plain version), 16 bytes of the fresh rows a step; into fp8 pools (T8:
// e4m3 or e5m2) 8 values a step, rounded as bf16x8_to_f8x8 rounds them
// (JAX's cast), the bytes the tile attended. The kT threads from tid.
template <int DH, typename TKV, int kT>
__device__ __forceinline__ void write_fresh(const RaggedArgs& a, int r,
                                            int kh, int q0, int fresh_end,
                                            int ctx_raw, const int* table,
                                            int tid) {
  constexpr int kChunks = DH * 2 / 16;             // 8 values a piece
  const long long fused = static_cast<long long>(a.hkv) * DH;
  const uint4* fk = static_cast<const uint4*>(a.fresh_k);
  const uint4* fv = static_cast<const uint4*>(a.fresh_v);
  for (int i = tid; i < (fresh_end - q0) * kChunks; i += kT) {
    const int qi = q0 + i / kChunks;
    const int c = i % kChunks;
    const int pos = ctx_raw + qi;
    const int pg = table[min(pos / a.page_size, a.mp - 1)];
    const long long dst =
        ((a.layer_base + pg) * a.page_size + pos % a.page_size) * fused +
        static_cast<long long>(kh) * DH + c * 8;
    const long long src =
        ((static_cast<long long>(r) * a.qmax + qi) * a.hkv + kh) * DH / 8 +
        c;
    if constexpr (kIsFp8<TKV>) {
      *reinterpret_cast<uint2*>(static_cast<char*>(a.k_pages) + dst) =
          bf16x8_to_f8x8<TKV>(__ldg(fk + src));
      *reinterpret_cast<uint2*>(static_cast<char*>(a.v_pages) + dst) =
          bf16x8_to_f8x8<TKV>(__ldg(fv + src));
    } else {
      static_cast<uint4*>(a.k_pages)[dst / 8] = __ldg(fk + src);
      static_cast<uint4*>(a.v_pages)[dst / 8] = __ldg(fv + src);
    }
  }
}

// One (row, KV head, query tile) of the tensor-core instance. The tile's
// live (query, head) rows fill n_mt 16-row m-tiles; each m-tile takes wpm
// warps (1, 2 or 4: as many as the 8 warps allow, up to one per 16 keys
// of a tile), each with its own slice of every key tile, and the warps of
// an m-tile merge their states at the end. A decode row (g live rows) thus
// spreads each tile over 4 warps instead of leaving it to one.
template <int DH>
__device__ __forceinline__ void mma_item(const RaggedArgs& a, const Block& bk,
                                         char* smem, int* pages,
                                         const int* q_lens,
                                         const int* ctx_lens) {
  using G = Geo<DH>;
  char* q_tile = smem;
  char* ring = smem + G::kQBytes;
  const int g = a.gs;                   // heads an item
  const int tq = kMmaRows / g;          // queries per tile
  const int r = bk.r;
  const int kh = bk.kh;
  const int q0 = bk.tile * tq;
  const int qlen = q_lens[r];
  if (q0 >= qlen) {                     // no live query: zero rows
    zero_tile<DH>(a, bk, q0, tq);
    return;
  }
  const int ctx_raw = ctx_lens[r];
  const int ctx = min(ctx_raw, a.mp * a.page_size);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the context's page ids
  const int* table = a.page_table + static_cast<long long>(r) * a.mp;
  const int n_pg = (ctx + a.page_size - 1) / a.page_size;
  const int* pg_ids = table;
  if (n_pg <= kMaxPages) {
    for (int i = threadIdx.x; i < n_pg; i += kMmaThreads)
      pages[i] = table[i];
    pg_ids = pages;
  }

  // the tile's queries, (query, head)-major: block row rr = (qi - q0)*g +
  // gi; rows of dead queries and dead rows are zeros. Committed with the
  // first tile.
  {
    constexpr int kChunks = G::kRowBytes / 16;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int i = threadIdx.x; i < kMmaRows * kChunks; i += kMmaThreads) {
      const int rr = i / kChunks;
      const int c = i - rr * kChunks;
      const int qi = q0 + rr / g;
      const bool ok = qi < qlen && row_ok(a, bk, tq, rr);
      const long long e =
          ok ? ((static_cast<long long>(r) * a.qmax + qi) * a.h + bk.head0 +
                rr % g) * DH + c * 8
             : 0;
      cp_async16(q_tile + rr * G::kStride + c * 16, q + e, ok);
    }
  }
  __syncthreads();                      // the page ids

  const int fresh_end = min(q0 + tq, qlen);   // fresh keys the tile sees
  const int n_ctx_tiles = (ctx + G::kKeys - 1) / G::kKeys;
  const int n_all = n_ctx_tiles + (fresh_end + G::kKeys - 1) / G::kKeys;
  // warps to m-tiles: n_mt live m-tiles, wpm warps (key slices) each
  const int n_mt = ((fresh_end - q0) * g + 15) / 16;
  int wpm = G::kKeys / 16;
  while (wpm > 1 && wpm * n_mt > kMmaWarps) wpm >>= 1;
  const int mt = warp / wpm;
  const int slot = warp - mt * wpm;
  const bool live = mt < n_mt;
  const int qw_lo = q0 + (16 * mt) / g;
  const int qw_hi = min(q0 + (16 * mt + 15) / g, qlen - 1);
  int qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qrow[h] = q0 + (16 * mt + lane / 4 + 8 * h) / g;

  const float scale2 = a.scale * 1.4426950408889634f;   // exp2 units
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int t = 0; t < G::kStages - 1; ++t) {
    if (t < n_all)
      stage_keys<DH>(a, pg_ids, r, kh, ctx, n_ctx_tiles, fresh_end,
                     ring + t * G::kTileBytes, t);
    cp_async_commit();
  }
  for (int t = 0; t < n_all; ++t) {
    const int tn = t + G::kStages - 1;
    if (tn < n_all)
      stage_keys<DH>(a, pg_ids, r, kh, ctx, n_ctx_tiles, fresh_end,
                     ring + (tn % G::kStages) * G::kTileBytes, tn);
    cp_async_commit();
    cp_async_wait<G::kStages - 1>();    // tile t landed (this thread's part)
    __syncthreads();                    // ... and every thread's
    if (live) {
      const char* kt = ring + (t % G::kStages) * G::kTileBytes;
      const char* vt = kt + G::kKeys * G::kStride;
      const bool fresh = t >= n_ctx_tiles;
      const int key0 = (fresh ? t - n_ctx_tiles : t) * G::kKeys;
      if (wpm == 1) {
        warp_tile<DH, G::kKeys>(q_tile, kt, vt, mt, slot, fresh, key0, ctx,
                                qrow, qw_lo, qw_hi, scale2, m, l, acc);
      } else if (wpm == 2) {
        warp_tile<DH, G::kKeys / 2>(q_tile, kt, vt, mt, slot, fresh, key0,
                                    ctx, qrow, qw_lo, qw_hi, scale2, m, l,
                                    acc);
      } else {
        if constexpr (G::kKeys >= 64)
          warp_tile<DH, G::kKeys / 4>(q_tile, kt, vt, mt, slot, fresh, key0,
                                      ctx, qrow, qw_lo, qw_hi, scale2, m, l,
                                      acc);
      }
    }
    __syncthreads();                    // the stage is free again
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // outputs: live rows divided by their softmax sums, the others exactly 0
  // (stored, not scaled by 0: a NaN in an e4m3 pool, JAX's overflow, would
  // survive a product)
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  auto out_row = [&](int rr) {
    return out + ((static_cast<long long>(r) * a.qmax + q0 + rr / g) * a.h +
                  bk.head0 + rr % g) * DH;
  };
  if (wpm == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * warp + lane / 4 + 8 * h;
      const int qi = qrow[h];
      if (!row_ok(a, bk, tq, rr) || qi >= a.qmax) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      uint32_t* o = reinterpret_cast<uint32_t*>(out_row(rr) + 2 * (lane % 4));
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        o[4 * n] = qi < qlen ? pack_bf16(acc[n][2 * h] * inv,
                                         acc[n][2 * h + 1] * inv)
                             : 0u;
    }
  } else {
    // an m-tile's wpm key slices merge through shared memory (the ring is
    // free): warp w's 16 rows of acc at part + w kPart and their (m, l) at
    // part + kMl + 32 w; first each live row's weight of every slice,
    // exp2(m_s - m) / l, then the rows, 16 bytes a load
    float* part = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (live) {
      float* mine = part + warp * G::kPart;
      float* ml = part + G::kMl + 32 * warp;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane / 4 + 8 * h;
        if (lane % 4 == 0) {
          ml[2 * row] = m[h];
          ml[2 * row + 1] = l[h];
        }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<float2*>(mine + row * DH + 8 * n +
                                     2 * (lane % 4)) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    __syncthreads();
    const int live_rows = 16 * n_mt;
    float* wts = part + G::kWts;        // [live_rows][wpm]
    for (int rr = threadIdx.x; rr < live_rows; rr += kMmaThreads) {
      const float* ml = part + G::kMl + 32 * (rr / 16) * wpm + 2 * (rr % 16);
      float mx = kNegInf;
      for (int sl = 0; sl < wpm; ++sl) mx = fmaxf(mx, ml[32 * sl]);
      float den = 0.f;
      for (int sl = 0; sl < wpm; ++sl)
        den += ml[32 * sl + 1] * fast_exp2(ml[32 * sl] - mx);
      const float inv = q0 + rr / g >= qlen ? 0.f : 1.f / fmaxf(den, 1e-30f);
      for (int sl = 0; sl < wpm; ++sl)
        wts[rr * wpm + sl] = fast_exp2(ml[32 * sl] - mx) * inv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < live_rows * (DH / 4); i += kMmaThreads) {
      const int rr = i / (DH / 4);      // block row
      const int d = 4 * (i % (DH / 4));
      if (!row_ok(a, bk, tq, rr) || q0 + rr / g >= a.qmax) continue;
      if (q0 + rr / g >= qlen) {        // a dead query of a live m-tile
        *reinterpret_cast<uint2*>(out_row(rr) + d) = make_uint2(0u, 0u);
        continue;
      }
      const float* ps = part + (rr / 16) * wpm * G::kPart + (rr % 16) * DH + d;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sl = 0; sl < wpm; ++sl) {
        const float w = wts[rr * wpm + sl];
        const float4 v =
            *reinterpret_cast<const float4*>(ps + sl * G::kPart);
        o.x += w * v.x;
        o.y += w * v.y;
        o.z += w * v.z;
        o.w += w * v.w;
      }
      *reinterpret_cast<uint2*>(out_row(rr) + d) =
          make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
    }
    // rows past the live m-tiles (dead queries) are 0
    for (int i = threadIdx.x; i < (kMmaRows - live_rows) * (DH / 8);
         i += kMmaThreads) {
      const int rr = live_rows + i / (DH / 8);
      if (!row_ok(a, bk, tq, rr) || q0 + rr / g >= a.qmax) continue;
      reinterpret_cast<uint4*>(out_row(rr))[i % (DH / 8)] =
          make_uint4(0, 0, 0, 0);
    }
  }

  // writeback: the fresh K/V of this tile's queries, by the KV head's
  // first sub-group alone
  if (bk.sub == 0)
    write_fresh<DH, __nv_bfloat16, kMmaThreads>(a, r, kh, q0, fresh_end,
                                                ctx_raw, table, threadIdx.x);
  __syncthreads();                      // shared memory free for the next
}

// The work estimate of (row, query tile) pair p (block_of's order, pair p
// = items p * hkv .. p * hkv + hkv - 1): its key tiles, counted twice when
// more than 4 of the 8 m-tiles are live (a chunk's tile costs about twice
// a decode row's); 0 when no query is live.
template <int DH>
__device__ __forceinline__ int pair_cost(const RaggedArgs& a, int p,
                                         const int* q_lens,
                                         const int* ctx_lens) {
  const int g = a.gs;
  const int tq = kMmaRows / g;
  const int r = a.r - 1 - p % a.r;
  const int q0 = (a.n_tiles - 1 - p / a.r) * tq;
  const int qlen = q_lens[r];
  if (q0 >= qlen) return 0;
  constexpr int kK = Geo<DH>::kKeys;
  const int ctx = min(ctx_lens[r], a.mp * a.page_size);
  const int fresh_end = min(q0 + tq, qlen);
  const int tiles = (ctx + kK - 1) / kK + (fresh_end + kK - 1) / kK;
  return (fresh_end - q0) * g > 64 ? 2 * tiles : tiles;
}

// Persistent: gridDim.x blocks (one an SM). The rows' lengths are read
// into shared memory once. Every block then ranks the (row, query tile)
// pairs by pair_cost, heaviest first (ties in block_of's order), the same
// way (it is a function of the lengths alone), and the blocks take the
// items (pair, KV head) of that order in a snake: item i of round k goes to
// block i - k G in even rounds and to G - 1 - (i - k G) in odd ones, so the
// heaviest items land on different blocks. The dead items (no live query)
// rank last and only store zeros, so they go first to the blocks with the
// least live work. With more pairs than kMaxPairs (or rows than kMaxRows)
// the blocks walk block_of's order round-robin. ops/ragged_attention.py
// ragged_schedule is the same rule on the host.
// The ranking of the persistent blocks (ragged_mma_kernel's, below): the
// rows' lengths into lens (q_lens, then ctx_lens at kMaxRows), each pair's
// cost and the pairs by rank into order, by the block's kT threads. Ends
// synced.
template <int DH, int kT>
__device__ __forceinline__ void rank_pairs(const RaggedArgs& a, int* lens,
                                           int* cost, int* order) {
  const int n_pairs = a.r * a.n_tiles;
  for (int i = threadIdx.x; i < a.r; i += kT) {
    lens[i] = a.q_lens[i];
    lens[kMaxRows + i] = a.ctx_lens[i];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += kT)
    cost[p] = pair_cost<DH>(a, p, lens, lens + kMaxRows);
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += kT) {
    const int c = cost[p];
    int at = 0;
    for (int q = 0; q < n_pairs; ++q) {
      const int cq = cost[q];
      at += cq > c || (cq == c && q < p);
    }
    order[at] = p;
  }
  __syncthreads();
}

// Whether the persistent blocks rank the pairs (rank_pairs) or, past the
// rows and pairs whose lengths and ranks fit in shared memory, walk
// block_of's order round-robin.
__device__ __forceinline__ bool ranked(const RaggedArgs& a) {
  return a.r <= kMaxRows && a.r * a.n_tiles <= kMaxPairs;
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 1)
    ragged_mma_kernel(RaggedArgs a) {
  extern __shared__ __align__(16) char mma_smem[];
  __shared__ int pages[kMaxPages];
  __shared__ int lens[2 * kMaxRows];
  __shared__ int cost[kMaxPairs];
  __shared__ int order[kMaxPairs];
  const int n_blocks = gridDim.x;
  const int n_pairs = a.r * a.n_tiles;
  const int tq = kMmaRows / a.gs;
  if (!ranked(a)) {
    const int n_items = n_pairs * a.vh;
    for (int item = blockIdx.x; item < n_items; item += n_blocks)
      mma_item<DH>(a, block_of(a, item), mma_smem, pages, a.q_lens,
                   a.ctx_lens);
    return;
  }
  rank_pairs<DH, kMmaThreads>(a, lens, cost, order);
  const int* q_lens = lens;
  const int* ctx_lens = lens + kMaxRows;
  const int n_items = n_pairs * a.vh;
  for (int k = 0; k * n_blocks < n_items; ++k) {
    const int i = k * n_blocks +
                  ((k & 1) ? n_blocks - 1 - blockIdx.x : blockIdx.x);
    if (i >= n_items) continue;
    const int p = order[i / a.vh];
    const Block bk = block_of(a, p * a.vh + i % a.vh);
    if (cost[p] == 0)
      zero_tile<DH>(a, bk, bk.tile * tq, tq);
    else
      mma_item<DH>(a, bk, mma_smem, pages, q_lens, ctx_lens);
  }
}

template <int DH>
cudaError_t launch_mma(const RaggedArgs& a, int grid, cudaStream_t stream) {
  static bool attr_set = false;        // per instantiation (one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<DH>::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  ragged_mma_kernel<DH><<<grid, kMmaThreads, Geo<DH>::kSmem, stream>>>(a);
  return cudaGetLastError();
}


// ------------------------------------------- fp8 pools: warp specialised
//
// bf16 q over e4m3 or e5m2 pools (the fp8 instances, ragged_fp8_kernel):
// the tensor-core instance's items, schedule and warps (warp_tile on bf16
// K rows and f16 V rows), fed by a producer warpgroup. 12 warps: the 8 mma warps (the
// consumers, threads 0-255) and 4 producer warps (threads 256-383), which
// take the loads, the widening and the rounding off the consumers' chain:
// - One producer thread copies each context tile's fp8 K and V rows (one
//   byte a value: a box of rows a page segment) and each fresh tile's bf16
//   rows (one box each) into a ring of units with the Tensor Memory
//   Accelerator, completing on the unit's mbarrier, as many tiles ahead as
//   the ring holds (a context tile takes one unit, half a bf16 tile's
//   bytes, a fresh tile two: 7 units and the 2 buffers at Dh 128,
//   against the bf16 instance's 5 stages). Issued as 16-byte cp.async
//   from all 128 producer threads, the same loads were the producers'
//   longest step on the card (clock64 stamps of a tuning build).
// - Once a tile has landed, each producer thread widens its context
//   pieces into one of two buffers (exact; K rows to bf16, V rows to f16,
//   one conversion a pair, and the consumers take P V on the f16 core),
//   or rounds its fresh pieces through the pool dtype as the writeback
//   will store them (JAX's cast: bf16x8_to_f8x8, e5m2's +-inf from 61,440
//   and its NaN bytes) and widens them back, rows past the context (past
//   the fresh keys) as zeros, and the warpgroup hands the buffer over on a
//   named barrier (kBarFull + b, bar.arrive against the consumers'
//   bar.sync); the consumers give it back on kBarEmpty + b after their
//   warp_tile. No widening pass, copy issue or block barrier is left on
//   the consumers' chain: they wait only for a full buffer, which the
//   producers fill while they take the previous one.
// - The widening bounds the producers: a timing build that skipped it ran
//   below the bf16 instance, and a decode row, whose tiles ask little of
//   the mma warps, waits on it most. Letting the idle mma warps of a
//   decode row's item (4 of 8) fill half of each tile brought the decode
//   rows level with bf16 but slowed the chunks' mma warps by more (their
//   loop compiled beside the fill), so it was taken out (PERF.md).
// - setmaxnreg moves registers to the consumers within the block's pool
//   (384 threads of 168): 224 a thread for the mma warps and 56 for the
//   producers at Dh <= 128, 240 and 24 at Dh 256.
// - An m-tile's key slices (wpm > 1) merge pairwise through the Q tile
//   (the ring and buffers may already hold the next item's tiles); the
//   consumers write the fresh K/V back as the bf16 instance does.
// The producers skip dead items; both roles walk the block's items in
// the schedule's order and count the same tiles, so the barriers' phases
// agree.

constexpr int kProdWarps = 4;
constexpr int kProdThreads = 32 * kProdWarps;
constexpr int kWsThreads = kMmaThreads + kProdThreads;
// the registers a thread of the launch gets (65,536 / 384, in steps of 8),
// the block's pool that setmaxnreg redistributes: an increase past it
// waits forever. The mma warps' share by head width (they held 223-227
// registers at Dh 128 and 255 at Dh 256 as the 8 warps of a block); at
// Dh 128, 224 against the producers' 56 measured faster than 232 against
// 40 (the producers' widening keeps more pieces in flight).
constexpr int kLaunchRegs = 168;
template <int DH>
constexpr int kConsumerRegs = DH <= 128 ? 224 : 240;
template <int DH>
constexpr int kProducerRegs =
    (kWsThreads * kLaunchRegs - kMmaThreads * kConsumerRegs<DH>) /
    kProdThreads;
static_assert(kProducerRegs<128> == 56 && kProducerRegs<256> == 24,
              "the block's registers, redistributed");
// named barriers (0 is __syncthreads): buffer b full, empty; the
// consumers' own; the producers' own
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarConsumers = 5;
constexpr int kBarProducers = 6;
// the ring's units at most (their mbarriers are static shared memory)
constexpr int kMaxUnits = 16;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The fp8 instance's shared memory at head width DH: the Q tile, the two
// buffers (Geo's K/V tile each, V rows in f16), then the ring: kUnits
// units of one fp8 context tile each (its K rows, then its V rows, DH
// bytes a row, as the copies land them), as many as fit beside the static
// arrays; a fresh tile takes two units (its bf16 K rows in one, its V rows
// in the next).
template <int DH>
struct Ws {
  using G = Geo<DH>;
  static constexpr int kUnitBytes = 2 * G::kKeys * DH;
  static constexpr int kBufAt = G::kQBytes;
  static constexpr int kRingAt = kBufAt + 2 * G::kTileBytes;
  static constexpr int kStatic =
      4 * (kMaxPages + 2 * kMaxRows + 2 * kMaxPairs) + 8 * kMaxUnits;
  static constexpr int kFit = (232448 - kStatic - kRingAt) / kUnitBytes;
  static constexpr int kUnits = kFit < kMaxUnits ? kFit : kMaxUnits;
  static constexpr int kSmem = kRingAt + kUnits * kUnitBytes;
  // the merge's partials, in the Q tile: a writer warp's fragments (acc,
  // then m and l), 32 lanes apart, for each of 4 warp pairs
  static constexpr int kPart = (DH / 2 + 4) * 32;
  static_assert(kRingAt % 128 == 0 && kUnitBytes % 128 == 0,
                "the copies land 128-byte aligned");
  static_assert(kUnits >= 2, "a fresh tile fits the ring");
  static_assert(4 * kPart * 4 <= G::kQBytes, "the partials fit the Q tile");
};

// A live item's key sequence as both roles read it from the lengths: its
// context tiles, then its fresh tiles (Geo's kKeys keys each).
struct Seq {
  int r, kh, q0, qlen, ctx_raw, ctx, fresh_end, n_ctx_tiles, n_all;
};

template <int DH>
__device__ __forceinline__ Seq seq_of(const RaggedArgs& a, const Block& bk,
                                      const int* q_lens,
                                      const int* ctx_lens) {
  constexpr int kK = Geo<DH>::kKeys;
  const int tq = kMmaRows / a.gs;
  Seq s;
  s.r = bk.r;
  s.kh = bk.kh;
  s.q0 = bk.tile * tq;
  s.qlen = q_lens[bk.r];
  s.ctx_raw = ctx_lens[bk.r];
  s.ctx = min(s.ctx_raw, a.mp * a.page_size);
  s.fresh_end = min(s.q0 + tq, s.qlen);
  s.n_ctx_tiles = (s.ctx + kK - 1) / kK;
  s.n_all = s.n_ctx_tiles + (s.fresh_end + kK - 1) / kK;
  return s;
}

// The block's items in ragged_mma_kernel's order, as fn(block, live): the
// ranked pairs dealt in a snake, or block_of's order round-robin when the
// block does not rank (ranked).
template <typename Fn>
__device__ __forceinline__ void walk_items(const RaggedArgs& a, bool rank,
                                           const int* cost,
                                           const int* order, Fn&& fn) {
  const int n_blocks = gridDim.x;
  const int n_items = a.r * a.n_tiles * a.vh;
  if (!rank) {
    const int tq = kMmaRows / a.gs;
    for (int item = blockIdx.x; item < n_items; item += n_blocks) {
      const Block bk = block_of(a, item);
      fn(bk, bk.tile * tq < a.q_lens[bk.r]);
    }
    return;
  }
  for (int k = 0; k * n_blocks < n_items; ++k) {
    const int i = k * n_blocks +
                  ((k & 1) ? n_blocks - 1 - blockIdx.x : blockIdx.x);
    if (i >= n_items) continue;
    const int p = order[i / a.vh];
    fn(block_of(a, p * a.vh + i % a.vh), cost[p] > 0);
  }
}

// The producers' bookkeeping of the ring, the same in every producer
// thread: rd is the unit of the next tile to take, head the next free
// unit, `used` the units in flight or landed, `issued` the item's tiles
// issued; bit u of ph is the parity of unit u's mbarrier's next phase (a
// tile completes on its first unit's).
struct Ring {
  int head, rd, used, issued;
  uint32_t ph;
};

// The ring units tile t of an item takes: one a context tile, two a fresh
// one.
__device__ __forceinline__ int units_of(const Seq& s, int t) {
  return t < s.n_ctx_tiles ? 1 : 2;
}

// Thread 0 of the producers: tile t of an item into ring unit u (and u + 1
// for a fresh tile) by the Tensor Memory Accelerator, completing on unit
// u's mbarrier. A context tile is copied in boxes of `box` key rows (the
// host's box divides the page size, so a box never leaves its page), one
// box of K rows and one of V rows from each page segment that holds a key
// below ctx; the rows of a box past ctx (the writeback's positions) are
// copied but never used. A fresh tile is one box of the fresh K rows and
// one of V, kKeys rows of [R * Qmax, Hkv * Dh] from the item's row; rows
// past R * Qmax come as zeros.
template <int DH>
__device__ __forceinline__ void tma_tile(const RaggedArgs& a,
                                         const int* pg_ids, const Seq& s,
                                         int t, char* ring, int u,
                                         uint64_t* bars, int box,
                                         const CUtensorMap* kmap,
                                         const CUtensorMap* vmap,
                                         const CUtensorMap* fkmap,
                                         const CUtensorMap* fvmap) {
  using W = Ws<DH>;
  constexpr int kK = Geo<DH>::kKeys;
  char* dst = ring + u * W::kUnitBytes;
  uint64_t* bar = bars + u;
  if (t < s.n_ctx_tiles) {
    const int key0 = t * kK;
    const int n_box = (min(kK, s.ctx - key0) + box - 1) / box;
    mbar_expect_tx(bar, 2 * n_box * box * DH);
    for (int j = 0; j < n_box; ++j) {
      const int key = key0 + j * box;
      const int pg = key / a.page_size;
      const int row = static_cast<int>(
          (a.layer_base + pg_ids[pg]) * a.page_size + key - pg * a.page_size);
      tma_load_2d(dst + j * box * DH, kmap, s.kh * DH, row, bar);
      tma_load_2d(dst + (kK + j * box) * DH, vmap, s.kh * DH, row, bar);
    }
  } else {
    char* dst_v = ring + (u + 1 < W::kUnits ? u + 1 : 0) * W::kUnitBytes;
    const int row = s.r * a.qmax + (t - s.n_ctx_tiles) * kK;
    mbar_expect_tx(bar, 2 * kK * DH * 2);
    tma_load_2d(dst, fkmap, s.kh * DH, row, bar);
    tma_load_2d(dst_v, fvmap, s.kh * DH, row, bar);
  }
}

// Producer thread p's pieces of tile t, landed in ring unit u (and u + 1),
// into the buffer buf (K rows in bf16, then V rows in f16, at Geo's
// stride): context pieces widened (exact), fresh pieces rounded through
// T8 as the pool will hold them and widened back, so that the tile attends
// to the bytes the writeback stores; rows past ctx (past fresh_end) stored
// as zeros. V widens to f16 in one conversion a pair (e4m3) or one byte
// permute (e5m2), K to bf16 in four: the consumers take P V on the f16
// core. The
// thread takes piece p % kC of rows p / kC, + 128 / kC, ... of K and of V.
// A context piece's two 16-byte halves are stored in the order that puts
// a quarter-warp's eight stores on eight distinct bank groups.
template <int DH, typename T8>
__device__ __forceinline__ void fill_buffer(const Seq& s, int t,
                                            const char* ring, int u,
                                            char* buf, int p) {
  using G = Geo<DH>;
  using W = Ws<DH>;
  constexpr int kK = G::kKeys;
  const char* src = ring + u * W::kUnitBytes;
  if (t < s.n_ctx_tiles) {
    constexpr int kC = DH / 16;
    constexpr int kPass = kProdThreads / kC;
    static_assert(kK % kPass == 0, "whole passes a tile");
    const int c = p % kC;
    const int h0 = (c >> 2) & 1;
    const int n_valid = s.ctx - t * kK;
#pragma unroll
    for (int i = 0; i < 2 * (kK / kPass); ++i) {
      const int row = p / kC + (i >> 1) * kPass;   // key row of the tile
      const int at = (i & 1) * kK + row;           // K rows, then V rows
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (row < n_valid) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(src + at * DH + c * 16);
        if (i & 1) {
          lo = f8x8_to_f16x8<T8>(make_uint2(v.x, v.y));
          hi = f8x8_to_f16x8<T8>(make_uint2(v.z, v.w));
        } else {
          lo = f8x8_to_bf16x8<T8>(make_uint2(v.x, v.y));
          hi = f8x8_to_bf16x8<T8>(make_uint2(v.z, v.w));
        }
      }
      char* d = buf + at * G::kStride + c * 32;
      *reinterpret_cast<uint4*>(d + 16 * h0) = h0 ? hi : lo;
      *reinterpret_cast<uint4*>(d + 16 - 16 * h0) = h0 ? lo : hi;
    }
  } else {
    constexpr int kC = DH / 8;
    constexpr int kPass = kProdThreads / kC;
    static_assert(kK % kPass == 0, "whole passes a tile");
    const char* src_v = ring + (u + 1 < W::kUnits ? u + 1 : 0) * W::kUnitBytes;
    const int c = p % kC;
    const int n_valid = s.fresh_end - (t - s.n_ctx_tiles) * kK;
#pragma unroll
    for (int i = 0; i < 2 * (kK / kPass); ++i) {
      const int row = p / kC + (i >> 1) * kPass;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (row < n_valid) {
        const uint2 f8 = bf16x8_to_f8x8<T8>(*reinterpret_cast<const uint4*>(
            ((i & 1) ? src_v : src) + row * DH * 2 + c * 16));
        w = (i & 1) ? f8x8_to_f16x8<T8>(f8) : f8x8_to_bf16x8<T8>(f8);
      }
      *reinterpret_cast<uint4*>(buf + ((i & 1) * kK + row) * G::kStride +
                                c * 16) = w;
    }
  }
}

// The producer warpgroup: the block's live items, tile by tile, into the
// buffers (seq counts the tiles handed over; buffer seq & 1). Thread
// 0 issues the copies; every producer thread keeps the ring's bookkeeping,
// waits on each tile's mbarrier and fills its own pieces.
template <int DH, typename T8>
__device__ __forceinline__ void produce(
    const RaggedArgs& a, bool rank, const int* cost, const int* order,
    const int* q_lens, const int* ctx_lens, char* smem, int* pages,
    uint64_t* bars, int box, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* fkmap,
    const CUtensorMap* fvmap) {
  using W = Ws<DH>;
  const int p = threadIdx.x - kMmaThreads;
  char* ring = smem + W::kRingAt;
  Ring rg{0, 0, 0, 0, 0u};
  int seq = 0;
  walk_items(a, rank, cost, order, [&](const Block& bk, bool live) {
    if (!live) return;
    const Seq s = seq_of<DH>(a, bk, q_lens, ctx_lens);
    // the context's page ids, once every producer is done with the last
    // item's (thread 0 reads them when it issues)
    const int* table = a.page_table + static_cast<long long>(s.r) * a.mp;
    const int n_pg = (s.ctx + a.page_size - 1) / a.page_size;
    const int* pg_ids = table;
    bar_sync(kBarProducers, kProdThreads);
    if (n_pg <= kMaxPages) {
      for (int i = p; i < n_pg; i += kProdThreads) pages[i] = table[i];
      pg_ids = pages;
    }
    bar_sync(kBarProducers, kProdThreads);
    rg.issued = 0;
    auto issue_ahead = [&]() {
      while (rg.issued < s.n_all) {
        const int need = units_of(s, rg.issued);
        if (rg.used + need > W::kUnits) break;
        if (p == 0)
          tma_tile<DH>(a, pg_ids, s, rg.issued, ring, rg.head, bars, box,
                       kmap, vmap, fkmap, fvmap);
        rg.head = (rg.head + need) % W::kUnits;
        rg.used += need;
        ++rg.issued;
      }
    };
    issue_ahead();
    for (int t = 0; t < s.n_all; ++t) {
      const int u = rg.rd;
      mbar_wait(bars + u, (rg.ph >> u) & 1);    // tile t landed
      rg.ph ^= 1u << u;
      const int b = seq & 1;
      if (seq >= 2) bar_sync(kBarEmpty + b, kWsThreads);
      fill_buffer<DH, T8>(s, t, ring, u,
                          smem + W::kBufAt + b * Geo<DH>::kTileBytes, p);
      // the barrier orders the buffer's stores before the consumers'
      // loads (bar.arrive against their bar.sync)
      bar_arrive(kBarFull + b, kWsThreads);
      ++seq;
      const int need = units_of(s, t);
      rg.rd = (rg.rd + need) % W::kUnits;
      rg.used -= need;
      // every producer is done with the tile's units: they take the next
      // copies
      bar_sync(kBarProducers, kProdThreads);
      issue_ahead();
    }
  });
  // the consumers' last two hand-backs
  for (int k = max(seq - 2, 0); k < seq; ++k)
    bar_sync(kBarEmpty + (k & 1), kWsThreads);
}

// One live item on the consumers (threads 0-255): mma_item's Q tile, warps
// and warp_tile over the buffers the producers fill; the key slices of an
// m-tile merged pairwise through the Q tile; the outputs and the
// writeback as mma_item's.
template <int DH, typename T8>
__device__ __forceinline__ void consume_item(const RaggedArgs& a,
                                             const Block& bk, const Seq& s,
                                             char* smem, int& seq) {
  using G = Geo<DH>;
  using W = Ws<DH>;
  char* q_tile = smem;
  const int g = a.gs;
  const int tq = kMmaRows / g;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = s.q0;
  const int qlen = s.qlen;

  // the tile's queries (as mma_item's), once the last item's merge has
  // left the Q tile
  bar_sync(kBarConsumers, kMmaThreads);
  {
    constexpr int kChunks = G::kRowBytes / 16;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int i = threadIdx.x; i < kMmaRows * kChunks; i += kMmaThreads) {
      const int rr = i / kChunks;
      const int c = i - rr * kChunks;
      const int qi = q0 + rr / g;
      const bool ok = qi < qlen && row_ok(a, bk, tq, rr);
      const long long e =
          ok ? ((static_cast<long long>(s.r) * a.qmax + qi) * a.h +
                bk.head0 + rr % g) * DH + c * 8
             : 0;
      cp_async16(q_tile + rr * G::kStride + c * 16, q + e, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  bar_sync(kBarConsumers, kMmaThreads);

  // warps to m-tiles (as mma_item)
  const int n_mt = ((s.fresh_end - q0) * g + 15) / 16;
  int wpm = G::kKeys / 16;
  while (wpm > 1 && wpm * n_mt > kMmaWarps) wpm >>= 1;
  const int mt = warp / wpm;
  const int slot = warp - mt * wpm;
  const bool live = mt < n_mt;
  const int qw_lo = q0 + (16 * mt) / g;
  const int qw_hi = min(q0 + (16 * mt + 15) / g, qlen - 1);
  int qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qrow[h] = q0 + (16 * mt + lane / 4 + 8 * h) / g;

  const float scale2 = a.scale * 1.4426950408889634f;   // exp2 units
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < s.n_all; ++t, ++seq) {
    const int b = seq & 1;
    bar_sync(kBarFull + b, kWsThreads);         // buffer b holds tile t
    if (live) {
      const char* kt = smem + W::kBufAt + b * G::kTileBytes;
      const char* vt = kt + G::kKeys * G::kStride;
      const bool fresh = t >= s.n_ctx_tiles;
      const int key0 = (fresh ? t - s.n_ctx_tiles : t) * G::kKeys;
      if (wpm == 1) {
        warp_tile<DH, G::kKeys, true>(q_tile, kt, vt, mt, slot, fresh, key0,
                                      s.ctx, qrow, qw_lo, qw_hi, scale2, m,
                                      l, acc);
      } else if (wpm == 2) {
        warp_tile<DH, G::kKeys / 2, true>(q_tile, kt, vt, mt, slot, fresh,
                                          key0, s.ctx, qrow, qw_lo, qw_hi,
                                          scale2, m, l, acc);
      } else {
        if constexpr (G::kKeys >= 64)
          warp_tile<DH, G::kKeys / 4, true>(q_tile, kt, vt, mt, slot, fresh,
                                            key0, s.ctx, qrow, qw_lo, qw_hi,
                                            scale2, m, l, acc);
      }
    }
    bar_arrive(kBarEmpty + b, kWsThreads);      // ... and is free again
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // an m-tile's wpm key slices merge pairwise, slot s + step into slot s,
  // through the Q tile (free once every warp has taken its last tile):
  // each writer's fragments in the layout its partner holds them
  if (wpm > 1) {
    float* part = reinterpret_cast<float*>(q_tile);
    bar_sync(kBarConsumers, kMmaThreads);
    for (int step = 1; step < wpm; step <<= 1) {
      if (live && (slot & (2 * step - 1)) == step) {
        float* w = part + (warp >> 1) * W::kPart + lane;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          w[(DH / 2 + h) * 32] = m[h];
          w[(DH / 2 + 2 + h) * 32] = l[h];
        }
      }
      bar_sync(kBarConsumers, kMmaThreads);
      if (live && (slot & (2 * step - 1)) == 0) {
        const float* w = part + ((warp + step) >> 1) * W::kPart + lane;
        float wa[2], wb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mo = w[(DH / 2 + h) * 32];
          const float lo = w[(DH / 2 + 2 + h) * 32];
          const float mx = fmaxf(m[h], mo);
          wa[h] = fast_exp2(m[h] - mx);
          wb[h] = fast_exp2(mo - mx);
          l[h] = l[h] * wa[h] + lo * wb[h];
          m[h] = mx;
        }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = acc[n][e] * wa[e >> 1] + w[(4 * n + e) * 32] * wb[e >> 1];
      }
      if (2 * step < wpm) bar_sync(kBarConsumers, kMmaThreads);
    }
  }

  // outputs: live rows divided by their softmax sums, the others exactly 0
  // (stored, not scaled by 0), from each m-tile's first warp
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  auto out_row = [&](int rr) {
    return out + ((static_cast<long long>(s.r) * a.qmax + q0 + rr / g) * a.h +
                  bk.head0 + rr % g) * DH;
  };
  if (wpm == 1 || (live && slot == 0)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * mt + lane / 4 + 8 * h;
      const int qi = qrow[h];
      if (!row_ok(a, bk, tq, rr) || qi >= a.qmax) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      uint32_t* o = reinterpret_cast<uint32_t*>(out_row(rr) + 2 * (lane % 4));
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        o[4 * n] = qi < qlen ? pack_bf16(acc[n][2 * h] * inv,
                                         acc[n][2 * h + 1] * inv)
                             : 0u;
    }
  }
  if (wpm > 1) {
    // rows past the live m-tiles (dead queries) are 0
    const int live_rows = 16 * n_mt;
    for (int i = threadIdx.x; i < (kMmaRows - live_rows) * (DH / 8);
         i += kMmaThreads) {
      const int rr = live_rows + i / (DH / 8);
      if (!row_ok(a, bk, tq, rr) || q0 + rr / g >= a.qmax) continue;
      reinterpret_cast<uint4*>(out_row(rr))[i % (DH / 8)] =
          make_uint4(0, 0, 0, 0);
    }
  }

  // writeback, by the KV head's first sub-group alone
  if (bk.sub == 0)
    write_fresh<DH, T8, kMmaThreads>(
        a, s.r, s.kh, q0, s.fresh_end, s.ctx_raw,
        a.page_table + static_cast<long long>(s.r) * a.mp, threadIdx.x);
}

// Persistent, one block an SM, ranked as ragged_mma_kernel; then the
// producer warpgroup and the consumers part for the rest of the launch.
// kmap, vmap: the stacked pools as [rows, Hkv * Dh] bytes; fkmap, fvmap:
// the fresh K/V as [R * Qmax, Hkv * Dh] bf16 (launch_fp8).
template <int DH, typename T8>
__global__ void __launch_bounds__(kWsThreads, 1)
    ragged_fp8_kernel(RaggedArgs a, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap fkmap,
                      const __grid_constant__ CUtensorMap fvmap, int box) {
  extern __shared__ __align__(128) char ws_smem[];
  __shared__ int pages[kMaxPages];
  __shared__ int lens[2 * kMaxRows];
  __shared__ int cost[kMaxPairs];
  __shared__ int order[kMaxPairs];
  __shared__ __align__(8) uint64_t bars[kMaxUnits];   // a ring unit's copies
  if (threadIdx.x == 0) {
    for (int u = 0; u < Ws<DH>::kUnits; ++u) mbar_init(bars + u, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const bool rank = ranked(a);
  if (rank) rank_pairs<DH, kWsThreads>(a, lens, cost, order);
  else __syncthreads();                 // the mbarriers
  const int* q_lens = rank ? lens : a.q_lens;
  const int* ctx_lens = rank ? lens + kMaxRows : a.ctx_lens;
  if (threadIdx.x >= kMmaThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kProducerRegs<DH>));
    if (threadIdx.x == kMmaThreads) {     // the copies' descriptors, cached
      const CUtensorMap* maps[4] = {&kmap, &vmap, &fkmap, &fvmap};
      for (int i = 0; i < 4; ++i)
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(maps[i]))
                     : "memory");
    }
    produce<DH, T8>(a, rank, cost, order, q_lens, ctx_lens, ws_smem, pages,
                    bars, box, &kmap, &vmap, &fkmap, &fvmap);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(kConsumerRegs<DH>));
    const int tq = kMmaRows / a.gs;
    int seq = 0;
    walk_items(a, rank, cost, order, [&](const Block& bk, bool live) {
      if (live)
        consume_item<DH, T8>(a, bk, seq_of<DH>(a, bk, q_lens, ctx_lens),
                             ws_smem, seq);
      else
        zero_tile<DH>(a, bk, bk.tile * tq, tq);
    });
  }
}

// The tensor maps of the producers' copies: a 2-D view [rows, cols] of
// `base` (rows `row_bytes` apart), boxes of DH columns by box_rows rows
// landing dense; rows past `rows` come as zeros.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base,
                               CUtensorMapDataType type, int elem_bytes,
                               long long cols, long long rows, int box_cols,
                               int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The pools' box: the largest power of two up to Geo's kKeys that divides
// the page size (a box never leaves its page), at least 128 bytes of rows
// (the copies land 128-byte aligned); the pools' view takes every row the
// 32-bit coordinates reach (the producers copy only rows of the table's
// pages).
template <int DH, typename T8>
cudaError_t launch_fp8(const RaggedArgs& a, int grid, cudaStream_t stream) {
  using G = Geo<DH>;
  const int box = std::min(G::kKeys, a.page_size & -a.page_size);
  if (box * DH % 128) return cudaErrorInvalidValue;
  const long long fused = static_cast<long long>(a.hkv) * DH;
  CUtensorMap kmap, vmap, fkmap, fvmap;
  cudaError_t err;
  const long long pool_rows = 1ll << 31;
  if ((err = encode_rows(&kmap, a.k_pages, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         fused, pool_rows, DH, box)) != cudaSuccess ||
      (err = encode_rows(&vmap, a.v_pages, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         fused, pool_rows, DH, box)) != cudaSuccess ||
      (err = encode_rows(&fkmap, a.fresh_k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, fused, static_cast<long long>(a.r) * a.qmax, DH,
                         G::kKeys)) != cudaSuccess ||
      (err = encode_rows(&fvmap, a.fresh_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, fused, static_cast<long long>(a.r) * a.qmax, DH,
                         G::kKeys)) != cudaSuccess)
    return err;
  static bool attr_set = false;        // per instantiation (one card)
  if (!attr_set) {
    err = cudaFuncSetAttribute(ragged_fp8_kernel<DH, T8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ws<DH>::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  ragged_fp8_kernel<DH, T8><<<grid, kWsThreads, Ws<DH>::kSmem, stream>>>(
      a, kmap, vmap, fkmap, fvmap, box);
  return cudaGetLastError();
}

template <typename T8>
cudaError_t fp8_by_width(int dh, const RaggedArgs& a, int grid,
                         cudaStream_t st) {
  switch (dh) {
    case 32: return launch_fp8<32, T8>(a, grid, st);
    case 64: return launch_fp8<64, T8>(a, grid, st);
    case 128: return launch_fp8<128, T8>(a, grid, st);
    case 256: return launch_fp8<256, T8>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- launches

template <typename TQ, typename TKV, int E>
cudaError_t launch_simt(const RaggedArgs& a, cudaStream_t stream) {
  constexpr int kDh = 32 * E;
  constexpr int kSmem = static_cast<int>(sizeof(float)) *
                        (kRows * kDh + kKeys * (kDh + 1) + kKeys * kDh);
  static bool attr_set = false;        // per instantiation (one card)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_simt_kernel<TQ, TKV, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  ragged_simt_kernel<TQ, TKV, E>
      <<<a.r * a.vh * a.n_tiles, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t simt_by_width(int e, const RaggedArgs& a, cudaStream_t st) {
  switch (e) {
    case 1: return launch_simt<TQ, TKV, 1>(a, st);
    case 2: return launch_simt<TQ, TKV, 2>(a, st);
    case 4: return launch_simt<TQ, TKV, 4>(a, st);
    case 8: return launch_simt<TQ, TKV, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The fp8-pool instances (e4m3 and e5m2: bf16 q on the tensor cores, fp32 q
// on the CUDA cores), compiled apart in ragged_attention_fp8.cu so that the
// build runs them beside the bf16- and fp32-pool ones.
cudaError_t dispatch_fp8(int q_dtype, int kv_dtype, int dh,
                         const RaggedArgs& a, int grid, cudaStream_t st);

}  // namespace ra
}  // namespace die
