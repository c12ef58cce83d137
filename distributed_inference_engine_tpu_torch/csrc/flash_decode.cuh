// Flash-decode attention over a paged prefix plus the chunk's side window:
// the kernels (the launches and C entry points are in flash_decode.cu and,
// for e4m3 and e5m2 pools, flash_decode_fp8.cu and flash_decode_e5m2.cu).
// Paged attention's tensor-core route (paged_attention.cuh) runs the same
// tile ring and mma cores (fp8_block over fp8 pools) with no side window, and above 8 query rows the cores'
// warp pairs (kPairs).
//
// Replaces the TPU kernel ops/flash_decode.py:_flash_decode_kernel of the
// JAX package (wrapper flash_decode_attention_pallas). Per slot b it
// computes softmax(q . [prefix pages ++ side window] / sqrt(Dh)) . V with
// an fp32 online softmax, GQA included: the prefix keys are tokens
// t < prefix_lens[b] of the slot's pages, page p of layer l living at row
// layer_base + page_table[b, p] of the stacked [L*N, P, Hkv*Dh] pool; the
// side keys are entries j < n_side[b] of side_k[b].
//
// Any query-head group G = H / Hkv (the TPU kernel takes any, under its
// Hkv*Dh % 128 rule): the kernels are instances for sub-groups of GS in
// {1, 2, 4, 8} query heads, and 16 on the tensor cores at Dh 128 (the warp
// pairs, kPairs); a KV head's G heads are cut into n_sub = ceil(G / GS)
// sub-groups of GS rows (GS the least instance >= G, common.cuh
// subgroup_rows), the last one's rows past G dead: computed on zeros,
// never stored nor merged. Qwen2-7B's G = 7 is one sub-group of 8 with
// one dead row; G = 12 one of 16 (four dead rows), so each K/V tile is
// read once for all of a KV head's query heads, where two sub-groups of 8
// read it twice (the second time from L2) and ran level with SDPA; on the
// CUDA cores (fp32 q) G = 12 stays two sub-groups of 8.
//
// The writeback variant (die_flash_decode_fw) replaces the TPU kernel
// ops/flash_decode.py:_flash_decode_fw_kernel (wrapper
// flash_decode_attention_fw_pallas). It takes this step's fresh K/V as its
// own operand instead of a side window already holding it: it reads side
// entries j < min(side_idx[b], W), attends the fresh row as one extra key,
// and writes it into side[b, side_idx[b]], for active slots with
// side_idx < W. That is exactly the one-hot side write plus flash-decode
// that the plain version composes; an active slot at side_idx >= W (a
// state the engine never reaches: W is the chunk length) keeps its W
// entries and drops the fresh row, as the plain version does.
//
// Bound on the card: the K and V bytes read (one Hkv*Dh row per valid key
// and head group, each read once) over 3.35 TB/s: 20 MB, 6 us, at the
// Llama-3-8B decode shape (B 8, 4,873 prefix keys). The arithmetic is ~4
// FLOP per byte, far below the bf16 ridge (~295).
//
// Design: split KV, staged through shared memory.
// - The grid is (slot x KV head, run): a slot's prefix (mp * page_size
//   keys at most) is cut into n_split runs of `chunk` keys, sized by the
//   host from shapes only (ops/paged_attention.py paged_split; the
//   lengths are never read back). The previous design ran one block per
//   (slot, KV head), 64 blocks on 132 SMs at B 8, each streaming its slot
//   alone (~1 MB for 2,040 keys); at that shape the split gives 8 runs of
//   256 keys, 512 blocks, and a lone slot 32 runs of 64. A run past its
//   slot's keys has the empty state (m = -1e30, l = 0), which the merge
//   weighs 0.
// - The side window (and the fw variant's fresh row and its write) belongs
//   to the last run of each (slot, KV head) alone: no other block reads
//   the side buffers, so the write is done once and races nothing; the
//   reads of the side buffer are coherent (cp.async.cg reads through L2,
//   the CUDA-core side loads are plain loads in the fw variant).
// - Each block copies its run's page ids into shared memory with its
//   lengths, then streams the run in tiles of kKeys key rows (a K and a V
//   tile of 8 KB each) through a ring of kStages stages filled by
//   cp.async, 16 bytes a thread: two tiles are in flight while one is
//   used. A KV head's row in a page is Dh * itemsize contiguous bytes, and
//   each row's address comes from the page table, so runs that span pages
//   and pages that are not a multiple of the tile need no special case.
//   Rows past the run's end are zero-filled and masked (p = 0).
// - bf16 q over bf16 pools, on the tensor cores: the G query heads of the
//   KV head are padded to a 16-row tile in shared memory and each warp
//   takes 16-key sub-tiles: S = Q K^T and O += P V with mma.sync.m16n8k16
//   from ldmatrix loads (V transposed by ldmatrix.trans), P kept in
//   registers as bf16
//   (the S accumulator's layout is the A operand's, as in
//   FlashAttention-2). wgmma's 64-row tile would be 94% padding at G 4.
//   Rows of the tiles are padded by 16 bytes, so ldmatrix is
//   conflict-free. Four blocks fit an SM at Dh <= 128. The CUDA-core loop
//   below was also timed on bf16 over this grid and lost at every measured
//   shape (PERF.md), so bf16 takes the tensor cores alone.
// - e4m3 pools (the fp8 instances; the TPU kernels stage fp8 pages and
//   upcast them, ops/flash_decode.py:228-229). The pages move at one byte
//   a value: half the bytes, and half the bound. bf16 q stays on the
//   tensor cores (e4m3 is exact in bf16; the card's fp8 mma would round q
//   to e4m3, which the JAX kernels never do). An e4m3 tile holds its own
//   keys, twice a bf16 tile's (64 at Dh 128), so a run takes half the
//   tiles. ldmatrix moves 16-bit elements only, so each warp reads its
//   sub-tile's K and V as 32-bit words of four e4m3 values and widens them
//   in registers (fp8_block): no work tile and no barrier beyond the
//   ring's. The sub-tile is taken transposed (S^T = K Q^T, O^T += V^T P^T),
//   so the 8 query rows are the mma's N and no row is padding. The side
//   window and the fresh row stay in q's dtype (as in JAX) and ride the
//   same ring pass as bf16 side tiles of 16 keys after the run's e4m3
//   tiles, in the same online softmax. fp32 q over e4m3 takes the
//   CUDA-core loop, 8 values (8 bytes) a lane, the registers of its
//   bf16-pool form.
// - e5m2 pools (the e5m2 instances, flash_decode_e5m2.cu; the TPU kernels
//   widen any fp8 page alike): the e4m3 design and geometry, one byte a
//   value. Only the widening differs: an e5m2 value is an f16's top byte,
//   so a pair widens to f16x2 by one byte permute (V for the f16 P V core)
//   and on to bf16 through fp32 (K for the bf16 Q K^T core), exactly, with
//   +-inf (JAX's overflow) and NaN kept: the online softmax then gives NaN
//   or +-inf where the plain version does.
// - Every other dtype pair (fp32 keeps the 1e-4 tolerance that TF32 would
//   break): lane groups on CUDA cores, as in the paged kernel;
//   LPK lanes read a key row from the staged tile with 16-byte loads, each
//   group scores kU rows, rescales its state once and adds them; the side
//   keys are read straight from global memory after the staged prefix.
// - Merge: each block merges its warps through shared memory. With one run
//   it writes out; with more it writes its fp32 partial (common.cuh
//   SplitPartials) and bumps the (slot, KV head)'s arrival counter, and
//   the block that arrives last merges the runs with common.cuh
//   SplitMerge's weights (once per query head), writes out and resets the
//   counter to 0 for the next call. One device launch: at a 6 us bound a
//   second merge kernel's launch gap (2-3 us) would show. The counters
//   live with the caller (zeroed once, per stream): two calls on one
//   stream never share a count in flight, but two launches in flight at
//   once on different streams must not share them (ops/flash_decode.py
//   _scratch).
//
// What bounds it now: not the bytes (an L2-resident run is as slow as a
// cold one) but each block's chain of dependent steps, tile after tile:
// the copies of a tile, two barriers, one warp's sub-tile of mma.sync and
// softmax (over e4m3 pools also its K and V widened in registers), then
// the partials and the last block's merge.
// Halving the e4m3 tiles halves that chain over a run.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace die {
namespace fd {

constexpr float kNegInf = -1e30f;  // finite, as in ops/attention.py
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kRunPages = 64;  // a run's page ids kept in shared memory
constexpr int kMaxDevices = 16;

struct FdArgs {
  const void* q;           // [B, H, Dh] q dtype
  const void* k_pages;     // stacked [L*N, P, Hkv*Dh] kv dtype
  const void* v_pages;
  const int* page_table;   // [B, MP]
  const int* prefix_lens;  // [B]
  void* side_k;            // [B, W, Hkv, Dh] q dtype (written by fw)
  void* side_v;
  const int* n_side;       // [B] valid side entries (plain variant)
  const void* fresh_k;     // [B, 1, Hkv, Dh] q dtype (fw variant)
  const void* fresh_v;
  const int* side_idx;     // [B] this step's side column (fw variant)
  const int* active;       // [B] 0/1 (fw variant)
  void* out;               // [B, H, Dh] q dtype
  float* ws;               // split partials (n_split > 1)
  int* counters;           // [B * Hkv] run arrivals, 0 between calls
  int b, hkv, page_size, mp, w, chunk;
  int g, n_sub;            // query heads a KV head; sub-groups a KV head
  long long layer_base;
};

// Staged tile geometry for rows of DH elements of T: kKeys rows (a tile of
// 8 KB, 16 to 64 rows; the CUDA cores' e4m3 tile takes as many rows as a
// bf16 one) at a stride padded by 16 bytes. kWide: the tensor cores' e4m3
// tile, which holds its own keys, twice a bf16 tile's up to 64 (64 at Dh
// 128, 32 at Dh 256): 8 KB of K rows.
template <typename T, int DH, bool kWide = false>
struct Tile {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kRaw =
      8192 / (kIsFp8<T> && !kWide ? 2 * kRowBytes : kRowBytes);
  static constexpr int kKeys = kRaw > 64 ? 64 : (kRaw < 16 ? 16 : kRaw);
  static constexpr int kStageBytes = 2 * kKeys * kStride;  // K and V
  static_assert(kRowBytes % 16 == 0, "rows of whole 16-byte pieces");
};

// The tensor cores' fp8 tile (fp8_block; e4m3 and e5m2 alike, one byte a
// value).
template <int DH>
using Tile8 = Tile<fp8, DH, true>;

// This block's keys: run `split` of the slot's prefix and, for the last
// run, the side entries and the fw variant's fresh row. The run's page ids
// are pages[page - pg0]. Its query rows: sub-group `sub` of the KV head,
// rows row0 .. row0 + gl - 1 of [B * H] (gl <= GS live).
struct Plan {
  int b, kh, sub, gl, split, s_lo, n_pref, ns, sidx, pg0;
  long long row0;
  bool fresh;
  const int* pages;
};

// The page ids pg0 .. pg0 + n_pg - 1 of a slot's page-table row, copied
// into run_pages by the block's kT threads when they fit (else read from
// the table); the caller syncs before using them.
template <int kT>
__device__ __forceinline__ const int* run_page_ids(const int* row, int pg0,
                                                   int n_pg, int* run_pages) {
  if (n_pg > kRunPages) return row + pg0;
  for (int i = threadIdx.x; i < n_pg; i += kT) run_pages[i] = row[pg0 + i];
  return run_pages;
}

// The block's query rows: blockIdx.x is (slot, KV head, sub-group of GS
// rows), blockIdx.y the run.
template <int GS>
__device__ __forceinline__ void plan_rows(const FdArgs& a, Plan& p) {
  const int bk = blockIdx.x;
  const int per_slot = a.hkv * a.n_sub;
  p.b = bk / per_slot;
  const int rem = bk - p.b * per_slot;
  p.kh = rem / a.n_sub;
  p.sub = rem - p.kh * a.n_sub;
  p.gl = min(GS, a.g - p.sub * GS);
  p.row0 = static_cast<long long>(p.b) * a.hkv * a.g + p.kh * a.g +
           p.sub * GS;
  p.split = blockIdx.y;
}

// The block's plan; the run's page ids are copied into run_pages (when
// they fit) in the same breath as the lengths are read, so the tile loop
// never waits on the page table. The caller syncs before using them.
template <bool FW, int GS>
__device__ __forceinline__ Plan make_plan(const FdArgs& a, int* run_pages) {
  Plan p;
  plan_rows<GS>(a, p);
  p.s_lo = p.split * a.chunk;
  p.pg0 = p.s_lo / a.page_size;
  p.pages = run_page_ids<kThreads>(
      a.page_table + static_cast<long long>(p.b) * a.mp, p.pg0,
      min(a.mp, (p.s_lo + a.chunk - 1) / a.page_size + 1) - p.pg0,
      run_pages);
  const int plen = min(a.prefix_lens[p.b], a.mp * a.page_size);
  p.n_pref = max(0, min(plen, p.s_lo + a.chunk) - p.s_lo);
  p.ns = 0;
  p.sidx = 0;
  p.fresh = false;
  if (p.split == static_cast<int>(gridDim.y) - 1) {  // the side run
    if constexpr (FW) {
      p.sidx = a.side_idx[p.b];
      p.ns = min(max(p.sidx, 0), a.w);
      p.fresh = a.active[p.b] != 0 && p.sidx >= 0 && p.sidx < a.w;
    } else {
      p.ns = min(max(a.n_side[p.b], 0), a.w);
    }
  }
  return p;
}

// Stage tile `tile` of the block's key sequence (rows v < n_rows; the
// prefix run first, then, with kSide, the side entries and the fresh row)
// into dst: the K tile, then the V tile. Rows past n_rows are zeros. Each
// thread copies 16-byte piece c of rows r0, r0 + kStep, ...: it finds all
// their sources first (the page and offset stepped along, no division a
// row), then issues the copies together.
template <typename TQ, typename TKV, int DH, bool kSide,
          typename T = Tile<TKV, DH>>
__device__ __forceinline__ void stage_tile(const FdArgs& a, const Plan& p,
                                           char* dst, int tile,
                                           int n_rows) {
  constexpr int kChunks = T::kRowBytes / 16;             // pieces a row
  constexpr int kStep = kThreads / kChunks;              // rows a pass
  constexpr int kRows = (T::kKeys + kStep - 1) / kStep;  // passes
  static_assert(kChunks <= kThreads && kThreads % kChunks == 0,
                "a pass covers whole rows");
  const int c = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const long long fused = static_cast<long long>(a.hkv) * DH;
  const long long piece = c * (16 / static_cast<int>(sizeof(TKV)));
  const TKV* k_pages = static_cast<const TKV*>(a.k_pages);
  const TKV* v_pages = static_cast<const TKV*>(a.v_pages);
  const int t0 = p.s_lo + tile * T::kKeys + r0;  // this thread's first key
  int pg = t0 / a.page_size;
  int off = t0 - pg * a.page_size;
  const void* ks[kRows];
  const void* vs[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i * kStep;
    const int v = tile * T::kKeys + r;
    ks[i] = k_pages;
    vs[i] = v_pages;
    if (r < T::kKeys && v < n_rows) {
      if (v < p.n_pref) {
        const long long e =
            ((a.layer_base + p.pages[pg - p.pg0]) * a.page_size + off) *
                fused +
            static_cast<long long>(p.kh) * DH + piece;
        ks[i] = k_pages + e;
        vs[i] = v_pages + e;
      } else if constexpr (kSide) {
        const int j = v - p.n_pref;
        const bool side = j < p.ns;
        const long long e =
            (side ? ((static_cast<long long>(p.b) * a.w + j) * a.hkv + p.kh)
                  : (static_cast<long long>(p.b) * a.hkv + p.kh)) *
                DH +
            c * (16 / static_cast<int>(sizeof(TQ)));
        ks[i] = static_cast<const TQ*>(side ? a.side_k : a.fresh_k) + e;
        vs[i] = static_cast<const TQ*>(side ? a.side_v : a.fresh_v) + e;
      }
    }
    off += kStep;
    while (off >= a.page_size) {
      off -= a.page_size;
      ++pg;
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i * kStep;
    if (r < T::kKeys) {
      const bool ok = tile * T::kKeys + r < n_rows;
      char* dk = dst + r * T::kStride + c * 16;
      cp_async16(dk, ks[i], ok);
      cp_async16(dk + T::kKeys * T::kStride, vs[i], ok);
    }
  }
}

// The ring: stage the block's n_rows key rows tile by tile through
// kStages buffers and call use(stage, tile) on each tile once it landed.
template <typename TQ, typename TKV, int DH, bool kSide, typename Use>
__device__ __forceinline__ void stream_tiles(const FdArgs& a, const Plan& p,
                                             char* ring, int n_rows,
                                             Use&& use) {
  using T = Tile<TKV, DH>;
  const int n_tiles = (n_rows + T::kKeys - 1) / T::kKeys;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      stage_tile<TQ, TKV, DH, kSide>(a, p, ring + t * T::kStageBytes, t,
                                     n_rows);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int tn = t + kStages - 1;
    if (tn < n_tiles)
      stage_tile<TQ, TKV, DH, kSide>(
          a, p, ring + (tn % kStages) * T::kStageBytes, tn, n_rows);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed (this thread's part)
    __syncthreads();               // ... and every thread's
    use(ring + (t % kStages) * T::kStageBytes, t);
    __syncthreads();               // the stage is free for tile t + kStages
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- simt

// One online-softmax step of a lane group's G query heads over U key rows
// (kr/vr point at this lane's EL elements of each row; rows with
// valid false are not read and weigh 0). The LPK lanes of a group reduce
// their partial dot products by shuffles; every lane runs them.
template <typename TR, bool kRO, int G, int EL, int LPK, int U>
__device__ __forceinline__ void simt_rows(const float (&qr)[G][EL],
                                          const TR* const (&kr)[U],
                                          const TR* const (&vr)[U],
                                          const bool (&valid)[U], float scale,
                                          float (&m)[G], float (&l)[G],
                                          float (&acc)[G][EL]) {
  float s[U][G];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float k[EL];
    if (valid[u]) {
      load_row<TR, EL, kRO>(kr[u], k);
    } else {
#pragma unroll
      for (int e = 0; e < EL; ++e) k[e] = 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EL; ++e) dot += qr[gi][e] * k[e];
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u][gi] = valid[u] ? dot * scale : kNegInf;
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float mn = m[gi];
#pragma unroll
    for (int u = 0; u < U; ++u) mn = fmaxf(mn, s[u][gi]);
    const float alpha = expf(m[gi] - mn);
    l[gi] *= alpha;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[gi][e] *= alpha;
    m[gi] = mn;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!valid[u]) continue;
    float v[EL];
    load_row<TR, EL, kRO>(vr[u], v);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float pr = expf(s[u][gi] - m[gi]);
      l[gi] += pr;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[gi][e] = fmaf(pr, v[e], acc[gi][e]);
    }
  }
}

// The CUDA-core path: the staged prefix, then the side keys (and the
// fresh row) from global memory; each warp leaves its merged state in
// scratch[warp][G][2 + DH].
template <typename TQ, typename TKV, int DH, int G, bool FW>
__device__ __forceinline__ void simt_block(const FdArgs& a, const Plan& p,
                                           char* ring, float* scratch,
                                           float scale) {
  constexpr int kVec = kVecOf<TKV>;
  constexpr int kLpk = DH / kVec > 32 ? 32 : DH / kVec;  // lanes a row
  constexpr int kEl = DH / kLpk;                          // elements a lane
  constexpr int kKpw = 32 / kLpk;                         // rows a warp
  constexpr int kSweep = kWarps * kKpw;                   // rows a block
  using T = Tile<TKV, DH>;
  constexpr int kPer = T::kKeys / kSweep;                 // sweeps a tile
  static_assert(kPer >= 1 && T::kKeys % kSweep == 0, "tile of sweeps");
  constexpr int kU0 = G >= 8 ? 2 : 4;
  constexpr int kU = kU0 < kPer ? kU0 : kPer;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kLpk;
  const int lk = lane - grp * kLpk;

  // dead rows (gi >= gl) repeat the last live one: computed, never stored
  float qr[G][kEl];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_row<TQ, kEl>(static_cast<const TQ*>(a.q) +
                          (p.row0 + min(gi, p.gl - 1)) * DH + lk * kEl,
                      qr[gi]);
  float m[G], l[G], acc[G][kEl];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kEl; ++e) acc[gi][e] = 0.f;
  }

  stream_tiles<TQ, TKV, DH, false>(
      a, p, ring, p.n_pref, [&](const char* st, int t) {
#pragma unroll
        for (int i = 0; i < kPer / kU; ++i) {
          const TKV* kr[kU];
          const TKV* vr[kU];
          bool valid[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int r = (i * kU + u) * kSweep + warp * kKpw + grp;
            kr[u] = reinterpret_cast<const TKV*>(st + r * T::kStride) +
                    lk * kEl;
            vr[u] = reinterpret_cast<const TKV*>(
                        st + (T::kKeys + r) * T::kStride) +
                    lk * kEl;
            valid[u] = t * T::kKeys + r < p.n_pref;
          }
          simt_rows<TKV, false, G, kEl, kLpk, kU>(qr, kr, vr, valid, scale,
                                                  m, l, acc);
        }
      });

  // side keys of the last run: entries j < ns, then the fresh row
  const int n_side_keys = p.ns + (p.fresh ? 1 : 0);
  const TQ* side_k = static_cast<const TQ*>(a.side_k);
  const TQ* side_v = static_cast<const TQ*>(a.side_v);
  for (int base = 0; base < n_side_keys; base += kSweep) {
    const int j = base + warp * kKpw + grp;
    const bool valid[1] = {j < n_side_keys};
    const TQ* kr[1] = {side_k};
    const TQ* vr[1] = {side_v};
    if (valid[0]) {
      const long long at =
          j < p.ns ? ((static_cast<long long>(p.b) * a.w + j) * a.hkv + p.kh)
                   : (static_cast<long long>(p.b) * a.hkv + p.kh);
      const long long off = at * DH + lk * kEl;
      kr[0] = (j < p.ns ? side_k : static_cast<const TQ*>(a.fresh_k)) + off;
      vr[0] = (j < p.ns ? side_v : static_cast<const TQ*>(a.fresh_v)) + off;
    }
    // the fw variant writes the side buffers: plain (coherent) loads there
    simt_rows<TQ, !FW, G, kEl, kLpk, 1>(qr, kr, vr, valid, scale, m, l,
                                        acc);
  }

  // merge the warp's lane groups (lanes lk, lk + kLpk, ... hold the same
  // elements of different key subsets)
#pragma unroll
  for (int off = kLpk; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      float acco[kEl];
#pragma unroll
      for (int e = 0; e < kEl; ++e)
        acco[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      merge_state<kEl>(m[gi], l[gi], acc[gi], mo, lo, acco);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float* slot = scratch + (warp * G + gi) * (2 + DH);
      if (lk == 0) {
        slot[0] = m[gi];
        slot[1] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < kEl; ++e) slot[2 + lk * kEl + e] = acc[gi][e];
    }
  }
}

// ------------------------------------------------------------------ mma

// Up to 8 query rows (G <= 8), a warp holds them all and the warps take
// turns over a tile's 16-key sub-tiles. Above 8 (the 16-row instances of
// paged attention and flash-decode) the warps go in pairs: the two warps of a pair take the same
// sub-tiles, one the rows 0-7 and the other the rows 8-15, so a tile's
// sub-tiles keep twice the warps busy and each warp's chain is the 8-row
// one; each pair keeps one state per row (kStates of them a block).
template <int G>
constexpr bool kPairs = G > 8;
template <int G>
constexpr int kStates = kPairs<G> ? kWarps / 2 : kWarps;

// One staged tile of bf16 keys on the tensor cores: tile t of a key
// sequence of n_keys keys (K rows at st, V rows after them), each warp
// (pair) taking the 16-key sub-tiles i with i % kStates == its index. Lane
// i holds query row i / 4 of its warp's 8 (rows past G are the padding)
// and, per 8-wide column tile n of the output, the columns 8n + 2 (i % 4)
// and + 1; scores in log2 units.
template <int DH, int G>
__device__ __forceinline__ void mma_tile(const char* st, int t, int n_keys,
                                         const char* q_tile, float scale2,
                                         float& m, float& l,
                                         float (&acc)[DH / 8][4]) {
  using T = Tile<__nv_bfloat16, DH>;
  constexpr int kSub = T::kKeys / 16;  // 16-key sub-tiles a tile
  static_assert(T::kKeys % 16 == 0, "tiles of 16-key sub-tiles");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int turn = kPairs<G> ? warp / 2 : warp;
  // the Q row whose address this lane gives ldmatrix: the upper warp of a
  // pair takes rows 8-15 as its fragment's rows 0-7 (its fragment rows
  // 8-15, rows 0-7 of the tile, are the padding)
  const int q_row = kPairs<G> ? (lane + (warp % 2) * 8) % 16 : lane % 16;
  const char* vt = st + T::kKeys * T::kStride;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int key0 = t * T::kKeys + j * 16;
    if ((t * kSub + j) % kStates<G> != turn || key0 >= n_keys) continue;
    // S = Q K^T over the sub-tile's 16 keys: two 8-key column tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, q_tile + q_row * T::kStride +
                      (kk * 16 + (lane / 16) * 8) * 2);
      ldsm_x4(kb, st + (j * 16 + (lane / 16) * 8 + lane % 8) * T::kStride +
                      (kk * 16 + ((lane / 8) % 2) * 8) * 2);
      mma_bf16_16816(s[0], qa, kb[0], kb[1]);
      mma_bf16_16816(s[1], qa, kb[2], kb[3]);
    }
    // scale and mask this lane's keys key0 + 8 nt + 2 (lane % 4) + e
    float sc[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + (i / 2) * 8 + 2 * (lane % 4) + (i % 2);
      ok[i] = key < n_keys;
      sc[i] = ok[i] ? s[i / 2][i % 2] * scale2 : kNegInf;
    }
    float mx = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    m = mn;
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = ok[i] ? exp2f(sc[i] - mn) : 0.f;  // masked keys weigh 0
    l = l * alpha + (pr[0] + pr[1]) + (pr[2] + pr[3]);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[n][0] *= alpha;
      acc[n][1] *= alpha;
    }
    // O += P V: P (bf16, rows 8..15 zero) as the A operand
    const uint32_t pa[4] = {pack_bf16(pr[0], pr[1]), 0u,
                            pack_bf16(pr[2], pr[3]), 0u};
#pragma unroll
    for (int n2 = 0; n2 < DH / 16; ++n2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vt + (j * 16 + lane % 16) * T::kStride +
                            (n2 * 16 + (lane / 16) * 8) * 2);
      mma_bf16_16816(acc[2 * n2], pa, vb[0], vb[1]);
      mma_bf16_16816(acc[2 * n2 + 1], pa, vb[2], vb[3]);
    }
  }
}

// The tensor-core path over bf16 pools (bf16 q and side). The Q tile (the
// G heads padded to 16 rows) lands with the first tiles; the block's whole
// key sequence (prefix run, side entries, fresh row) is staged and taken
// tile by tile.
template <int DH, int G>
__device__ __forceinline__ void mma_block(const FdArgs& a, const Plan& p,
                                          char* ring, char* q_tile,
                                          float* scratch, float scale) {
  using T = Tile<__nv_bfloat16, DH>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Q padded to 16 rows (zeros past the live gl), staged with the first
  // tiles
  const uint4* q = reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(a.q) + p.row0 * DH);
  constexpr int kQChunks = T::kRowBytes / 16;
  for (int i = threadIdx.x; i < 16 * kQChunks; i += kThreads) {
    const int r = i / kQChunks;
    const int c = i - r * kQChunks;
    cp_async16(q_tile + r * T::kStride + c * 16,
               q + min(r, p.gl - 1) * kQChunks + c, r < p.gl);
  }

  // scores in log2 units (exp2 is one instruction); m goes back to
  // natural units for the merges
  const float scale2 = scale * 1.4426950408889634f;
  float m = kNegInf, l = 0.f;  // row lane / 4; l is this lane's part
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_keys = p.n_pref + p.ns + (p.fresh ? 1 : 0);
  stream_tiles<__nv_bfloat16, __nv_bfloat16, DH, true>(
      a, p, ring, n_keys, [&](const char* st, int t) {
        mma_tile<DH, G>(st, t, n_keys, q_tile, scale2, m, l, acc);
      });

  // the quad's parts of l; then row lane / 4 (+ 8 in a pair's upper warp)
  // into the warp's (pair's) state in scratch
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const int gi = lane / 4 + (kPairs<G> ? (warp % 2) * 8 : 0);
  if (gi < G) {
    const int state = kPairs<G> ? warp / 2 : warp;
    float* slot = scratch + (state * G + gi) * (2 + DH);
    if (lane % 4 == 0) {
      slot[0] = m * 0.6931471805599453f;  // ln 2: back to natural units
      slot[1] = l;
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      slot[2 + n * 8 + 2 * (lane % 4)] = acc[n][0];
      slot[2 + n * 8 + 2 * (lane % 4) + 1] = acc[n][1];
    }
  }
}

// ------------------------------------------------- e4m3 and e5m2 pools
//
// bf16 q over fp8 pools on the tensor cores (written for e4m3; e5m2 takes
// the same path, only its pairs widen by byte permutes: common.cuh
// f8x2_to_f16x2). The fragments are read
// straight from the staged e4m3 tile and widened in registers: no bf16
// work tile, no widening pass, no barrier of its own. A warp's 16-key
// sub-tile is taken transposed, so that the block's (up to) 8 query rows
// are the mma's N and no row of the m16 tile is padding:
//   S^T  = K Q^T    (M: the 16 keys, N: 8 queries, K: 16 head dims a step)
//   O^T += V^T P^T  (M: 16 head dims, N: 8 queries, K: the 16 keys)
// S^T on the bf16 core (q stays bf16; e4m3 is exact in bf16), O^T on the
// f16 core: e4m3 is exact in f16 too and widens to it in one conversion
// (to bf16 in four), and P in [0, 1] keeps 3 more bits in f16.
// A (K rows, V^T rows) comes from shared memory as 32-bit words of four
// consecutive e4m3 dims (ldmatrix moves 16-bit elements only), B from
// registers: Q^T loaded from global memory once a block, P^T the S^T
// accumulator's probabilities moved into B's layout by movmatrix.
//
// The words' dim orders (kdim for K and Q^T, vdim for V^T's rows and so
// the output's) are common.cuh's.

// One warp's 16-key sub-tile (K rows at kt, V rows at vt, `stride` bytes
// apart; fp8 prefix rows or bf16 side rows), keys below n_valid live,
// against the warp's 8 queries (Q^T in qf): the transposed online-softmax
// step. Lane i holds queries 2 (i % 4) and + 1 (h = 0, 1): S^T of keys
// i / 4 and i / 4 + 8; m and l of its queries (l its part, summed over the
// lane rows at the end); O^T of dim rows i / 4 and i / 4 + 8 of every
// m-tile. Scores in log2 units.
template <typename T, int DH>
__device__ __forceinline__ void fp8_subtile(
    const char* kt, const char* vt, int stride, int n_valid,
    const uint32_t (&qf)[DH / 16][2], float scale2, float (&m)[2],
    float (&l)[2], float (&acc)[DH / 16][4]) {
  using KG = KGroup<T, DH>;
  using VG = VGroup<T, DH>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // S^T = K Q^T: s[0], s[1] key g, queries 2t, 2t + 1; s[2], s[3] key g + 8
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < KG::kGroups; ++c) {
    KG k0, k1;
    k0.load(kt + g * stride, c, t);
    k1.load(kt + (g + 8) * stride, c, t);
#pragma unroll
    for (int u = 0; u < KG::kSteps; ++u) {
      const int kk = KG::kSteps * c + u;
      const uint32_t a[4] = {k0.lo(u), k1.lo(u), k0.hi(u), k1.hi(u)};
      mma_bf16_16816(s, a, qf[kk][0], qf[kk][1]);
    }
  }
  float sc[4];
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ok[i] = g + 8 * (i >> 1) < n_valid;
    sc[i] = ok[i] ? s[i] * scale2 : kNegInf;
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the query's max over the sub-tile's keys: the lane's two, then the
    // eight lane rows
    float mx = fmaxf(sc[h], sc[h + 2]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float mn = fmaxf(m[h], mx);
    alpha[h] = exp2f(m[h] - mn);
    m[h] = mn;
  }
  float pr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pr[i] = ok[i] ? exp2f(sc[i] - m[i & 1]) : 0.f;   // masked keys weigh 0
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (pr[h] + pr[h + 2]);
#pragma unroll
  for (int mi = 0; mi < DH / 16; ++mi) {
    acc[mi][0] *= alpha[0];
    acc[mi][1] *= alpha[1];
    acc[mi][2] *= alpha[0];
    acc[mi][3] *= alpha[1];
  }
  // P^T (f16 against e4m3 V, bf16 against the side tile's bf16 V): key
  // g's row of queries, transposed to query g's row of keys
  const uint32_t b0 = movmatrix_trans(kIsFp8<T> ? pack_f16(pr[0], pr[1])
                                                : pack_bf16(pr[0], pr[1]));
  const uint32_t b1 = movmatrix_trans(kIsFp8<T> ? pack_f16(pr[2], pr[3])
                                                : pack_bf16(pr[2], pr[3]));
  // O^T += V^T P^T
  const char* v0 = vt + (2 * t) * stride;
#pragma unroll
  for (int c = 0; c < VG::kGroups; ++c) {
    VG va, vb, vc, vd;
    va.load(v0, c, g);
    vb.load(v0 + stride, c, g);
    vc.load(v0 + 8 * stride, c, g);
    vd.load(v0 + 9 * stride, c, g);
#pragma unroll
    for (int u = 0; u < VG::kQs; ++u) {
      const int q = VG::kQs * c + u;
      uint32_t a0[4], a1[4];
      v_frags<T, DH>(va, vb, vc, vd, u, a0, a1);
      if constexpr (kIsFp8<T>) {
        mma_f16_16816(acc[2 * q], a0, b0, b1);
        mma_f16_16816(acc[2 * q + 1], a1, b0, b1);
      } else {
        mma_bf16_16816(acc[2 * q], a0, b0, b1);
        mma_bf16_16816(acc[2 * q + 1], a1, b0, b1);
      }
    }
  }
}

// The side tile of the e4m3 instances: the side entries and the fresh
// row, in q's dtype (bf16), 16 keys a tile, staged into a ring stage after
// the run's e4m3 tiles (K rows, then V rows, at the bf16 tile's stride).
template <int DH>
struct SideTile {
  static constexpr int kKeys = 16;
  static constexpr int kStride = Tile<__nv_bfloat16, DH>::kStride;
  static_assert(2 * kKeys * kStride <= Tile8<DH>::kStageBytes,
                "a side tile fits an e4m3 stage");
};

// Stage side tile s: side keys 16 s .. 16 s + 15 (entries j < ns, then the
// fresh row at j == ns), zeros past n_side.
template <int DH>
__device__ __forceinline__ void stage_side(const FdArgs& a, const Plan& p,
                                           char* dst, int s, int n_side) {
  using TS = SideTile<DH>;
  constexpr int kChunks = 2 * DH / 16;             // 16-byte pieces a row
  for (int i = threadIdx.x; i < TS::kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int j = s * TS::kKeys + r;
    const void* ks = a.k_pages;                    // not read past n_side
    const void* vs = a.k_pages;
    if (j < n_side) {
      const bool side = j < p.ns;
      const long long e =
          (side ? ((static_cast<long long>(p.b) * a.w + j) * a.hkv + p.kh)
                : (static_cast<long long>(p.b) * a.hkv + p.kh)) * DH +
          c * 8;
      ks = static_cast<const __nv_bfloat16*>(side ? a.side_k : a.fresh_k) + e;
      vs = static_cast<const __nv_bfloat16*>(side ? a.side_v : a.fresh_v) + e;
    }
    char* d = dst + r * TS::kStride + c * 16;
    cp_async16(d, ks, j < n_side);
    cp_async16(d + TS::kKeys * TS::kStride, vs, j < n_side);
  }
}

// The e4m3 path of a tensor-core block (flash-decode and paged attention).
// One ring pass: the run's e4m3 tiles, then (the last run of flash-decode)
// the side tiles, each tile's 16-key sub-tiles taken by the warps (pairs)
// in turn; each warp (pair) leaves its states in scratch as mma_block's.
template <typename T8, int DH, int G>
__device__ __forceinline__ void fp8_block(const FdArgs& a, const Plan& p,
                                          char* ring, float* scratch,
                                          float scale) {
  using TT = Tile8<DH>;
  using TS = SideTile<DH>;
  constexpr int kSub = TT::kKeys / 16;    // sub-tiles an fp8 tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int turn = kPairs<G> ? warp / 2 : warp;
  const int half = kPairs<G> ? warp % 2 : 0;   // query rows 0-7 or 8-15

  // Q^T: lane / 4 is the query (rows past the live gl are zeros)
  uint32_t qf[DH / 16][2];
  {
    using QG = KGroup<__nv_bfloat16, DH>;
    const int row = half * 8 + lane / 4;
    const char* q = reinterpret_cast<const char*>(
        static_cast<const __nv_bfloat16*>(a.q) +
        (p.row0 + min(row, p.gl - 1)) * DH);
#pragma unroll
    for (int c = 0; c < QG::kGroups; ++c) {
      QG qg;
      qg.load(q, c, lane & 3);
#pragma unroll
      for (int u = 0; u < QG::kSteps; ++u) {
        qf[QG::kSteps * c + u][0] = row < p.gl ? qg.lo(u) : 0u;
        qf[QG::kSteps * c + u][1] = row < p.gl ? qg.hi(u) : 0u;
      }
    }
  }
  const float scale2 = scale * 1.4426950408889634f;   // exp2 units
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DH / 16][4];
#pragma unroll
  for (int mi = 0; mi < DH / 16; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mi][e] = 0.f;

  const int n_pt = (p.n_pref + TT::kKeys - 1) / TT::kKeys;
  const int n_side = p.ns + (p.fresh ? 1 : 0);
  const int n_all = n_pt + (n_side + TS::kKeys - 1) / TS::kKeys;
  auto stage = [&](int tile) {
    char* dst = ring + (tile % kStages) * TT::kStageBytes;
    if (tile < n_pt)
      stage_tile<__nv_bfloat16, T8, DH, false, Tile8<DH>>(a, p, dst, tile,
                                                           p.n_pref);
    else
      stage_side<DH>(a, p, dst, tile - n_pt, n_side);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_all) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_all; ++t) {
    const int tn = t + kStages - 1;
    if (tn < n_all) stage(tn);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed (this thread's part)
    __syncthreads();               // ... and every thread's
    const char* st = ring + (t % kStages) * TT::kStageBytes;
    if (t < n_pt) {
#pragma unroll 1
      for (int j = 0; j < kSub; ++j) {
        const int key0 = t * TT::kKeys + 16 * j;
        if ((t * kSub + j) % kStates<G> != turn || key0 >= p.n_pref) continue;
        fp8_subtile<T8, DH>(st + 16 * j * TT::kStride,
                            st + (TT::kKeys + 16 * j) * TT::kStride,
                            TT::kStride, p.n_pref - key0, qf, scale2, m, l,
                            acc);
      }
    } else if ((t - n_pt) % kStates<G> == turn) {
      fp8_subtile<__nv_bfloat16, DH>(
          st, st + TS::kKeys * TS::kStride, TS::kStride,
          n_side - (t - n_pt) * TS::kKeys, qf, scale2, m, l, acc);
    }
    __syncthreads();               // the stage is free for tile t + kStages
  }
  cp_async_wait<0>();

  // l over the eight lane rows; then queries 2 (lane % 4) + h (+ 8 in a
  // pair's upper warp) into the warp's (pair's) state, dims in order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 4);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 8);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 16);
  }
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = half * 8 + 2 * (lane & 3) + h;
    if (gi >= G) continue;
    float* slot = scratch + (turn * G + gi) * (2 + DH);
    if (g == 0) {
      slot[0] = m[h] * 0.6931471805599453f;  // ln 2: back to natural units
      slot[1] = l[h];
    }
#pragma unroll
    for (int q = 0; q < DH / 32; ++q) {
      float* o = slot + 2 + vdim<DH>(g, q);
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[2 * q][h], acc[2 * q][2 + h]);
      *reinterpret_cast<float2*>(o + 2) =
          make_float2(acc[2 * q + 1][h], acc[2 * q + 1][2 + h]);
    }
  }
}

// Four fp32 values rounded to bf16 and stored at dst (8-byte aligned).
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a,
                                             float b, float c, float d) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(a, b),
                                              pack_bf16(c, d));
}

// The end of a tensor-core block of bf16 q (paged attention's, and
// flash-decode's 16-row instance): its kStates states of each live query
// row (scratch[state][G][2 + DH], m in natural units) merge with weights
// computed once a row, four elements a thread step; with one run it
// writes out (and with kStats m and l to m_out, l_out), else the run's
// fp32 partial (common.cuh SplitPartials, by query row), and the last run
// of its (slot, KV head, sub-group) to arrive merges the runs with
// SplitMerge's weights. That merge reads the partials four values a load
// and keeps at most 16 loads of a thread in flight whatever G is: it is
// the tail of every launch, which loads of one value each lengthen
// fourfold at 16 rows.
template <int DH, int G, bool kStats>
__device__ __forceinline__ void finish_mma(const FdArgs& a, const Plan& p,
                                           float* scratch, float* m_out,
                                           float* l_out) {
  constexpr int kT = kThreads;
  constexpr int kS = kStates<G>;
  constexpr int kStride = 2 + DH;
  constexpr int kQ = (G * DH / 4 + kT - 1) / kT;  // 4-element steps a thread
  constexpr int kRuns = kQ >= 16 ? 1 : 16 / kQ;   // runs a merge step loads
  const int n_split = gridDim.y;
  const long long row0 = p.row0;
  const int n_q = p.gl * DH / 4;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + row0 * DH;
  const SplitPartials part(a.ws, static_cast<long long>(a.b) * a.hkv * a.g,
                           n_split, DH);
  __shared__ float wts[G][kS];  // each state's weight in its row
  __shared__ float row_m[G], row_l[G];
  if (threadIdx.x < p.gl) {
    const int gi = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kS; ++wi)
      mx = fmaxf(mx, scratch[(wi * G + gi) * kStride]);
    float den = 0.f;
#pragma unroll
    for (int wi = 0; wi < kS; ++wi) {
      const float* slot = scratch + (wi * G + gi) * kStride;
      const float wgt = expf(slot[0] - mx);
      wts[gi][wi] = wgt;
      den += slot[1] * wgt;
    }
    row_m[gi] = mx;
    row_l[gi] = den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_q; i += kT) {
    const int gi = 4 * i / DH;
    const int d = 4 * i - gi * DH;
    float num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int wi = 0; wi < kS; ++wi) {
      const float* src = scratch + (wi * G + gi) * kStride + 2 + d;
      const float2 lo = *reinterpret_cast<const float2*>(src);
      const float2 hi = *reinterpret_cast<const float2*>(src + 2);
      const float wgt = wts[gi][wi];
      num[0] += lo.x * wgt;
      num[1] += lo.y * wgt;
      num[2] += hi.x * wgt;
      num[3] += hi.y * wgt;
    }
    if (n_split == 1) {
      const float den = fmaxf(row_l[gi], 1e-30f);
      store_bf16x4(out + gi * DH + d, num[0] / den, num[1] / den,
                   num[2] / den, num[3] / den);
    } else {
      *reinterpret_cast<float4*>(
          part.acc + ((row0 + gi) * n_split + p.split) * DH + d) =
          make_float4(num[0], num[1], num[2], num[3]);
    }
  }
  if (threadIdx.x < p.gl) {
    const long long r = row0 + threadIdx.x;
    const float mx = row_m[threadIdx.x], den = row_l[threadIdx.x];
    if (n_split == 1) {
      if constexpr (kStats) {
        m_out[r] = den > 0.f ? mx : kNegInf;
        l_out[r] = den;
      }
    } else {
      part.m[r * n_split + p.split] = mx;
      part.l[r * n_split + p.split] = den;
    }
  }
  if (n_split == 1) return;

  // the last run of this (slot, KV head, sub-group) to arrive merges them
  __shared__ int last;
  __threadfence();  // this block's partial is visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(a.counters + blockIdx.x, 1);
    last = arrived == n_split - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // SplitMerge's weights once a row: (m, l) of every run in one round trip
  // (through L2: other blocks wrote them), into the free scratch
  float* w = scratch;                 // [gl][n_split]: m_s in, weight out
  float* ls = scratch + G * n_split;  // [gl][n_split]
  for (int i = threadIdx.x; i < p.gl * n_split; i += kT) {
    const long long at = row0 * n_split + i;
    w[i] = __ldcg(part.m + at);
    ls[i] = __ldcg(part.l + at);
  }
  __syncthreads();
  if (threadIdx.x < p.gl) {
    float* wr = w + threadIdx.x * n_split;
    const SplitMerge mg(wr, ls + threadIdx.x * n_split, n_split);
    for (int s = 0; s < n_split; ++s) wr[s] = mg.weight(wr[s]);
    if constexpr (kStats) {
      const long long r = row0 + threadIdx.x;
      m_out[r] = mg.l > 0.f ? mg.m : kNegInf;
      l_out[r] = mg.l;
    }
  }
  __syncthreads();
  // out = sum_s weight_s acc_s: a thread's kQ steps of four elements, kRuns
  // runs of them loaded at once
  float o[kQ][4];
#pragma unroll
  for (int j = 0; j < kQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float* acc = part.acc + row0 * n_split * DH;
  for (int s0 = 0; s0 < n_split; s0 += kRuns) {
    float4 v[kRuns][kQ];
#pragma unroll
    for (int u = 0; u < kRuns; ++u)
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int i = threadIdx.x + j * kT;
        const int gi = 4 * i / DH;
        v[u][j] = s0 + u < n_split && i < n_q
                      ? __ldcg(reinterpret_cast<const float4*>(
                            acc + (gi * n_split + s0 + u) * DH + 4 * i -
                            gi * DH))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < kRuns; ++u)
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int i = threadIdx.x + j * kT;
        const int gi = 4 * i / DH;
        const float wt =
            s0 + u < n_split && i < n_q ? w[gi * n_split + s0 + u] : 0.f;
        o[j][0] += v[u][j].x * wt;
        o[j][1] += v[u][j].y * wt;
        o[j][2] += v[u][j].z * wt;
        o[j][3] += v[u][j].w * wt;
      }
  }
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int i = threadIdx.x + j * kT;
    if (i < n_q)
      store_bf16x4(out + 4 * i, o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;  // ready for next call
}

// --------------------------------------------------------------- kernel

// bf16 q over bf16, e4m3 or e5m2 pools takes the tensor cores; every
// other pair the CUDA cores.
template <typename TQ, typename TKV>
constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value &&
                      (std::is_same<TKV, __nv_bfloat16>::value ||
                       kIsFp8<TKV>);

template <typename TQ, typename TKV, int DH, int G>
struct Smem {
  // the ring (the tensor cores' e4m3 ring, of Tile8, also takes the side
  // tiles); the e4m3 instances hold Q^T in registers, the bf16 ones stage
  // the Q tile behind the ring
  static constexpr int kRing =
      kStages * (kMma<TQ, TKV> && kIsFp8<TKV> ? Tile8<DH>::kStageBytes
                                               : Tile<TKV, DH>::kStageBytes);
  static constexpr int kMerge =
      kStates<G> * G * (2 + DH) * static_cast<int>(sizeof(float));
  static constexpr int kQ = 16 * Tile<TQ, DH>::kStride;
  static constexpr bool kQTile = kMma<TQ, TKV> && !kIsFp8<TKV>;
  static constexpr int kQAt = kRing > kMerge ? kRing : kMerge;
  static constexpr int kBytes = kQAt + (kQTile ? kQ : 0);
};

// The tensor-core path at Dh <= 128 fits four blocks on an SM (at most 56
// KB of shared memory, 55,296 bytes of ring for e4m3 pools and 56,576 with
// the Q tile for bf16 ones, and at most 128 registers a thread each): a B 8
// grid of 512 blocks is resident at once.
template <typename TQ, typename TKV, int DH, int G, bool FW>
__global__ void __launch_bounds__(kThreads,
                                  (kMma<TQ, TKV> && DH <= 128) ? 4 : 1)
    flash_decode_kernel(FdArgs a, float scale) {
  extern __shared__ __align__(16) char smem[];
  using S = Smem<TQ, TKV, DH, G>;
  char* ring = smem;
  // the warps' states alias the ring, which is free after the last tile
  float* scratch = reinterpret_cast<float*>(smem);
  __shared__ int run_pages[kRunPages];
  const Plan p = make_plan<FW, G>(a, run_pages);
  const long long row0 = p.row0;

  if constexpr (FW) {
    // the fresh row joins the side window at column side_idx: only this
    // run's block of the first sub-group writes it, and no block reads
    // that column
    if (p.fresh && p.sub == 0) {
      constexpr int kC = DH * static_cast<int>(sizeof(TQ)) / 16;
      const long long src = (static_cast<long long>(p.b) * a.hkv + p.kh) * DH;
      const long long dst =
          ((static_cast<long long>(p.b) * a.w + p.sidx) * a.hkv + p.kh) * DH;
      for (int c = threadIdx.x; c < kC; c += kThreads) {
        reinterpret_cast<uint4*>(static_cast<TQ*>(a.side_k) + dst)[c] =
            __ldg(reinterpret_cast<const uint4*>(
                      static_cast<const TQ*>(a.fresh_k) + src) + c);
        reinterpret_cast<uint4*>(static_cast<TQ*>(a.side_v) + dst)[c] =
            __ldg(reinterpret_cast<const uint4*>(
                      static_cast<const TQ*>(a.fresh_v) + src) + c);
      }
    }
  }
  __syncthreads();  // the run's page ids

  if constexpr (kMma<TQ, TKV>) {
    if constexpr (kIsFp8<TKV>)
      fp8_block<TKV, DH, G>(a, p, ring, scratch, scale);
    else
      mma_block<DH, G>(a, p, ring, smem + S::kQAt, scratch, scale);
  } else {
    simt_block<TQ, TKV, DH, G, FW>(a, p, ring, scratch, scale);
  }
  __syncthreads();
  if constexpr (kPairs<G>) {
    // the 16-row instance ends as paged attention's blocks do
    finish_mma<DH, G, false>(a, p, scratch, nullptr, nullptr);
    return;
  }

  // merge the warps' (pairs') states: one (m, l, acc) per live query head
  // of this run; the partials are kept by query row ([B * H] rows)
  const int n_split = gridDim.y;
  TQ* out = static_cast<TQ*>(a.out);
  const SplitPartials part(a.ws, static_cast<long long>(a.b) * a.hkv * a.g,
                           n_split, DH);
  for (int idx = threadIdx.x; idx < p.gl * DH; idx += kThreads) {
    const int gi = idx / DH;
    const int d = idx - gi * DH;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kStates<G>; ++wi)
      mx = fmaxf(mx, scratch[(wi * G + gi) * (2 + DH)]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int wi = 0; wi < kStates<G>; ++wi) {
      const float* slot = scratch + (wi * G + gi) * (2 + DH);
      const float wgt = expf(slot[0] - mx);
      den += slot[1] * wgt;
      num += slot[2 + d] * wgt;
    }
    const long long r = row0 + gi;
    if (n_split == 1) {
      out[r * DH + d] = from_f<TQ>(num / fmaxf(den, 1e-30f));
    } else {
      part.acc[(r * n_split + p.split) * DH + d] = num;
      if (d == 0) {
        part.m[r * n_split + p.split] = mx;
        part.l[r * n_split + p.split] = den;
      }
    }
  }
  if (n_split == 1) return;

  // the last run of this (slot, KV head) to arrive merges them all
  __shared__ int last;
  __threadfence();  // this block's partial is visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(a.counters + blockIdx.x, 1);
    last = arrived == n_split - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // SplitMerge's weights, once per query head rather than once per
  // element: (m, l) of every run in one round trip (through L2: other
  // blocks wrote them), then each element's n_split partials in one more
  float* w = scratch;                    // [G][n_split]; the ring is free
  float* ls = scratch + G * n_split;     // [G][n_split]
  for (int i = threadIdx.x; i < p.gl * n_split; i += kThreads) {
    const long long at = (row0 + i / n_split) * n_split + i % n_split;
    w[i] = __ldcg(part.m + at);
    ls[i] = __ldcg(part.l + at);
  }
  __syncthreads();
  if (threadIdx.x < p.gl) {
    float* wr = w + threadIdx.x * n_split;  // m_s in, weight out
    const SplitMerge mg(wr, ls + threadIdx.x * n_split, n_split);
    for (int s = 0; s < n_split; ++s) wr[s] = mg.weight(wr[s]);
  }
  __syncthreads();
  constexpr int kPer = (G * DH + kThreads - 1) / kThreads;
  float o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  const float* acc = part.acc + row0 * n_split * DH;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int gi = idx / DH;
      if (idx < p.gl * DH)
        o[i] += __ldcg(acc + (gi * n_split + s) * DH + (idx - gi * DH)) *
                w[gi * n_split + s];
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < p.gl * DH) out[row0 * DH + idx] = from_f<TQ>(o[i]);
  }
  if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;  // ready for next call
}

template <typename TQ, typename TKV, int DH, int G, bool FW>
cudaError_t launch(const FdArgs& a, int n_split, cudaStream_t stream) {
  using S = Smem<TQ, TKV, DH, G>;
  constexpr int kSmem = S::kBytes;
  // the merge keeps the runs' (m, l) of G query heads in the ring
  if (static_cast<long long>(n_split) * G * 2 * sizeof(float) > S::kQAt)
    return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  auto kernel = flash_decode_kernel<TQ, TKV, DH, G, FW>;
  // the shared-memory ceiling, once per instance and device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  kernel<<<dim3(a.b * a.hkv * a.n_sub, n_split), kThreads, kSmem, stream>>>(
      a, scale);
  return cudaGetLastError();
}

// The tensor cores' 16-row instance (the warp pairs of mma_tile and
// fp8_block) is built at Dh 128 alone, the head width of every query-head
// group above 8 that is run (PERF.md's G 12 and 16 at Hkv 4); elsewhere
// such a group takes sub-groups of 8.
template <typename TQ, typename TKV, int DH>
constexpr bool kRows16 = kMma<TQ, TKV> && DH == 128;

template <typename TQ, typename TKV, int DH, bool FW>
cudaError_t by_group(int g, const FdArgs& args, int ns, cudaStream_t st) {
  if (g < 1) return cudaErrorInvalidValue;
  FdArgs a = args;
  const int gs = subgroup_rows(g, kRows16<TQ, TKV, DH>);
  a.g = g;
  a.n_sub = (g + gs - 1) / gs;
  switch (gs) {
    case 1: return launch<TQ, TKV, DH, 1, FW>(a, ns, st);
    case 2: return launch<TQ, TKV, DH, 2, FW>(a, ns, st);
    case 4: return launch<TQ, TKV, DH, 4, FW>(a, ns, st);
    case 8: return launch<TQ, TKV, DH, 8, FW>(a, ns, st);
    default:
      if constexpr (kRows16<TQ, TKV, DH>)
        return launch<TQ, TKV, DH, 16, FW>(a, ns, st);
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV, bool FW>
cudaError_t by_width(int dh, int g, const FdArgs& a, int ns,
                     cudaStream_t st) {
  switch (dh) {
    case 32: return by_group<TQ, TKV, 32, FW>(g, a, ns, st);
    case 64: return by_group<TQ, TKV, 64, FW>(g, a, ns, st);
    case 128: return by_group<TQ, TKV, 128, FW>(g, a, ns, st);
    case 256: return by_group<TQ, TKV, 256, FW>(g, a, ns, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16- and fp32-pool instances (bf16 over bf16 on the tensor cores,
// every other pair on the CUDA cores), one variant a file: flash_decode.cu
// compiles the plain one, flash_decode_fw.cu the writeback one, so that
// the build runs them side by side.
template <bool FW>
cudaError_t dispatch_wide(const FdArgs& a, int dh, int g, int n_split,
                          int q_dtype, int kv_dtype, cudaStream_t st) {
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return by_width<__nv_bfloat16, __nv_bfloat16, FW>(dh, g, a, n_split, st);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return by_width<float, float, FW>(dh, g, a, n_split, st);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return by_width<__nv_bfloat16, float, FW>(dh, g, a, n_split, st);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return by_width<float, __nv_bfloat16, FW>(dh, g, a, n_split, st);
  return cudaErrorInvalidValue;
}

// The e4m3- and e5m2-pool instances (bf16 q on the tensor cores, fp32 q on
// the CUDA cores), compiled apart in flash_decode_fp8.cu and
// flash_decode_e5m2.cu so that the build runs them beside the other
// instances.
template <bool FW>
cudaError_t dispatch_fp8(const FdArgs& a, int dh, int g, int n_split,
                         int q_dtype, cudaStream_t st);
template <bool FW>
cudaError_t dispatch_e5m2(const FdArgs& a, int dh, int g, int n_split,
                          int q_dtype, cudaStream_t st);

}  // namespace fd
}  // namespace die
