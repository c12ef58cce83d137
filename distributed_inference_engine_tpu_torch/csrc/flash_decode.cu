// Flash-decode attention over a paged prefix plus the chunk's side window.
//
// Replaces the TPU kernel ops/flash_decode.py:_flash_decode_kernel of the
// JAX package (wrapper flash_decode_attention_pallas). Per slot b it
// computes softmax(q . [prefix pages ++ side window] / sqrt(Dh)) . V in one
// pass with an fp32 online softmax, GQA included: the prefix keys are
// tokens t < prefix_lens[b] of the slot's pages, page p of layer l living
// at row layer_base + page_table[b, p] of the stacked [L*N, P, Hkv*Dh]
// pool; the side keys are entries j < n_side[b] of side_k[b].
//
// The writeback variant (die_flash_decode_fw) replaces the TPU kernel
// ops/flash_decode.py:_flash_decode_fw_kernel (wrapper
// flash_decode_attention_fw_pallas). It takes this step's fresh K/V as its
// own operand instead of a side window already holding it: the block reads
// side entries j < min(side_idx[b], W), attends the fresh row as one extra
// key, and writes it into side[b, side_idx[b]], for active slots with
// side_idx < W. That is exactly the one-hot side write plus flash-decode
// that the plain version composes; an active slot at side_idx >= W (a
// state the engine never reaches: W is the chunk length) keeps its W
// entries and drops the fresh row, as the plain version does. Only the
// block of (slot, KV head) touches that head's slice of the side row, and
// it never reads the entry it writes, so the write races nothing.
//
// Bound on the card: the K and V bytes read (one Hkv*Dh row per valid key
// and head group, each read once) over 3.35 TB/s. The arithmetic is ~1
// FLOP per byte, far below the bf16 ridge. The fw variant adds one row
// read and one row written per active slot.
//
// Design. One block per (slot, KV head): every K/V row is read once for
// the g = H/Hkv query heads that share it, held in registers. Inside the
// block each warp walks a strided subset of the keys, loading up to 8 rows
// before using any; lane i holds Dh/32 contiguous elements of q, k, v and
// acc, so one key costs one coalesced row load plus g warp reductions.
// Each warp keeps its own (m, l, acc) and the block merges them through
// shared memory at the end, as flash-decoding merges KV splits. What the
// TPU kernel needed and this one does not: the 0/1 segment matmuls and
// lane-slice GQA concats (Mosaic's rank-2 rule), the cross-grid-step DMA
// prefetch state (blocks here run in parallel and the warp scheduler hides
// load latency), the pages-per-block table, and the fw variant's side-row
// staging copy. A row with no valid key writes 0, as the TPU kernel does.
//
// Known limit: B * Hkv blocks (64 at B=8, Hkv=8) under-fill 132 SMs, and
// the block of a slot's longest row streams all its keys through one SM
// (about 1 MB for 2040 keys at Dh=128 in bf16). Loading several rows
// before use helped on the card; batching the softmax update per group of
// keys did not help further. A split over the KV length is the next step.
#include "common.cuh"

namespace die {
namespace {

constexpr float kNegInf = -1e30f;  // finite, as in ops/attention.py

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
  int b, hkv, page_size, mp, w;
  long long layer_base;
};

// One online-softmax step of the g query heads of a warp over one key row.
template <int E, int G>
__device__ __forceinline__ void online_update(const float (&qr)[G][E],
                                              const float (&kr)[E],
                                              const float (&vr)[E],
                                              float scale, float (&m)[G],
                                              float (&l)[G],
                                              float (&acc)[G][E]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += qr[gi][e] * kr[e];
    s = warp_sum(s) * scale;
    const float mn = fmaxf(m[gi], s);
    const float alpha = expf(m[gi] - mn);
    const float p = expf(s - mn);
    l[gi] = l[gi] * alpha + p;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = acc[gi][e] * alpha + p * vr[e];
    m[gi] = mn;
  }
}

template <typename TQ, typename TKV, int E, int G, bool FW>
__global__ void __launch_bounds__(512) flash_decode_kernel(FdArgs a,
                                                           float scale) {
  constexpr int kDh = 32 * E;
  extern __shared__ float smem[];
  const int hkv = a.hkv, page_size = a.page_size, w = a.w;
  const int b = blockIdx.x / hkv;
  const int kh = blockIdx.x - b * hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int h = hkv * G;
  const long long fused = static_cast<long long>(hkv) * kDh;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k_pages = static_cast<const TKV*>(a.k_pages);
  const TKV* v_pages = static_cast<const TKV*>(a.v_pages);
  const TQ* side_k = static_cast<const TQ*>(a.side_k);
  const TQ* side_v = static_cast<const TQ*>(a.side_v);

  float qr[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_row<TQ, E>(q + (static_cast<long long>(b) * h + kh * G + gi) * kDh +
                        lane * E,
                    qr[gi]);
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  // prefix: the slot's pages through the page table (read-only; rows of
  // inactive slots point at page 0 and are masked by prefix_lens)
  const int plen = a.prefix_lens[b];
  const int* row = a.page_table + static_cast<long long>(b) * a.mp;
  const long long head_off = static_cast<long long>(kh) * kDh + lane * E;
  // keys go in groups of kU rows per warp, the group's K/V loads all
  // issued before any is used: a block streams at bytes in flight over
  // latency
  using KRow = RawRow<TKV, E>;
  // group size: the group's raw K+V words within ~32 registers
  constexpr int kByRegs = 32 / (2 * KRow::kWords);
  constexpr int kU = kByRegs < 1 ? 1 : (kByRegs > 8 ? 8 : kByRegs);
  for (int t0 = warp; t0 < plen; t0 += kU * nw) {
    KRow kraw[kU], vraw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u * nw;
      if (t < plen) {
        const int pg = row[t / page_size];
        const long long base =
            ((a.layer_base + pg) * page_size + t % page_size) * fused +
            head_off;
        kraw[u].load(k_pages + base);
        vraw[u].load(v_pages + base);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t0 + u * nw < plen) {
        float kr[E], vr[E];
        kraw[u].widen(kr);
        vraw[u].widen(vr);
        online_update<E, G>(qr, kr, vr, scale, m, l, acc);
      }
    }
  }
  // side window: this chunk's fresh keys. Plain variant: n_side[b] of them
  // valid (the count already includes this step's entry). fw: the entries
  // before this step's column, then the fresh row itself
  int ns;
  bool fresh = false;
  int sidx = 0;
  if constexpr (FW) {
    sidx = a.side_idx[b];
    ns = min(max(sidx, 0), w);
    fresh = a.active[b] != 0 && sidx >= 0 && sidx < w;
  } else {
    ns = min(a.n_side[b], w);
  }
  for (int t = warp; t < ns; t += nw) {
    const long long base =
        ((static_cast<long long>(b) * w + t) * hkv + kh) * kDh + lane * E;
    float kr[E], vr[E];
    // fw writes the side buffers: plain (coherent) loads there
    load_row<TQ, E, !FW>(side_k + base, kr);
    load_row<TQ, E, !FW>(side_v + base, vr);
    online_update<E, G>(qr, kr, vr, scale, m, l, acc);
  }
  if constexpr (FW) {
    if (fresh && warp == ns % nw) {
      const long long src =
          (static_cast<long long>(b) * hkv + kh) * kDh + lane * E;
      const long long dst =
          ((static_cast<long long>(b) * w + sidx) * hkv + kh) * kDh +
          lane * E;
      const TQ* fk = static_cast<const TQ*>(a.fresh_k) + src;
      const TQ* fv = static_cast<const TQ*>(a.fresh_v) + src;
      float kr[E], vr[E];
      load_row<TQ, E>(fk, kr);
      load_row<TQ, E>(fv, vr);
      online_update<E, G>(qr, kr, vr, scale, m, l, acc);
      TQ* sk = static_cast<TQ*>(a.side_k) + dst;
      TQ* sv = static_cast<TQ*>(a.side_v) + dst;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sk[e] = fk[e];
        sv[e] = fv[e];
      }
    }
  }

  // merge the warps' partial (m, l, acc): smem = [nw][G][2 + Dh]
  constexpr int kStride = 2 + kDh;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float* slot = smem + (warp * G + gi) * kStride;
    if (lane == 0) {
      slot[0] = m[gi];
      slot[1] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) slot[2 + lane * E + e] = acc[gi][e];
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out);
  for (int idx = threadIdx.x; idx < G * kDh; idx += blockDim.x) {
    const int gi = idx / kDh;
    const int d = idx - gi * kDh;
    float mx = kNegInf;
    for (int wi = 0; wi < nw; ++wi)
      mx = fmaxf(mx, smem[(wi * G + gi) * kStride]);
    float den = 0.f, num = 0.f;
    for (int wi = 0; wi < nw; ++wi) {
      const float* slot = smem + (wi * G + gi) * kStride;
      const float wgt = expf(slot[0] - mx);
      den += slot[1] * wgt;
      num += slot[2 + d] * wgt;
    }
    out[(static_cast<long long>(b) * h + kh * G + gi) * kDh + d] =
        from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, int E, int G, bool FW>
cudaError_t launch(const FdArgs& a, cudaStream_t stream) {
  constexpr int kDh = 32 * E;
  const int per_warp = G * (2 + kDh) * static_cast<int>(sizeof(float));
  int nw = 40960 / per_warp;
  nw = nw < 1 ? 1 : (nw > 16 ? 16 : nw);
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  flash_decode_kernel<TQ, TKV, E, G, FW>
      <<<a.b * a.hkv, nw * 32, nw * per_warp, stream>>>(a, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int E, bool FW>
cudaError_t by_group(int g, const FdArgs& a, cudaStream_t st) {
  switch (g) {
    case 1: return launch<TQ, TKV, E, 1, FW>(a, st);
    case 2: return launch<TQ, TKV, E, 2, FW>(a, st);
    case 4: return launch<TQ, TKV, E, 4, FW>(a, st);
    case 8: return launch<TQ, TKV, E, 8, FW>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV, bool FW>
cudaError_t by_width(int e, int g, const FdArgs& a, cudaStream_t st) {
  switch (e) {
    case 1: return by_group<TQ, TKV, 1, FW>(g, a, st);
    case 2: return by_group<TQ, TKV, 2, FW>(g, a, st);
    case 4: return by_group<TQ, TKV, 4, FW>(g, a, st);
    case 8: return by_group<TQ, TKV, 8, FW>(g, a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FW>
int dispatch(const FdArgs& a, int h, int dh, int q_dtype, int kv_dtype,
             void* stream) {
  if (a.b <= 0) return 0;
  if (a.hkv <= 0 || h % a.hkv || dh % 32) return cudaErrorInvalidValue;
  const int e = dh / 32, g = h / a.hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    err = by_width<__nv_bfloat16, __nv_bfloat16, FW>(e, g, a, st);
  else if (q_dtype == kF32 && kv_dtype == kF32)
    err = by_width<float, float, FW>(e, g, a, st);
  else if (q_dtype == kBF16 && kv_dtype == kF32)
    err = by_width<__nv_bfloat16, float, FW>(e, g, a, st);
  else if (q_dtype == kF32 && kv_dtype == kBF16)
    err = by_width<float, __nv_bfloat16, FW>(e, g, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace die

// q [B, H, Dh] and side_k/side_v [B, W, Hkv, Dh] in q_dtype; the stacked
// pools [L*N, P, Hkv*Dh] in kv_dtype; out [B, H, Dh] in q_dtype. Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int die_flash_decode(const void* q, const void* k_pages,
                                const void* v_pages, const int* page_table,
                                const int* prefix_lens, const void* side_k,
                                const void* side_v, const int* n_side,
                                void* out, int b, int h, int hkv, int dh,
                                int page_size, int mp, int w,
                                long long layer_base, int q_dtype,
                                int kv_dtype, void* stream) {
  die::FdArgs a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = page_table;
  a.prefix_lens = prefix_lens;
  a.side_k = const_cast<void*>(side_k);
  a.side_v = const_cast<void*>(side_v);
  a.n_side = n_side;
  a.out = out;
  a.b = b;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  a.w = w;
  a.layer_base = layer_base;
  return die::dispatch<false>(a, h, dh, q_dtype, kv_dtype, stream);
}

// The writeback variant: as die_flash_decode, with fresh_k/fresh_v
// [B, 1, Hkv, Dh] in q_dtype attended as one extra key and written into
// side_k/side_v[b, side_idx[b]] (in place) for slots with active[b] != 0
// and side_idx[b] < W.
extern "C" int die_flash_decode_fw(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const int* page_table,
                                   const int* prefix_lens, void* side_k,
                                   void* side_v, const void* fresh_k,
                                   const void* fresh_v, const int* side_idx,
                                   const int* active, void* out, int b, int h,
                                   int hkv, int dh, int page_size, int mp,
                                   int w, long long layer_base, int q_dtype,
                                   int kv_dtype, void* stream) {
  die::FdArgs a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = page_table;
  a.prefix_lens = prefix_lens;
  a.side_k = side_k;
  a.side_v = side_v;
  a.fresh_k = fresh_k;
  a.fresh_v = fresh_v;
  a.side_idx = side_idx;
  a.active = active;
  a.out = out;
  a.b = b;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  a.w = w;
  a.layer_base = layer_base;
  return die::dispatch<true>(a, h, dh, q_dtype, kv_dtype, stream);
}
