// Paged decode attention with an optional sliding window and flash stats.
//
// Replaces the TPU kernel ops/paged_attention.py:_paged_attn_kernel of the
// JAX package (wrapper paged_attention_pallas). Per slot b and query head
// it computes softmax(q . K / sqrt(Dh)) . V over the keys t of the slot's
// pages with t < lengths[b] (the count includes this step's token) and,
// with window > 0, t >= lengths[b] - window; page p of the slot lives at
// row layer_base + page_table[b, p] of the (stacked) [rows, P, Hkv*Dh]
// pool. Besides the output (rounded once, to q's dtype) it writes the
// flash stats: m, the row max of the scaled scores, and l, the raw
// softmax denominator relative to m. A row with no valid key writes
// out = 0, m = -1e30, l = 0, as the TPU kernel does; merge_attention
// gives such a row weight 0.
//
// Bound on the card: the K and V bytes of the live window (one Hkv*Dh row
// per valid key, each read once) over 3.35 TB/s. The arithmetic is ~1 FLOP
// per byte, far below the bf16 ridge. The window is where the saving comes
// from: a block reads the keys [max(0, len - window), len) and nothing
// before them, so at a 4096-token window a 6,000-token slot reads
// two thirds of its pages.
//
// Design. One block per (slot, KV head): every K/V row is read once for
// the G = H/Hkv query heads that share it, held in registers. A key row of
// this head is Dh elements; LPK lanes read it with one 16-byte load each,
// so a warp reads KPW = 32 / LPK rows at once (two at Dh = 128 in bf16).
// Each lane group keeps its own (m, l, acc) over a strided subset of the
// keys, issuing the loads of kU rows before using any; the groups of a
// warp merge through shuffles and the warps through shared memory at the
// end, as flash-decoding merges KV splits. What the TPU kernel needed and
// this one does not: the sequential (slot, page) grid with scratch
// accumulators (a block loops over its own keys), the 0/1 segment-sum
// matmuls and the lane-slice GQA concats (Mosaic's rank-2 rule). The TPU
// kernel skips whole pages outside the window and masks inside them; this
// one walks the valid keys only, which reads the same bytes.
//
// Known limit: B * Hkv blocks (64 at B = 8, Hkv = 8) under-fill 132 SMs,
// and the block of a slot's longest row streams its whole window through
// one SM (2 MB for 4096 keys at Dh = 128 in bf16). Splitting a long window
// over several blocks (and tensor cores, TMA) is the next step.
#include "common.cuh"

namespace die {
namespace {

constexpr float kNegInf = -1e30f;  // finite, as in ops/attention.py
constexpr int kWarps = 8;

struct PaArgs {
  const void* q;           // [B, H, Dh] q dtype
  const void* k_pages;     // [rows, P, Hkv*Dh] kv dtype
  const void* v_pages;
  const int* page_table;   // [B, MP]
  const int* lengths;      // [B] valid keys, this step's included
  void* out;               // [B, H, Dh] q dtype
  float* m_out;            // [B, H]
  float* l_out;            // [B, H]
  int hkv, page_size, mp, window;
  long long layer_base;
};

// Merge another partial softmax state (mo, lo, acco) into (m, l, acc).
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l,
                                            float (&acc)[N], float mo,
                                            float lo, const float (&acco)[N]) {
  const float mx = fmaxf(m, mo);
  const float a = expf(m - mx);
  const float c = expf(mo - mx);
  l = l * a + lo * c;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acco[e] * c;
  m = mx;
}

template <typename TQ, typename TKV, int DH, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(PaArgs a, float scale) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));  // per load
  constexpr int kLpk = DH / kVec;        // lanes per key row
  static_assert(kLpk >= 1 && kLpk <= 32 && 32 % kLpk == 0,
                "a key row is 1 to 32 sixteen-byte loads");
  constexpr int kKpw = 32 / kLpk;        // key rows a warp reads at once
  constexpr int kSweep = kWarps * kKpw;  // key rows the block reads at once
  constexpr int kU = G >= 8 ? 4 : 8;     // rows in flight per lane group
  extern __shared__ float smem[];
  const int hkv = a.hkv;
  const int b = blockIdx.x / hkv;
  const int kh = blockIdx.x - b * hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kLpk;
  const int lk = lane - grp * kLpk;
  const int h = hkv * G;
  const long long fused = static_cast<long long>(hkv) * DH;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k_pages = static_cast<const TKV*>(a.k_pages);
  const TKV* v_pages = static_cast<const TKV*>(a.v_pages);

  float qr[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_row<TQ, kVec>(
        q + (static_cast<long long>(b) * h + kh * G + gi) * DH + lk * kVec,
        qr[gi]);
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[gi][e] = 0.f;
  }

  // the valid keys: [lo, hi), the window's first key to the last written
  const int len = a.lengths[b];
  const int hi = min(len, a.mp * a.page_size);
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int* row = a.page_table + static_cast<long long>(b) * a.mp;
  const long long head_off = static_cast<long long>(kh) * DH + lk * kVec;
  using Row = RawRow<TKV, kVec>;
  // base is uniform across the warp, so every lane runs every shuffle
  for (int base = lo + warp * kKpw; base < hi; base += kU * kSweep) {
    Row kraw[kU], vraw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + u * kSweep + grp;
      if (t < hi) {
        const int pg = row[t / a.page_size];
        const long long off =
            ((a.layer_base + pg) * a.page_size + t % a.page_size) * fused +
            head_off;
        kraw[u].load(k_pages + off);
        vraw[u].load(v_pages + off);
      } else {
#pragma unroll
        for (int i = 0; i < Row::kWords; ++i) kraw[u].w[i] = vraw[u].w[i] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool valid = base + u * kSweep + grp < hi;
      float kr[kVec], vr[kVec];
      kraw[u].widen(kr);
      vraw[u].widen(vr);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s += qr[gi][e] * kr[e];
#pragma unroll
        for (int off = kLpk / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid) {
          s *= scale;
          const float mn = fmaxf(m[gi], s);
          const float alpha = expf(m[gi] - mn);
          const float p = expf(s - mn);
          l[gi] = l[gi] * alpha + p;
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[gi][e] = acc[gi][e] * alpha + p * vr[e];
          m[gi] = mn;
        }
      }
    }
  }

  // merge the warp's lane groups (lanes lk, lk + kLpk, ... hold the same
  // elements of different key subsets)
#pragma unroll
  for (int off = kLpk; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[gi], off);
      float acco[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acco[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      merge_state<kVec>(m[gi], l[gi], acc[gi], mo, lo2, acco);
    }
  }

  // merge the warps: smem = [kWarps][G][2 + DH]
  constexpr int kStride = 2 + DH;
  if (grp == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float* slot = smem + (warp * G + gi) * kStride;
      if (lk == 0) {
        slot[0] = m[gi];
        slot[1] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) slot[2 + lk * kVec + e] = acc[gi][e];
    }
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out);
  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int gi = idx / DH;
    const int d = idx - gi * DH;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi)
      mx = fmaxf(mx, smem[(wi * G + gi) * kStride]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const float* slot = smem + (wi * G + gi) * kStride;
      const float wgt = expf(slot[0] - mx);
      den += slot[1] * wgt;
      num += slot[2 + d] * wgt;
    }
    const long long r = static_cast<long long>(b) * h + kh * G + gi;
    out[r * DH + d] = from_f<TQ>(num / fmaxf(den, 1e-30f));
    if (d == 0) {
      a.m_out[r] = mx;
      a.l_out[r] = den;
    }
  }
}

template <typename TQ, typename TKV, int DH, int G>
cudaError_t launch(const PaArgs& a, int b, cudaStream_t stream) {
  const int smem = kWarps * G * (2 + DH) * static_cast<int>(sizeof(float));
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  paged_attention_kernel<TQ, TKV, DH, G>
      <<<b * a.hkv, kWarps * 32, smem, stream>>>(a, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DH>
cudaError_t by_group(int g, const PaArgs& a, int b, cudaStream_t st) {
  switch (g) {
    case 1: return launch<TQ, TKV, DH, 1>(a, b, st);
    case 2: return launch<TQ, TKV, DH, 2>(a, b, st);
    case 4: return launch<TQ, TKV, DH, 4>(a, b, st);
    case 8: return launch<TQ, TKV, DH, 8>(a, b, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t by_width(int dh, int g, const PaArgs& a, int b, cudaStream_t st) {
  switch (dh) {
    case 32: return by_group<TQ, TKV, 32>(g, a, b, st);
    case 64: return by_group<TQ, TKV, 64>(g, a, b, st);
    case 128: return by_group<TQ, TKV, 128>(g, a, b, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace die

// q [B, H, Dh] in q_dtype; the pools [rows, P, Hkv*Dh] in kv_dtype, page p
// of slot b at row layer_base + page_table[b, p]; out [B, H, Dh] in
// q_dtype; m_out/l_out [B, H] fp32. window 0 is full attention. Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int die_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const int* page_table,
                                   const int* lengths, void* out, float* m_out,
                                   float* l_out, int b, int h, int hkv,
                                   int dh, int page_size, int mp, int window,
                                   long long layer_base, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  if (hkv <= 0 || h % hkv || page_size <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  die::PaArgs a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = page_table;
  a.lengths = lengths;
  a.out = out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  a.window = window;
  a.layer_base = layer_base;
  const int g = h / hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == die::kBF16 && kv_dtype == die::kBF16)
    err = die::by_width<__nv_bfloat16, __nv_bfloat16>(dh, g, a, b, st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kF32)
    err = die::by_width<float, float>(dh, g, a, b, st);
  else if (q_dtype == die::kBF16 && kv_dtype == die::kF32)
    err = die::by_width<__nv_bfloat16, float>(dh, g, a, b, st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kBF16)
    err = die::by_width<float, __nv_bfloat16>(dh, g, a, b, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
