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
// Design: split KV. The grid is (slot x KV head, split): the keys
// [lo, hi) of a slot are cut into n_split runs of `chunk` keys from lo,
// and each block walks one run, so a long slot is read by n_split SMs at
// once instead of one (the host sizes n_split from mp * page_size or the
// window and the SM count, without reading the lengths). Every K/V row is
// read once for the G = H/Hkv query heads that share it, held in
// registers. A key row of this head is Dh elements; LPK lanes read it
// with one 16-byte load each, so a warp reads KPW = 32 / LPK rows at once
// (two at Dh = 128 in bf16). Each lane group keeps its own (m, l, acc)
// over a strided subset of the keys: it loads kU rows, scores all of them,
// rescales its state once for the kU keys and then adds them. The groups
// of a warp merge through shuffles and the warps through shared memory.
// With one split the block writes the result; with more it writes its
// fp32 partial (m, l, unnormalised acc; common.cuh SplitPartials) and a
// second kernel merges the splits of each row (SplitMerge). A block
// whose run lies wholly outside [lo, hi) writes the empty state and
// exits. What the TPU kernel needed and this one does not: the
// sequential (slot, page) grid with scratch accumulators, the 0/1
// segment-sum matmuls and the lane-slice GQA concats (Mosaic's rank-2
// rule). The TPU kernel skips whole pages outside the window and masks
// inside them; this one walks the valid keys only, which reads the same
// bytes.
//
// e4m3 pools (the fp8 instances; the TPU kernel upcasts each page,
// ops/paged_attention.py:168-169): a lane loads 8 values (8 bytes) of a
// row, so a row spreads over as many lanes as a bf16 one and a lane holds
// as many fp32 values; the raw bytes widen exactly in registers. Half the
// bytes of bf16, so half the bound; the sliding window applies unchanged,
// which is what Mistral's inline decode on fp8 pools runs.
//
// Any query-head group G = H / Hkv, and head_dim 32 to 256 (the TPU
// kernel takes any Hkv*Dh that is a multiple of 128): the instances hold
// sub-groups of GS in {1, 2, 4, 8} query heads in registers, and a KV
// head's G heads are cut into n_sub = ceil(G / GS) sub-groups (GS the
// least instance >= G up to 8; 8 above it), one block each, the rows
// past G dead (computed on a copy of the last live row, never stored).
// Qwen2-7B's G = 7 takes the GS 8 instance with one dead row. At Dh 256
// (Gemma) a bf16 or e4m3 row is one load a lane over the warp's 32 lanes
// and an fp32 row two; Gemma-2B (G 8, Dh 256) holds 64 query values and
// 64 accumulators a lane, its warps' states 66 KB of shared memory.
//
// Left: the scores and the weighted sum run on CUDA cores (a decode row
// has one query per head, G per K/V row: too few for tensor cores), and
// rows are loaded straight into registers (no cp.async or TMA ring).
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
  const int* lengths;      // [B] valid keys, this step's token included
  void* out;               // [B, H, Dh] q dtype
  float* m_out;            // [B, H]
  float* l_out;            // [B, H]
  float* ws;               // split partials (n_split > 1), by query row
  int b, hkv, page_size, mp, window, chunk;
  int g, n_sub;            // query heads a KV head; sub-groups a KV head
  long long layer_base;
};

// A block is one sub-group of G (the instance's GS) query heads of a
// (slot, KV head). G >= 8 keeps 64 fp32 accumulators and 64 query values
// a lane at Dh 128 and 256, and so does G 4 over fp32 pools at Dh 256
// (two loads a row): one block per SM; the others are held to two.
template <typename TQ, typename TKV, int DH, int G>
__global__ void __launch_bounds__(
    kWarps * 32, (G >= 8 || (G >= 4 && DH / kVecOf<TKV> > 32)) ? 1 : 2)
    paged_attention_kernel(PaArgs a, float scale) {
  constexpr int kVec = kVecOf<TKV>;      // per load (16 bytes; e4m3 8)
  // lanes per key row: one load each, or two (fp32 at Dh 256)
  constexpr int kLpk = DH / kVec > 32 ? 32 : DH / kVec;
  constexpr int kEl = DH / kLpk;         // elements a lane
  static_assert(kLpk >= 1 && 32 % kLpk == 0 && kEl % kVec == 0,
                "a key row is whole loads over 1 to 32 lanes");
  constexpr int kKpw = 32 / kLpk;        // key rows a warp reads at once
  constexpr int kSweep = kWarps * kKpw;  // key rows the block reads at once
  constexpr int kU = G >= 8 ? 2 : 4;     // rows in flight per lane group
  extern __shared__ float smem[];
  const int hkv = a.hkv;
  const int per_slot = hkv * a.n_sub;
  const int b = blockIdx.x / per_slot;
  const int kh = (blockIdx.x - b * per_slot) / a.n_sub;
  const int sub = blockIdx.x - b * per_slot - kh * a.n_sub;
  const int gl = min(G, a.g - sub * G);  // live query heads of the block
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kLpk;
  const int lk = lane - grp * kLpk;
  const long long row0 =
      static_cast<long long>(b) * hkv * a.g + kh * a.g + sub * G;
  TQ* out = static_cast<TQ*>(a.out);
  const SplitPartials part(a.ws, static_cast<long long>(a.b) * hkv * a.g,
                           n_split, DH);

  // this block's keys: its run of the valid keys [lo, hi), the window's
  // first key to the last written
  const int len = a.lengths[b];
  const int hi = min(len, a.mp * a.page_size);
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int s_lo = lo + split * a.chunk;
  const int s_hi = min(hi, s_lo + a.chunk);
  if (s_lo >= s_hi) {  // uniform across the block
    for (int idx = threadIdx.x; idx < gl * DH; idx += blockDim.x) {
      const int gi = idx / DH;
      const int d = idx - gi * DH;
      const long long r = row0 + gi;
      if (n_split == 1) {
        out[r * DH + d] = from_f<TQ>(0.f);
      } else {
        part.acc[(r * n_split + split) * DH + d] = 0.f;
      }
      if (d == 0) {
        if (n_split == 1) {
          a.m_out[r] = kNegInf;
          a.l_out[r] = 0.f;
        } else {
          part.m[r * n_split + split] = kNegInf;
          part.l[r * n_split + split] = 0.f;
        }
      }
    }
    return;
  }

  const long long fused = static_cast<long long>(hkv) * DH;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k_pages = static_cast<const TKV*>(a.k_pages);
  const TKV* v_pages = static_cast<const TKV*>(a.v_pages);
  // dead rows (gi >= gl) repeat the last live one: computed, never stored
  float qr[G][kEl];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_row<TQ, kEl>(q + (row0 + min(gi, gl - 1)) * DH + lk * kEl, qr[gi]);
  float m[G], l[G], acc[G][kEl];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kEl; ++e) acc[gi][e] = 0.f;
  }

  const int* row = a.page_table + static_cast<long long>(b) * a.mp;
  const long long head_off = static_cast<long long>(kh) * DH + lk * kEl;
  using Row = RawRow<TKV, kEl>;
  // base is uniform across the warp, so every lane runs every shuffle
  for (int base = s_lo + warp * kKpw; base < s_hi; base += kU * kSweep) {
    Row kraw[kU], vraw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + u * kSweep + grp;
      if (t < s_hi) {
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
    // score the kU rows, then rescale the state once for all of them
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool valid = base + u * kSweep + grp < s_hi;
      float kr[kEl];
      kraw[u].widen(kr);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kEl; ++e) dot += qr[gi][e] * kr[e];
#pragma unroll
        for (int off = kLpk / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][gi] = valid ? dot * scale : kNegInf;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mn = m[gi];
#pragma unroll
      for (int u = 0; u < kU; ++u) mn = fmaxf(mn, s[u][gi]);
      const float alpha = expf(m[gi] - mn);
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[gi][e] *= alpha;
      m[gi] = mn;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool valid = base + u * kSweep + grp < s_hi;
      float vr[kEl];
      vraw[u].widen(vr);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = valid ? expf(s[u][gi] - m[gi]) : 0.f;
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < kEl; ++e) acc[gi][e] = fmaf(p, vr[e], acc[gi][e]);
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
      float acco[kEl];
#pragma unroll
      for (int e = 0; e < kEl; ++e)
        acco[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      merge_state<kEl>(m[gi], l[gi], acc[gi], mo, lo2, acco);
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
      for (int e = 0; e < kEl; ++e) slot[2 + lk * kEl + e] = acc[gi][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gl * DH; idx += blockDim.x) {
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
    const long long r = row0 + gi;
    if (n_split == 1) {
      out[r * DH + d] = from_f<TQ>(num / fmaxf(den, 1e-30f));
      if (d == 0) {
        a.m_out[r] = mx;
        a.l_out[r] = den;
      }
    } else {
      part.acc[(r * n_split + split) * DH + d] = num;
      if (d == 0) {
        part.m[r * n_split + split] = mx;
        part.l[r * n_split + split] = den;
      }
    }
  }
}

// One block per output row, one thread per element (up to Dh 256): the
// row's split partials merged with SplitMerge's weights and rounded once.
template <typename TQ>
__global__ void __launch_bounds__(256)
    paged_merge_kernel(float* ws, int n_split, int dh, void* out_,
                       float* m_out, float* l_out) {
  const SplitPartials part(ws, gridDim.x, n_split, dh);
  const long long r = blockIdx.x;
  const long long base = r * n_split;
  const int d = threadIdx.x;
  const SplitMerge mg(part.m + base, part.l + base, n_split);
  float o = 0.f;
  for (int s = 0; s < n_split; ++s)
    o += part.acc[(base + s) * dh + d] * mg.weight(part.m[base + s]);
  static_cast<TQ*>(out_)[r * dh + d] = from_f<TQ>(o);
  if (d == 0) {
    m_out[r] = mg.m;
    l_out[r] = mg.l;
  }
}

constexpr int kMaxDevices = 16;

template <typename TQ, typename TKV, int DH, int G>
cudaError_t launch(const PaArgs& a, int n_split, cudaStream_t stream) {
  constexpr int kSmem = kWarps * G * (2 + DH) * static_cast<int>(sizeof(float));
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  auto kernel = paged_attention_kernel<TQ, TKV, DH, G>;
  if constexpr (kSmem > 48 * 1024) {
    // past the default ceiling (G 8 at Dh 256): once per instance and card
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
  }
  kernel<<<dim3(a.b * a.hkv * a.n_sub, n_split), kWarps * 32, kSmem,
           stream>>>(a, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<TQ><<<a.b * a.hkv * a.g, DH, 0, stream>>>(
      a.ws, n_split, DH, a.out, a.m_out, a.l_out);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DH>
cudaError_t by_group(int g, const PaArgs& args, int ns, cudaStream_t st) {
  PaArgs a = args;
  const int gs = subgroup_rows(g);
  a.g = g;
  a.n_sub = (g + gs - 1) / gs;
  switch (gs) {
    case 1: return launch<TQ, TKV, DH, 1>(a, ns, st);
    case 2: return launch<TQ, TKV, DH, 2>(a, ns, st);
    case 4: return launch<TQ, TKV, DH, 4>(a, ns, st);
    default: return launch<TQ, TKV, DH, 8>(a, ns, st);
  }
}

template <typename TQ, typename TKV>
cudaError_t by_width(int dh, int g, const PaArgs& a, int ns,
                     cudaStream_t st) {
  switch (dh) {
    case 32: return by_group<TQ, TKV, 32>(g, a, ns, st);
    case 64: return by_group<TQ, TKV, 64>(g, a, ns, st);
    case 128: return by_group<TQ, TKV, 128>(g, a, ns, st);
    case 256: return by_group<TQ, TKV, 256>(g, a, ns, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace die

// q [B, H, Dh] in q_dtype; the pools [rows, P, Hkv*Dh] in kv_dtype (fp32,
// bf16 or e4m3), page p of slot b at row layer_base + page_table[b, p];
// out [B, H, Dh] in q_dtype; m_out/l_out [B, H] fp32; any H / Hkv, Dh 32,
// 64, 128 or 256. window 0 is full attention. The keys of a slot are cut into n_split runs of `chunk`
// (n_split * chunk must cover the most valid keys a slot can have); with
// n_split > 1, ws is an fp32 workspace of B * H * n_split * (Dh + 2)
// values and a second kernel merges the runs. Returns cudaGetLastError()
// of the launches (0 on success).
extern "C" int die_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const int* page_table,
                                   const int* lengths, void* out, float* m_out,
                                   float* l_out, float* ws, int b, int h,
                                   int hkv, int dh, int page_size, int mp,
                                   int window, int n_split, int chunk,
                                   long long layer_base, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  if (hkv <= 0 || h % hkv || h == 0 || page_size <= 0 || window < 0 ||
      n_split < 1 ||
      chunk < 1 || (n_split > 1 && ws == nullptr))
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
  a.ws = ws;
  a.b = b;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  a.window = window;
  a.chunk = chunk;
  a.layer_base = layer_base;
  const int g = h / hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == die::kBF16 && kv_dtype == die::kBF16)
    err = die::by_width<__nv_bfloat16, __nv_bfloat16>(dh, g, a, n_split, st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kF32)
    err = die::by_width<float, float>(dh, g, a, n_split, st);
  else if (q_dtype == die::kBF16 && kv_dtype == die::kF32)
    err = die::by_width<__nv_bfloat16, float>(dh, g, a, n_split, st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kBF16)
    err = die::by_width<float, __nv_bfloat16>(dh, g, a, n_split, st);
  else if (q_dtype == die::kBF16 && kv_dtype == die::kFP8)
    err = die::by_width<__nv_bfloat16, die::fp8>(dh, g, a, n_split, st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kFP8)
    err = die::by_width<float, die::fp8>(dh, g, a, n_split, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
