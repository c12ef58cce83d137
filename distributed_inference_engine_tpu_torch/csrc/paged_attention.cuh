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
// per valid key, each read once) over 3.35 TB/s. The arithmetic is ~G
// FLOP per byte, far below the bf16 ridge. The window is where the saving
// comes from: a block reads the keys [max(0, len - window), len) and
// nothing before them, so at a 4096-token window a 6,000-token slot reads
// two thirds of its pages.
//
// Design: split KV. The grid is (slot x KV head x sub-group, run): a
// slot's valid keys [lo, hi), lo = max(0, len - window) (0 without a
// window) and hi = min(len, mp * page_size), are cut into n_split runs of
// `chunk` keys from lo, one block each, so a long slot is read by many SMs
// at once; the window's lower bound is applied where a run's range is
// clipped, so no tile holds a key before it, and the run's last tile masks
// its tail. The host sizes the grid from shapes alone (n_split * chunk
// covers the window or the table; ops/paged_attention.py paged_plan) and
// never reads the lengths. Two routes, chosen there by one rule from the
// dtypes and G:
// - Tensor cores: bf16 q over bf16 pools at G >= 3, over e4m3 or e5m2 pools
//   at every G (e5m2 as e4m3, its pairs widened by byte permutes: common.cuh
//   f8x2_to_f16x2). This is flash-decode's tensor-core core
//   (flash_decode.cuh) with no side window, a lower key bound and the stats: a
//   block takes up to 16 query heads of one KV head as the rows of one m16
//   tile (the 8-row form up to G 8; above it the warps go in pairs, one a row
//   half; G > 16 in sub-groups of 16), so each K/V tile is read once for all
//   of them, and its state lives in mma fragments whatever G is. The run's K/V
//   rows are staged tile by tile through the 3-stage cp.async ring
//   (stream_tiles; row addresses from the run's page ids, copied into shared
//   memory first); over bf16 pools S = Q K^T and O += P V run with mma.sync
//   m16n8k16 from ldmatrix (mma_tile); over e4m3 pools the tiles hold twice
//   the keys and each warp takes its sub-tiles transposed, the fragments read
//   from the e4m3 tile and widened in registers (fp8_block); both with an fp32
//   online softmax whose l sums the fp32 probabilities before P is rounded (to
//   bf16; to f16 against e4m3 V). A run holds at most 16 tiles (a block's time
//   is its chain of tiles: ring wait, two barriers, one sub-tile's mma and
//   softmax). The runs merge in the same launch: the last run of a (slot, KV
//   head, sub-group) to arrive merges their fp32 partials (common.cuh
//   SplitPartials, SplitMerge) and writes out, m and l (flash_decode.cuh
//   finish_mma), with
//   per-stream arrival counters as flash-decode's (ops/_cuda.py
//   split_scratch). That merge is the tail of every launch; it reads the
//   partials four values a load with a bounded number in flight, and each
//   row's state weights once. Four blocks fit an SM at Dh <= 128.
// - CUDA cores: every other case (fp32 q keeps its 1e-4 tolerance, which TF32
//   would break; bf16 q over bf16 pools at G 1 and 2, where this route
//   measured faster: PERF.md). A key row
//   of this head is Dh elements; LPK lanes read it with one 16-byte load each
//   (8 bytes of e4m3), so a warp reads KPW = 32 / LPK rows at once. Each lane
//   group keeps its own (m, l, acc) for GS query heads (1, 2, 4 or 8; a KV
//   head's G heads in ceil(G / GS) sub-groups, the rows past G dead: computed
//   on a copy of the last live row, never stored) over a strided subset of the
//   run's keys: it loads kU rows straight from global memory, scores all of
//   them, rescales its state once and adds them. The groups of a warp merge
//   through shuffles and the warps through shared memory; with more than one
//   run a second kernel merges the runs (paged_merge_kernel): merging them in
//   the same launch instead measured slower on this route (PERF.md). At Dh 256
//   a bf16 or e4m3 row is one load a lane and an fp32 row two.
//
// The route rule (ops/paged_attention.py paged_plan), from times on an
// NVIDIA H100 80GB HBM3 at 700 W (scripts/paged_times.py and chip_smoke.py;
// B 8, lengths 0-6,000, 8 KV heads, bf16 pools, ms, tensor cores / CUDA
// cores, window 0 and 4096): G 4 at Dh 128 0.0455 / 0.0555 and 0.0458 /
// 0.0609; G 2 0.0455 / 0.0434 and 0.0416 / 0.0486; G 1 0.0440 / 0.0403 and
// 0.0390 / 0.0458; at Dh 256 G 4 0.1028 / 0.0949 and 0.0877 / 0.1116, G 2
// 0.1002 / 0.0721 and 0.0868 / 0.0874, G 1 0.0991 / 0.0674 and 0.0863 /
// 0.0799. So the tensor cores take G >= 3, where they win but for Dh 256
// at G 4 without a window; below it the CUDA cores, which win at Dh 256
// and without a window (at Dh 128 with a window the tensor cores would be
// 10-15% faster at G 1 and 2: the price of one rule by shape). Over e4m3
// pools the tensor cores widen their fragments in registers and take every
// G: at window 4096 they measured 0.0273 / 0.0336 ms at Dh 128 G 1, 0.0275 /
// 0.0457 at G 2, 0.0549 / 0.0827 at Dh 256 G 2; at Gemma-7B's G 1, Dh 256
// 0.1095 / 0.1250 at window 0 (Gemma-7B has no window; at 4096 it would be
// 0.0934 / 0.0869) (chip_smoke.py).
//
// What the TPU kernel needed and this one does not: the sequential (slot,
// page) grid with scratch accumulators, the 0/1 segment-sum matmuls and
// the lane-slice GQA concats (Mosaic's rank-2 rule). The TPU kernel skips
// whole pages outside the window and masks inside them; this one walks the
// valid keys only, which reads the same bytes.
#pragma once

#include <algorithm>

#include "flash_decode.cuh"

namespace die {
namespace pa {

using fd::kNegInf;

struct PaArgs {
  fd::FdArgs f;   // q .. counters, shapes, split; prefix_lens = lengths
  int window;
  float* m_out;   // [B, H]
  float* l_out;   // [B, H]
};

// A tensor-core block's plan: its query rows (plan_rows) and its run of
// the slot's valid keys [lo, hi), from s_lo, n_pref keys; no side keys.
template <int GS>
__device__ __forceinline__ fd::Plan make_plan(const PaArgs& a) {
  const fd::FdArgs& f = a.f;
  fd::Plan p;
  fd::plan_rows<GS>(f, p);
  const int len = f.prefix_lens[p.b];
  const int hi = min(len, f.mp * f.page_size);
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  p.s_lo = lo + p.split * f.chunk;
  p.n_pref = max(0, min(hi, p.s_lo + f.chunk) - p.s_lo);
  p.pg0 = p.s_lo / f.page_size;
  p.ns = 0;
  p.sidx = 0;
  p.fresh = false;
  p.pages = nullptr;
  return p;
}

// ---------------------------------------------------------- tensor cores

template <typename TKV, int DH, int R>
__global__ void __launch_bounds__(fd::kThreads, DH <= 128 ? 4 : 1)
    paged_mma_kernel(PaArgs a, float scale) {
  extern __shared__ __align__(16) char smem[];
  using S = fd::Smem<__nv_bfloat16, TKV, DH, R>;
  __shared__ int run_pages[fd::kRunPages];
  fd::Plan p = make_plan<R>(a);
  const int n_pg = p.n_pref > 0
                       ? (p.s_lo + p.n_pref - 1) / a.f.page_size - p.pg0 + 1
                       : 0;
  p.pages = fd::run_page_ids<fd::kThreads>(
      a.f.page_table + static_cast<long long>(p.b) * a.f.mp, p.pg0, n_pg,
      run_pages);
  __syncthreads();  // the run's page ids
  // the warps' states alias the ring, which is free after the last tile
  float* scratch = reinterpret_cast<float*>(smem);
  if constexpr (kIsFp8<TKV>)
    fd::fp8_block<TKV, DH, R>(a.f, p, smem, scratch, scale);
  else
    fd::mma_block<DH, R>(a.f, p, smem, smem + S::kQAt, scratch, scale);
  __syncthreads();
  fd::finish_mma<DH, R, true>(a.f, p, scratch, a.m_out, a.l_out);
}

// ------------------------------------------------------------ CUDA cores

constexpr int kSimtWarps = 8;

// A block is one sub-group of G (the instance's GS) query heads of a
// (slot, KV head). G >= 8 keeps 64 fp32 accumulators and 64 query values
// a lane at Dh 128 and 256, and so does G 4 over fp32 pools at Dh 256
// (two loads a row): one block per SM; the others are held to two.
template <typename TQ, typename TKV, int DH, int G>
__global__ void __launch_bounds__(
    kSimtWarps * 32, (G >= 8 || (G >= 4 && DH / kVecOf<TKV> > 32)) ? 1 : 2)
    paged_simt_kernel(PaArgs args, float scale) {
  const fd::FdArgs& a = args.f;
  constexpr int kVec = kVecOf<TKV>;      // per load (16 bytes; e4m3 8)
  // lanes per key row: one load each, or two (fp32 at Dh 256)
  constexpr int kLpk = DH / kVec > 32 ? 32 : DH / kVec;
  constexpr int kEl = DH / kLpk;         // elements a lane
  static_assert(kLpk >= 1 && 32 % kLpk == 0 && kEl % kVec == 0,
                "a key row is whole loads over 1 to 32 lanes");
  constexpr int kKpw = 32 / kLpk;        // key rows a warp reads at once
  constexpr int kSweep = kSimtWarps * kKpw;  // rows the block reads at once
  constexpr int kU = G >= 8 ? 2 : 4;     // rows in flight per lane group
  extern __shared__ __align__(16) char smem_bytes[];
  float* smem = reinterpret_cast<float*>(smem_bytes);
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
  const int len = a.prefix_lens[b];
  const int hi = min(len, a.mp * a.page_size);
  const int lo = args.window > 0 ? max(0, len - args.window) : 0;
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
          args.m_out[r] = kNegInf;
          args.l_out[r] = 0.f;
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

  // merge the warps: smem = [kSimtWarps][G][2 + DH]
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
    for (int wi = 0; wi < kSimtWarps; ++wi)
      mx = fmaxf(mx, smem[(wi * G + gi) * kStride]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int wi = 0; wi < kSimtWarps; ++wi) {
      const float* slot = smem + (wi * G + gi) * kStride;
      const float wgt = expf(slot[0] - mx);
      den += slot[1] * wgt;
      num += slot[2 + d] * wgt;
    }
    const long long r = row0 + gi;
    if (n_split == 1) {
      out[r * DH + d] = from_f<TQ>(num / fmaxf(den, 1e-30f));
      if (d == 0) {
        args.m_out[r] = mx;
        args.l_out[r] = den;
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

// ---------------------------------------------------------------- launch

// A launch's dynamic shared memory past the default 48 KB: the kernel's
// ceiling is raised once per kernel (allowed: its own ceilings by device)
// and size.
inline cudaError_t allow_smem(const void* kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= fd::kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] < bytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}

template <typename TKV, int DH, int R>
cudaError_t launch_mma(const PaArgs& a, int n_split, cudaStream_t st) {
  auto kernel = paged_mma_kernel<TKV, DH, R>;
  static int allowed[fd::kMaxDevices] = {};
  // the last run's merge keeps the runs' (m, l) of its rows in shared
  // memory too: a long table asks for more than the block's own layout
  const int bytes =
      std::max(fd::Smem<__nv_bfloat16, TKV, DH, R>::kBytes,
               n_split * R * 2 * static_cast<int>(sizeof(float)));
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), bytes, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.f.b * a.f.hkv * a.f.n_sub, n_split), fd::kThreads, bytes,
           st>>>(a, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DH, int G>
cudaError_t launch_simt(const PaArgs& a, int n_split, cudaStream_t st) {
  auto kernel = paged_simt_kernel<TQ, TKV, DH, G>;
  static int allowed[fd::kMaxDevices] = {};
  constexpr int kSmem =
      kSimtWarps * G * (2 + DH) * static_cast<int>(sizeof(float));
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), kSmem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.f.b * a.f.hkv * a.f.n_sub, n_split), kSimtWarps * 32,
           kSmem, st>>>(a, 1.0f / sqrtf(static_cast<float>(DH)));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge_kernel<TQ><<<a.f.b * a.f.hkv * a.f.g, DH, 0, st>>>(
      a.f.ws, n_split, DH, a.f.out, a.m_out, a.l_out);
  return cudaGetLastError();
}

// rows: the query rows a block holds (tensor cores 8 or 16; CUDA cores 1,
// 2, 4 or 8); the n_sub sub-groups of a KV head are set from it.
template <typename TQ, typename TKV, int DH>
cudaError_t by_route(bool mma, int rows, const PaArgs& a, int ns,
                     cudaStream_t st) {
  if (mma) {
    if constexpr (fd::kMma<TQ, TKV>) {
      switch (rows) {
        case 8: return launch_mma<TKV, DH, 8>(a, ns, st);
        case 16: return launch_mma<TKV, DH, 16>(a, ns, st);
        default: return cudaErrorInvalidValue;
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (rows) {
    case 1: return launch_simt<TQ, TKV, DH, 1>(a, ns, st);
    case 2: return launch_simt<TQ, TKV, DH, 2>(a, ns, st);
    case 4: return launch_simt<TQ, TKV, DH, 4>(a, ns, st);
    case 8: return launch_simt<TQ, TKV, DH, 8>(a, ns, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t by_width(int dh, bool mma, int rows, const PaArgs& a, int ns,
                     cudaStream_t st) {
  switch (dh) {
    case 32: return by_route<TQ, TKV, 32>(mma, rows, a, ns, st);
    case 64: return by_route<TQ, TKV, 64>(mma, rows, a, ns, st);
    case 128: return by_route<TQ, TKV, 128>(mma, rows, a, ns, st);
    case 256: return by_route<TQ, TKV, 256>(mma, rows, a, ns, st);
    default: return cudaErrorInvalidValue;
  }
}

// The fp8-pool instances (e4m3 and e5m2: bf16 q on the tensor cores,
// fp32 q on the CUDA cores), compiled apart in paged_attention_fp8.cu so
// that the build runs them beside the bf16- and fp32-pool ones.
cudaError_t dispatch_fp8(int q_dtype, int kv_dtype, int dh, bool mma,
                         int rows, const PaArgs& a, int ns, cudaStream_t st);

}  // namespace pa
}  // namespace die
