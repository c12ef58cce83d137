// Flash-decode attention and its writeback variant: the launches and the
// C entry points. The kernels, and what they replace, are in
// flash_decode.cuh. This file compiles the plain variant's bf16- and
// fp32-pool instances; the writeback variant's are compiled in
// flash_decode_fw.cu, the e4m3- and e5m2-pool instances in
// flash_decode_fp8.cu and flash_decode_e5m2.cu.
#include "flash_decode.cuh"

namespace die {
namespace fd {

extern template cudaError_t dispatch_wide<true>(const FdArgs&, int, int, int,
                                                int, int, cudaStream_t);
template cudaError_t dispatch_wide<false>(const FdArgs&, int, int, int, int,
                                          int, cudaStream_t);

template <bool FW>
int dispatch(const FdArgs& a, int h, int dh, int n_split, int q_dtype,
             int kv_dtype, void* stream) {
  if (a.b <= 0) return 0;
  if (a.hkv <= 0 || h % a.hkv || a.page_size <= 0 || n_split < 1 ||
      a.chunk < 1 ||
      static_cast<long long>(n_split) * a.chunk <
          static_cast<long long>(a.mp) * a.page_size ||
      (n_split > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = h / a.hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_dtype == kFP8)
    err = dispatch_fp8<FW>(a, dh, g, n_split, q_dtype, st);
  else if (kv_dtype == kE5M2)
    err = dispatch_e5m2<FW>(a, dh, g, n_split, q_dtype, st);
  else
    err = dispatch_wide<FW>(a, dh, g, n_split, q_dtype, kv_dtype, st);
  return static_cast<int>(err);
}

}  // namespace fd
}  // namespace die

// q [B, H, Dh] and side_k/side_v [B, W, Hkv, Dh] in q_dtype; the stacked
// pools [L*N, P, Hkv*Dh] in kv_dtype; out [B, H, Dh] in q_dtype. Each
// slot's prefix is cut into n_split runs of `chunk` keys (n_split * chunk
// >= mp * page_size); with n_split > 1, ws is an fp32 workspace of
// B * H * n_split * (Dh + 2) values and counters B * Hkv * n_sub ints that
// are 0 (and are 0 again when the launch ends), n_sub the sub-groups of a
// KV head's H / Hkv query heads (any group: flash_decode.cuh). kv_dtype may
// also be e4m3 (kFP8) or e5m2 (kE5M2). bf16 q over bf16, e4m3 or e5m2 pools
// runs on the tensor cores, every other pair on the CUDA cores. Returns the launch's cudaGetLastError() (0
// on success).
extern "C" int die_flash_decode(const void* q, const void* k_pages,
                                const void* v_pages, const int* page_table,
                                const int* prefix_lens, const void* side_k,
                                const void* side_v, const int* n_side,
                                void* out, float* ws, int* counters, int b,
                                int h, int hkv, int dh, int page_size, int mp,
                                int w, int n_split, int chunk,
                                long long layer_base, int q_dtype,
                                int kv_dtype, void* stream) {
  die::fd::FdArgs a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = page_table;
  a.prefix_lens = prefix_lens;
  a.side_k = const_cast<void*>(side_k);
  a.side_v = const_cast<void*>(side_v);
  a.n_side = n_side;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.b = b;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  a.w = w;
  a.chunk = chunk;
  a.layer_base = layer_base;
  return die::fd::dispatch<false>(a, h, dh, n_split, q_dtype, kv_dtype,
                                  stream);
}

// The writeback variant: as die_flash_decode, with fresh_k/fresh_v
// [B, 1, Hkv, Dh] in q_dtype attended as one extra key and written into
// side_k/side_v[b, side_idx[b]] (in place) for slots with active[b] != 0
// and side_idx[b] < W.
extern "C" int die_flash_decode_fw(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* prefix_lens, void* side_k, void* side_v,
    const void* fresh_k, const void* fresh_v, const int* side_idx,
    const int* active, void* out, float* ws, int* counters, int b, int h,
    int hkv, int dh, int page_size, int mp, int w, int n_split, int chunk,
    long long layer_base, int q_dtype, int kv_dtype, void* stream) {
  die::fd::FdArgs a{};
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
  a.ws = ws;
  a.counters = counters;
  a.b = b;
  a.hkv = hkv;
  a.page_size = page_size;
  a.mp = mp;
  a.w = w;
  a.chunk = chunk;
  a.layer_base = layer_base;
  return die::fd::dispatch<true>(a, h, dh, n_split, q_dtype, kv_dtype,
                                 stream);
}
