// Paged decode attention: the C entry point and the bf16- and fp32-pool
// instances. The kernels, and what they replace, are in
// paged_attention.cuh; the e4m3- and e5m2-pool instances are compiled in
// paged_attention_fp8.cu.
#include "paged_attention.cuh"

// q [B, H, Dh] in q_dtype; the pools [rows, P, Hkv*Dh] in kv_dtype (fp32,
// bf16, e4m3 or e5m2), page p of slot b at row layer_base + page_table[b, p];
// out [B, H, Dh] in q_dtype; m_out/l_out [B, H] fp32; any H / Hkv, Dh 32,
// 64, 128 or 256. window 0 is full attention. The valid keys of a slot are
// cut into n_split runs of `chunk` (n_split * chunk covers the window, or
// mp * page_size keys when that is fewer or there is no window); with
// n_split > 1, ws is an fp32 workspace of B * H * n_split * (Dh + 2)
// values and counters B * Hkv * ceil(H / Hkv / rows) ints that are 0 (and
// are 0 again when the launch ends). mma 1 takes the tensor cores (bf16 q
// over bf16, e4m3 or e5m2 pools; rows 8 or 16), 0 the CUDA cores (rows 1, 2, 4
// or 8; with n_split > 1 a second kernel merges the runs). Returns
// cudaGetLastError() of the launches (0 on success).
extern "C" int die_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* out, float* m_out,
    float* l_out, float* ws, int* counters, int b, int h, int hkv, int dh,
    int page_size, int mp, int window, int n_split, int chunk, int rows,
    int mma, long long layer_base, int q_dtype, int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  const long long table_keys = static_cast<long long>(mp) * page_size;
  const long long max_keys =
      window > 0 && window < table_keys ? window : table_keys;
  if (hkv <= 0 || h % hkv || h == 0 || page_size <= 0 || window < 0 ||
      n_split < 1 || chunk < 1 || rows < 1 ||
      static_cast<long long>(n_split) * chunk < max_keys ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  die::pa::PaArgs a{};
  a.f.q = q;
  a.f.k_pages = k_pages;
  a.f.v_pages = v_pages;
  a.f.page_table = page_table;
  a.f.prefix_lens = lengths;
  a.f.out = out;
  a.f.ws = ws;
  a.f.counters = counters;
  a.f.b = b;
  a.f.hkv = hkv;
  a.f.page_size = page_size;
  a.f.mp = mp;
  a.f.chunk = chunk;
  a.f.g = h / hkv;
  a.f.n_sub = (a.f.g + rows - 1) / rows;
  a.f.layer_base = layer_base;
  a.window = window;
  a.m_out = m_out;
  a.l_out = l_out;
  const bool tc = mma != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_dtype == die::kFP8 || kv_dtype == die::kE5M2)
    err = die::pa::dispatch_fp8(q_dtype, kv_dtype, dh, tc, rows, a, n_split,
                                st);
  else if (q_dtype == die::kBF16 && kv_dtype == die::kBF16)
    err = die::pa::by_width<__nv_bfloat16, __nv_bfloat16>(dh, tc, rows, a,
                                                          n_split, st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kF32)
    err = die::pa::by_width<float, float>(dh, tc, rows, a, n_split, st);
  else if (q_dtype == die::kBF16 && kv_dtype == die::kF32)
    err = die::pa::by_width<__nv_bfloat16, float>(dh, tc, rows, a, n_split,
                                                  st);
  else if (q_dtype == die::kF32 && kv_dtype == die::kBF16)
    err = die::pa::by_width<float, __nv_bfloat16>(dh, tc, rows, a, n_split,
                                                  st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
