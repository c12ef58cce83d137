// Ragged mixed-batch attention: the C entry point and the bf16- and
// fp32-pool instances. The kernels, and what they replace, are in
// ragged_attention.cuh; the e4m3- and e5m2-pool instances are compiled in
// ragged_attention_fp8.cu.
#include "ragged_attention.cuh"

namespace die {
namespace ra {

// The bf16-pool tensor-core instances (the fp8-pool ones are compiled in
// ragged_attention_fp8.cu).
cudaError_t mma_by_width(int dh, const RaggedArgs& a, int grid,
                         cudaStream_t st) {
  switch (dh) {
    case 32: return launch_mma<32>(a, grid, st);
    case 64: return launch_mma<64>(a, grid, st);
    case 128: return launch_mma<128>(a, grid, st);
    case 256: return launch_mma<256>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ra
}  // namespace die

// q [R, Qmax, H, Dh] and fresh_k/fresh_v [R, Qmax, Hkv, Dh] in q_dtype;
// the stacked pools [L*N, P, Hkv*Dh] in kv_dtype, written in place at
// positions [ctx_lens[r], ctx_lens[r] + q_lens[r]) of row r's pages; out
// [R, Qmax, H, Dh] in q_dtype. n_tiles query tiles a row and grid, the
// tensor-core instance's persistent block count (the host's ragged_plan):
// tiles of floor(128 / gs) queries for bf16 q over bf16, e4m3 (kFP8) or
// e5m2 (kE5M2) pools (the tensor cores), floor(64 / gs) for every other
// pair (one block
// a tile, grid not read), gs = min(H/Hkv, 64) the heads of an item (any
// H/Hkv: above 64 a KV head's heads take ceil((H/Hkv) / 64) items).
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int die_ragged_attention(
    const void* q, const void* fresh_k, const void* fresh_v, void* k_pages,
    void* v_pages, const int* page_table, const int* ctx_lens,
    const int* q_lens, void* out, int r, int qmax, int h, int hkv, int dh,
    int page_size, int mp, int n_tiles, int grid, long long layer_base,
    int q_dtype, int kv_dtype, void* stream) {
  using namespace die;
  using namespace die::ra;
  if (r <= 0 || qmax <= 0) return 0;
  if (hkv <= 0 || h % hkv || h == 0 || dh % 32)
    return cudaErrorInvalidValue;
  const bool mma =
      q_dtype == kBF16 &&
      (kv_dtype == kBF16 || kv_dtype == kFP8 || kv_dtype == kE5M2);
  const int g = h / hkv;
  const int gs = g < kRows ? g : kRows;
  const int tq = (mma ? kMmaRows : kRows) / gs;
  if (n_tiles <= 0 || static_cast<long long>(n_tiles) * tq < qmax ||
      (n_tiles - 1) * tq >= qmax || (mma && grid <= 0))
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
  a.r = r;
  a.qmax = qmax;
  a.h = h;
  a.hkv = hkv;
  a.g = g;
  a.gs = gs;
  a.n_sub = (g + gs - 1) / gs;
  a.vh = hkv * a.n_sub;
  a.page_size = page_size;
  a.mp = mp;
  a.n_tiles = n_tiles;
  a.layer_base = layer_base;
  a.scale = 1.0f / sqrtf(static_cast<float>(dh));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_dtype == kFP8 || kv_dtype == kE5M2)
    err = dispatch_fp8(q_dtype, kv_dtype, dh, a, grid, st);
  else if (mma)
    err = mma_by_width(dh, a, grid, st);
  else if (q_dtype == kF32 && kv_dtype == kF32)
    err = simt_by_width<float, float>(dh / 32, a, st);
  else if (q_dtype == kBF16 && kv_dtype == kF32)
    err = simt_by_width<__nv_bfloat16, float>(dh / 32, a, st);
  else if (q_dtype == kF32 && kv_dtype == kBF16)
    err = simt_by_width<float, __nv_bfloat16>(dh / 32, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
