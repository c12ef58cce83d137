// The e4m3- and e5m2-pool instances of paged attention
// (paged_attention.cuh): bf16 q on the tensor cores (flash_decode.cuh
// fp8_block, the fragments widened in registers) or, where the caller asks
// for it, the CUDA cores; fp32 q on the CUDA cores, 8 values a lane. A
// file of their own, so that nvcc builds them beside paged_attention.cu's
// instances.
#include "paged_attention.cuh"

namespace die {
namespace pa {

cudaError_t dispatch_fp8(int q_dtype, int kv_dtype, int dh, bool mma,
                         int rows, const PaArgs& a, int ns, cudaStream_t st) {
  if (q_dtype == kBF16 && kv_dtype == kFP8)
    return by_width<__nv_bfloat16, fp8>(dh, mma, rows, a, ns, st);
  if (q_dtype == kF32 && kv_dtype == kFP8)
    return by_width<float, fp8>(dh, mma, rows, a, ns, st);
  if (q_dtype == kBF16 && kv_dtype == kE5M2)
    return by_width<__nv_bfloat16, e5m2>(dh, mma, rows, a, ns, st);
  if (q_dtype == kF32 && kv_dtype == kE5M2)
    return by_width<float, e5m2>(dh, mma, rows, a, ns, st);
  return cudaErrorInvalidValue;
}

}  // namespace pa
}  // namespace die
