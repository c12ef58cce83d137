// The e4m3- and e5m2-pool instances of ragged attention
// (ragged_attention.cuh): bf16 q on the tensor cores, warp specialised (a
// producer warpgroup widens each fp8 context tile and rounds each fresh
// tile into bf16 buffers off the mma warps' chain), fp32 q on the CUDA
// cores. A file of their own, so that nvcc builds them beside
// ragged_attention.cu's instances.
#include "ragged_attention.cuh"

namespace die {
namespace ra {

cudaError_t dispatch_fp8(int q_dtype, int kv_dtype, int dh,
                         const RaggedArgs& a, int grid, cudaStream_t st) {
  if (q_dtype == kBF16 && kv_dtype == kFP8)
    return fp8_by_width<fp8>(dh, a, grid, st);
  if (q_dtype == kBF16 && kv_dtype == kE5M2)
    return fp8_by_width<e5m2>(dh, a, grid, st);
  if (q_dtype == kF32 && kv_dtype == kFP8)
    return simt_by_width<float, fp8>(dh / 32, a, st);
  if (q_dtype == kF32 && kv_dtype == kE5M2)
    return simt_by_width<float, e5m2>(dh / 32, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace ra
}  // namespace die
