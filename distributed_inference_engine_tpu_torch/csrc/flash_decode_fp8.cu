// The e4m3-pool instances of flash-decode and its writeback variant
// (flash_decode.cuh): bf16 q on the tensor cores, fp32 q on the CUDA cores.
// A file of their own, so that nvcc builds them beside flash_decode.cu's
// instances rather than after them.
#include "flash_decode.cuh"

namespace die {
namespace fd {

template <bool FW>
cudaError_t dispatch_fp8(const FdArgs& a, int dh, int g, int n_split,
                         int q_dtype, cudaStream_t st) {
  if (q_dtype == kBF16)
    return by_width<__nv_bfloat16, fp8, FW>(dh, g, a, n_split, st);
  if (q_dtype == kF32) return by_width<float, fp8, FW>(dh, g, a, n_split, st);
  return cudaErrorInvalidValue;
}

template cudaError_t dispatch_fp8<false>(const FdArgs&, int, int, int, int,
                                         cudaStream_t);
template cudaError_t dispatch_fp8<true>(const FdArgs&, int, int, int, int,
                                        cudaStream_t);

}  // namespace fd
}  // namespace die
