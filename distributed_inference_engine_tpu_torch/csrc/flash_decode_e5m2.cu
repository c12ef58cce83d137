// The e5m2-pool instances of flash-decode and its writeback variant
// (flash_decode.cuh), as flash_decode_fp8.cu holds the e4m3 ones: bf16 q on
// the tensor cores (fp8_block, each e5m2 word widened in registers by byte
// permutes: an e5m2 value is an f16's top byte), fp32 q on the CUDA cores.
// A file of their own, so that nvcc builds them beside the other instances.
#include "flash_decode.cuh"

namespace die {
namespace fd {

template <bool FW>
cudaError_t dispatch_e5m2(const FdArgs& a, int dh, int g, int n_split,
                          int q_dtype, cudaStream_t st) {
  if (q_dtype == kBF16)
    return by_width<__nv_bfloat16, e5m2, FW>(dh, g, a, n_split, st);
  if (q_dtype == kF32) return by_width<float, e5m2, FW>(dh, g, a, n_split, st);
  return cudaErrorInvalidValue;
}

template cudaError_t dispatch_e5m2<false>(const FdArgs&, int, int, int, int,
                                          cudaStream_t);
template cudaError_t dispatch_e5m2<true>(const FdArgs&, int, int, int, int,
                                         cudaStream_t);

}  // namespace fd
}  // namespace die
