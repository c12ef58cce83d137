// The writeback variant's bf16- and fp32-pool instances of flash-decode
// (flash_decode.cuh dispatch_wide<true>), compiled apart from
// flash_decode.cu's plain variant so that the build runs the two side by
// side.
#include "flash_decode.cuh"

namespace die {
namespace fd {

template cudaError_t dispatch_wide<true>(const FdArgs&, int, int, int, int,
                                         int, cudaStream_t);

}  // namespace fd
}  // namespace die
