// K2's bfloat16 instances on the persistent float mainloop of
// conv_ring.cuh, beside fused_lif_ring.cu's float32 ones: a source of
// their own, so that the two compile in parallel.

#include "conv_ring.cuh"

namespace evf {
namespace ring {

cudaError_t launch_bf16(const Call& c, cudaStream_t st) {
  return launch<bf16>(c, st);
}

}  // namespace ring
}  // namespace evf
