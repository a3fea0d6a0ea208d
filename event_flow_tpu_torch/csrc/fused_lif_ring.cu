// K2's float32 instances on the persistent float mainloop of
// conv_ring.cuh (k 1, 3, 5; channel groups of 8, 16 and 32; both resets),
// in a source of their own so that they compile beside fused_lif.cu,
// whose launcher routes the calls that ops/conv_plan.py::k2_plan puts on
// the ring here; the bfloat16 ones are fused_lif_ring_bf16.cu's.

#include "conv_ring.cuh"

namespace evf {
namespace ring {

cudaError_t launch_f32(const Call& c, cudaStream_t st) {
  return launch<float>(c, st);
}

}  // namespace ring
}  // namespace evf
