// K2 rec with Crec != Cout on the persistent float mainloop of
// conv_ring.cuh: its instances (k 1, 3, 5; channel groups of 8 and 16;
// both resets; float32 and bfloat16), in a source of their own so that
// they compile beside fused_lif.cu, whose launcher routes the calls here.

#include "conv_ring.cuh"

namespace evf {
namespace ring {

cudaError_t launch_f32(const Call& c, cudaStream_t st) {
  return launch<float>(c, st);
}

cudaError_t launch_bf16(const Call& c, cudaStream_t st) {
  return launch<bf16>(c, st);
}

}  // namespace ring
}  // namespace evf
