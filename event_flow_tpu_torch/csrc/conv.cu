// K1: same-padded stride-1 NHWC convolution, FP32 in and out, for sm_90a.
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_fwd, the Pallas
// im2col strip matmul [th*W, k*k*Cin] @ [k*k*Cin, Cout]. Here it is an
// implicit GEMM on the tensor cores in 3xTF32 over shared-memory halo
// tiles staged with cp.async (mainloop in conv_tile.cuh), with no im2col
// matrix anywhere, and y written from the MMA fragments as float2, 32
// contiguous bytes per quad of lanes.
//
// What bounds it on the H100: it runs the 1x1 prediction head (32 -> 2)
// and, in training, every dx (32 -> 32 at k = 3, and 2 -> 32 at k = 1 for
// the head's). At 8 x 128 x 128 the dx conv moves about 34 MB and does
// 2.4 GFLOP (7.2 in 3xTF32), so at 3.35 TB/s and the tensor cores' rate
// it is bound by bytes; the design reads and writes whole 32-byte sectors
// and keeps 16-byte copies in flight. The 1x1 calls move a few MB and are
// bound by bytes and launch latency.

#include "conv_tile.cuh"

namespace {

using namespace evf;

template <int K, int CO>
__global__ void __launch_bounds__(NT, 2)
    conv2d_same_kernel(const float* __restrict__ x,
                       const float* __restrict__ w2, float* __restrict__ y,
                       int H, int W, int Cin, int Cout, int cpad_max,
                       int flags) {
  extern __shared__ __align__(16) float smem[];
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[MT][CO / 8][4] = {};
  accumulate<K, CO>(smem, acc, x, Cin, w2, Cout, b, H, W, y0, x0, co0,
                    cpad_max, flags & kVecX, flags & kVecW);
  const bool vec2 = flags & kVec2;
  for_each_pair<CO>(acc, H, W, Cout, b, y0, x0, co0,
                    [&](size_t i, int co, float a0, float a1) {
                      if (vec2) {
                        *reinterpret_cast<float2*>(y + i) =
                            make_float2(a0, a1);
                      } else {
                        y[i] = a0;
                        if (co + 1 < Cout) y[i + 1] = a1;
                      }
                    });
}

template <int K, int CO>
cudaError_t launch_co(const float* x, const float* w2, float* y, int B,
                      int H, int W, int Cin, int Cout, cudaStream_t st) {
  const cudaError_t e =
      allow_smem(conv2d_same_kernel<K, CO>, smem_bytes<K, CO>(CCH));
  if (e != cudaSuccess) return e;
  const int cpad = pass_pad(Cin, 0);
  const int flags = (Cin % 4 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (Cout % 4 == 0 && aligned(w2, 16) ? kVecW : 0) |
                    (Cout % 2 == 0 && aligned(y, 8) ? kVec2 : 0);
  conv2d_same_kernel<K, CO>
      <<<grid_for(B, H, W, Cout, CO), NT, smem_bytes<K, CO>(cpad), st>>>(
          x, w2, y, H, W, Cin, Cout, cpad, flags);
  return cudaSuccess;
}

template <int K>
cudaError_t launch(const float* x, const float* w2, float* y, int B, int H,
                   int W, int Cin, int Cout, cudaStream_t st) {
  if (Cout <= 8) return launch_co<K, 8>(x, w2, y, B, H, W, Cin, Cout, st);
  return launch_co<K, 32>(x, w2, y, B, H, W, Cin, Cout, st);
}

}  // namespace

extern "C" {

// y [B,H,W,Cout] = conv of x [B,H,W,Cin] with w2 [K*K*Cin, Cout].
// Returns the error of the shared-memory attribute, or cudaGetLastError()
// after the launch.
int evf_conv2d_same(const float* x, const float* w2, float* y, int B, int H,
                    int W, int Cin, int Cout, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1>(x, w2, y, B, H, W, Cin, Cout, st); break;
    case 3: e = launch<3>(x, w2, y, B, H, W, Cin, Cout, st); break;
    case 5: e = launch<5>(x, w2, y, B, H, W, Cin, Cout, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
