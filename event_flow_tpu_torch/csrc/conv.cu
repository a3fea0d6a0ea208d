// K1: same-padded stride-1 NHWC convolution, FP32, for sm_90a.
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_fwd, the Pallas
// im2col strip matmul [th*W, k*k*Cin] @ [k*k*Cin, Cout]. Here it is a
// direct conv over shared-memory tiles (mainloop in conv_tile.cuh) with
// no im2col matrix in device memory. On the slice it runs the 1x1
// prediction head (32 -> 2 channels at 1 x 180 x 240): about 6 MB of
// traffic and 5.5 MFLOP, so it is bound by launch overhead and bytes.

#include "conv_tile.cuh"

namespace {

using namespace evf;

template <int K, int CO>
__global__ void __launch_bounds__(NT)
    conv2d_same_kernel(const float* __restrict__ x,
                       const float* __restrict__ w2, float* __restrict__ y,
                       int H, int W, int Cin, int Cout) {
  __shared__ Tile<K, CO> s;
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  accumulate<K, CO>(s, acc, x, Cin, w2, Cout, b, H, W, y0, x0, co0);
  const int gy = y0 + threadIdx.x / TW;
  const int gx = x0 + threadIdx.x % TW;
  if (gy >= H || gx >= W) return;
  float* out = y + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
  for (int o = 0; o < CO; ++o)
    if (co0 + o < Cout) out[co0 + o] = acc[o];
}

template <int K>
void launch(const float* x, const float* w2, float* y, int B, int H, int W,
            int Cin, int Cout, cudaStream_t st) {
  if (Cout <= 8)
    conv2d_same_kernel<K, 8><<<grid_for(B, H, W, Cout, 8), NT, 0, st>>>(
        x, w2, y, H, W, Cin, Cout);
  else
    conv2d_same_kernel<K, 32><<<grid_for(B, H, W, Cout, 32), NT, 0, st>>>(
        x, w2, y, H, W, Cin, Cout);
}

}  // namespace

extern "C" {

// y [B,H,W,Cout] = conv of x [B,H,W,Cin] with w2 [K*K*Cin, Cout].
// Returns cudaGetLastError() after the launch.
int evf_conv2d_same(const float* x, const float* w2, float* y, int B, int H,
                    int W, int Cin, int Cout, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(x, w2, y, B, H, W, Cin, Cout, st); break;
    case 3: launch<3>(x, w2, y, B, H, W, Cin, Cout, st); break;
    case 5: launch<5>(x, w2, y, B, H, W, Cin, Cout, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
