// K1: same-padded stride-1 NHWC convolution for sm_90a, FP32 in and out,
// or bfloat16 in and out with an FP32 accumulator rounded once.
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_fwd, the Pallas
// im2col strip matmul [th*W, k*k*Cin] @ [k*k*Cin, Cout], whose bfloat16
// form (the mixed-precision policy, models/policy.py) takes bfloat16
// patches and weights, accumulates in float32 and rounds y to bfloat16
// (conv_pallas.py:82-110). Here it is an implicit GEMM on the tensor cores
// over shared-memory halo tiles staged with cp.async (mainloop in
// conv_tile.cuh: 3xTF32 for float32, one exact TF32 pass for bfloat16),
// with no im2col matrix anywhere, and y written from the MMA fragments as
// element pairs, 32 (bfloat16: 16) contiguous bytes per quad of lanes.
//
// What bounds it on the H100: it runs the 1x1 prediction head (32 -> 2)
// and, in training, every dx (32 -> 32 at k = 3, and 2 -> 32 at k = 1 for
// the head's). At 8 x 128 x 128 the dx conv moves about 34 MB (17 MB in
// bfloat16) and does 2.4 GFLOP (7.2 in 3xTF32), so at 3.35 TB/s and the
// tensor cores' rate it is bound by bytes; the design reads and writes
// whole 32-byte sectors and keeps 16-byte copies in flight. The 1x1 calls
// move a few MB and are bound by bytes and launch latency.

#include "conv_tile.cuh"

namespace {

using namespace evf;

template <int K, int CO, class T>
__global__ void __launch_bounds__(NT, 2)
    conv2d_same_kernel(const T* __restrict__ x, const T* __restrict__ w2,
                       T* __restrict__ y, int H, int W, int Cin, int Cout,
                       int cpad_max, Steps steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[MT][CO / 8][4] = {};
  accumulate<K, CO, T>(smem, acc, x, Cin, w2, Cout, b, H, W, y0, x0, co0,
                       cpad_max, steps.x, steps.w);
  for_each_pair<CO>(acc, H, W, Cout, b, y0, x0, co0,
                    [&](size_t i, int co, float a0, float a1) {
                      if (steps.out2) {
                        put2(y + i, a0, a1);
                      } else {
                        put(y + i, a0);
                        if (co + 1 < Cout) put(y + i + 1, a1);
                      }
                    });
}

template <int K, int CO, class T>
cudaError_t launch_co(const T* x, const T* w2, T* y, int B, int H, int W,
                      int Cin, int Cout, cudaStream_t st) {
  const cudaError_t e =
      allow_smem(conv2d_same_kernel<K, CO, T>, smem_bytes<K, CO, T>(CCH));
  if (e != cudaSuccess) return e;
  const int cpad = pass_pad(Cin, 0);
  const Steps steps{copy_step<T>(x, Cin), copy_step<T>(w2, Cout),
                    0, 0, Cout % 2 == 0 && aligned(y, 2 * sizeof(T))};
  conv2d_same_kernel<K, CO, T>
      <<<grid_for(B, H, W, Cout, CO), NT, smem_bytes<K, CO, T>(cpad), st>>>(
          x, w2, y, H, W, Cin, Cout, cpad, steps);
  return cudaSuccess;
}

template <int K, class T>
cudaError_t launch(const T* x, const T* w2, T* y, int B, int H, int W,
                   int Cin, int Cout, cudaStream_t st) {
  if (Cout <= 8) return launch_co<K, 8, T>(x, w2, y, B, H, W, Cin, Cout, st);
  return launch_co<K, 32, T>(x, w2, y, B, H, W, Cin, Cout, st);
}

template <class T>
int conv2d_same(const T* x, const T* w2, T* y, int B, int H, int W, int Cin,
                int Cout, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1, T>(x, w2, y, B, H, W, Cin, Cout, st); break;
    case 3: e = launch<3, T>(x, w2, y, B, H, W, Cin, Cout, st); break;
    case 5: e = launch<5, T>(x, w2, y, B, H, W, Cin, Cout, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y [B,H,W,Cout] = conv of x [B,H,W,Cin] with w2 [K*K*Cin, Cout], float32.
// Returns the error of the shared-memory attribute, or cudaGetLastError()
// after the launch.
int evf_conv2d_same(const float* x, const float* w2, float* y, int B, int H,
                    int W, int Cin, int Cout, int K, void* stream) {
  return conv2d_same<float>(x, w2, y, B, H, W, Cin, Cout, K, stream);
}

// The same in bfloat16: x, w2 and y bfloat16, the sum in float32 rounded
// once to y.
int evf_conv2d_same_bf16(const bf16* x, const bf16* w2, bf16* y, int B,
                         int H, int W, int Cin, int Cout, int K,
                         void* stream) {
  return conv2d_same<bf16>(x, w2, y, B, H, W, Cin, Cout, K, stream);
}

}  // extern "C"
