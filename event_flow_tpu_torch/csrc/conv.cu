// K1: same-padded stride-1 NHWC convolution for sm_90a, FP32 in and out,
// or bfloat16 in and out with an FP32 accumulator rounded once.
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_fwd, the Pallas
// im2col strip matmul [th*W, k*k*Cin] @ [k*k*Cin, Cout], whose bfloat16
// form (the mixed-precision policy, models/policy.py) takes bfloat16
// patches and weights, accumulates in float32 and rounds y to bfloat16
// (conv_pallas.py:82-110). Here it is an implicit GEMM on the tensor cores
// over shared-memory halo tiles staged with cp.async (mainloop in
// conv_tile.cuh: 3xTF32 for float32, m16n8k16 bf16 MMAs for bfloat16),
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
//
// K1-s8 (evf_conv2d_same_s8): the int8 variant for int8 serving. It
// replaces no Pallas kernel: JAX's stride-1 int8 conv is XLA's int8 dot
// (TPU) or conv (CPU) into int32 (event_flow_tpu/models/conv.py:93-141).
// It runs on the persistent int8 mainloop of conv_s8.cuh, shared with
// K2-s8: tiles of 256 pixels shaped by the map, a cluster of blocks
// splitting an item's input channels where the items are fewer than the
// SMs, the next tile's int8 halo in flight on an mbarrier during the
// current tile's MMAs (mma.sync m16n8k32 on the int8 tensor cores, exact
// int32 sums), the weights of the block's channel group staged once. y =
// float(sum) * scale[co] is computed in float32, each conversion and
// product rounded on its own (__int2float_rn, __fmul_rn) as JAX and the
// plain version round them; the bias stays outside, as in JAX. Its
// bfloat16 variant (evf_conv2d_same_s8_bf16, int8 serving under the
// bfloat16 policy) rounds that float32 y once to bfloat16, JAX's
// .astype(x.dtype) after the int8 conv (models/conv.py:218), and writes
// half the bytes. y goes out through shared memory as 16-byte stores:
// whole pixel rows of the channel group, or at the 2-channel heads whole
// runs of a tile row. On the path it runs the 1x1 heads (32 -> 2 at 1 x
// 180 x 240: 1.7 MB, bound by its launch, about 3 us) and the U-Net's
// heads; the activation's quantization (amax, round) runs before it as
// torch operations (ops/quant.py), which move more bytes than the conv
// (PERF.md).

#include "conv_s8.cuh"

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

// K1-s8: y = float(int32 conv of xq with wq) * scale[co], rounded once
// (__fmul_rn, so no contraction with anything after it), in float32, or
// that float32 value rounded once more to a bfloat16 y (TO = bf16); the
// persistent int8 mainloop of conv_s8.cuh
template <int K, int CO, class TO>
__global__ void __launch_bounds__(NT, 2)
    conv2d_same_s8_kernel(const __grid_constant__ s8::Params p) {
  s8::run<K, CO, TO, false>(p);
}

template <int K, int CO, class TO>
cudaError_t launch_co(const int8_t* x, const int8_t* wq, const float* scale,
                      TO* y, int B, int H, int W, int Cin, int Cout, int tw,
                      int slices, cudaStream_t st) {
  s8::Params p = {};
  p.x = x;
  p.wx = wq;
  p.scale = scale;
  p.out0 = y;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  return s8::launch<K, CO, TO, false>(conv2d_same_s8_kernel<K, CO, TO>, p,
                                      tw, slices, st);
}

// launch_co<K, CO>(args...) of either type, CO 8 where Cout <= 8, else 32
template <int K, class... A>
cudaError_t launch(int Cout, A... args) {
  if (Cout <= 8) return launch_co<K, 8>(args...);
  return launch_co<K, 32>(args...);
}

// launch<K> at the kernel size K (1, 3 or 5); the launch's error
template <class... A>
int conv2d_same(int K, int Cout, A... args) {
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1>(Cout, args...); break;
    case 3: e = launch<3>(Cout, args...); break;
    case 5: e = launch<5>(Cout, args...); break;
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
  return conv2d_same(K, Cout, x, w2, y, B, H, W, Cin, Cout,
                     static_cast<cudaStream_t>(stream));
}

// The same in bfloat16: x, w2 and y bfloat16, the sum in float32 rounded
// once to y.
int evf_conv2d_same_bf16(const bf16* x, const bf16* w2, bf16* y, int B,
                         int H, int W, int Cin, int Cout, int K,
                         void* stream) {
  return conv2d_same(K, Cout, x, w2, y, B, H, W, Cin, Cout,
                     static_cast<cudaStream_t>(stream));
}

// K1-s8: y [B,H,W,Cout] float32 = float(sum of int8 products) * scale[co]
// of xq [B,H,W,Cin] int8 and wq [Cout][K][K][Cin] int8 (OHWI), the sum in
// int32 (exact: K*K*Cin*127^2 < 2^31 for K*K*Cin < 133 000), scale
// [Cout] float32.
int evf_conv2d_same_s8(const int8_t* x, const int8_t* wq, const float* scale,
                       float* y, int B, int H, int W, int Cin, int Cout,
                       int K, int tw, int slices, void* stream) {
  return conv2d_same(K, Cout, x, wq, scale, y, B, H, W, Cin, Cout, tw,
                     slices, static_cast<cudaStream_t>(stream));
}

// The same with y bfloat16: the float32 y above rounded once to nearest
// even, JAX's int8 conv under the bfloat16 policy.
int evf_conv2d_same_s8_bf16(const int8_t* x, const int8_t* wq,
                            const float* scale, bf16* y, int B, int H, int W,
                            int Cin, int Cout, int K, int tw, int slices,
                            void* stream) {
  return conv2d_same(K, Cout, x, wq, scale, y, B, H, W, Cin, Cout, tw,
                     slices, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
