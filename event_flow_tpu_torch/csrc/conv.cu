// K1: same-padded stride-1 NHWC convolution for sm_90a, FP32 in and out,
// or bfloat16 in and out with an FP32 accumulator rounded once.
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_fwd, the Pallas
// im2col strip matmul [th*W, k*k*Cin] @ [k*k*Cin, Cout], whose bfloat16
// form (the mixed-precision policy, models/policy.py) takes bfloat16
// patches and weights, accumulates in float32 and rounds y to bfloat16
// (conv_pallas.py:82-110); the same kernel runs dx in _cp_bwd. Here it is
// an implicit GEMM on the tensor cores on the persistent float mainloop
// of conv_ring.cuh (3xTF32 for float32, m16n8k16 bf16 MMAs for bfloat16),
// shared with K2 rec under the model axis: tiles of 256 pixels that span
// images where the maps are small, the next pass's halo in flight by TMA
// on an mbarrier ring during the current pass's MMAs, the weights of a
// block's channel group staged once where they fit, each float32 value
// split into TF32 hi and lo once, a cluster splitting K at serving's deep
// maps whose items cannot fill the card; no im2col matrix anywhere, and y
// written from the MMA fragments as element pairs. The tiles, channel
// groups, split and ring come from ops/conv_plan.py::k1_plan, which keeps
// the one-process mainloop's one-image tile (conv2d_same_tile_kernel)
// where the ring measured slower: maps whose pixel stride is not a whole
// 16-byte row, the shallow 1 x 1 heads and float32 calls of many passes
// whose one-image tiles fill the card. x's pixels may lie Cs >= Cin
// elements apart: the U-Net decoders' inputs come as views of a buffer
// padded to whole 16-byte rows (ops/resize.py), which TMA stages.
//
// What bounds it on the H100: at the LIFFireNet dx (8 x 128 x 128, 32 ->
// 32, k 3) a call moves about 34 MB (17 MB in bfloat16) for 2.4 GFLOP
// (7.2 in 3xTF32): bytes, 10.0 us at 3.35 TB/s. At RecEVFlowNet's ConvGRU
// gates (1024 -> 1024 on 8 x 8 x 8) the operations: 9.66 GFLOP, 19.5 us at
// the TF32 peak (three times that in 3xTF32, which mma.sync's rate and
// the shared-memory reads of its fragments set); there the one-process
// mainloop's 8 x 32 tiles of one image held 64 pixels in 256, so four
// images now share a tile. At serving's 1 x 12 x 15 the weights (37.7 MB,
// 11.3 us) and the few tiles: groups of 8 channels and a split of K over a
// cluster give the card its items.
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

#include <numeric>

#include "conv_ring.cuh"
#include "conv_s8.cuh"

namespace {

using namespace evf;

// K1 on the persistent float mainloop: conv_ring.cuh's walk with the
// store epilogue; two blocks an SM in bfloat16 and at k 1 (the heads and
// their dx, whose small items want the occupancy), one in float32 at k 3
// and 5, whose planes take most of an SM's shared memory anyway
template <int K, int CO, class T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 || K == 1 ? 2 : 1)
    conv2d_same_kernel(const __grid_constant__ ring::Params p) {
  ring::run<K, CO, false, T, false>(p);
}

// K1 on the one-process mainloop of conv_tile.cuh (K2's): one block per
// 8 x 32 tile of one image and CO output channels, each pass staged by
// cp.async, then multiplied. The plan takes it (ns 0) where the ring
// loses: maps whose pixel stride is not a whole 16-byte row (the heads'
// dx from 2, a decoder input that was not padded), which TMA cannot stage
// and the ring's thread copies staged more slowly; float32 training's
// padded decoder maps of 258 and 130 channels, whose tiles fill the card
// two blocks an SM; and the 1 x 1 heads of 64 input channels or fewer,
// one or two passes a tile behind the ring's fixed costs. Same sum order
// as the ring's, so the same bits.
template <int K, int CO, class T>
__global__ void __launch_bounds__(NT, 2)
    conv2d_same_tile_kernel(const T* __restrict__ x,
                            const T* __restrict__ w2, T* __restrict__ y,
                            int H, int W, int Cin, int Xs, int Cout,
                            int cpad_max, Steps steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[MT][CO / 8][4] = {};
  accumulate<K, CO, T>(smem, acc, x, Cin, Xs, w2, Cout, b, H, W, y0, x0,
                       co0, cpad_max, steps.x, steps.w);
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
cudaError_t launch_tile(const ring::ConvCall& c, cudaStream_t st) {
  const int cpad = pass_pad(c.Cin, 0);
  const size_t smem = smem_bytes<K, CO, T>(cpad);
  const cudaError_t e = allow_smem(conv2d_same_tile_kernel<K, CO, T>, smem);
  if (e != cudaSuccess) return e;
  const T* x = static_cast<const T*>(c.x);
  const T* w2 = static_cast<const T*>(c.w2);
  T* y = static_cast<T*>(c.y);
  const Steps steps{copy_step<T>(x, std::gcd(c.Cin, c.Cs)),
                    copy_step<T>(w2, c.Cout), 0, 0,
                    c.Cout % 2 == 0 && aligned(y, 2 * sizeof(T))};
  conv2d_same_tile_kernel<K, CO, T>
      <<<grid_for(c.B, c.H, c.W, c.Cout, CO), NT, smem, st>>>(
          x, w2, y, c.H, c.W, c.Cin, c.Cs, c.Cout, cpad, steps);
  return cudaSuccess;
}

// K1 at K in the call's channel group (8, 16 or 32), on the ring, or on
// the one-image tile where the plan has no ring stages (groups of 8 where
// Cout <= 8, else 32)
template <int K, class T>
cudaError_t launch_k1(const ring::ConvCall& c, cudaStream_t st) {
  if (c.Cs < c.Cin) return cudaErrorInvalidValue;
  if (c.ns == 0)
    return c.co == 8 ? launch_tile<K, 8, T>(c, st)
                     : c.co == 32 ? launch_tile<K, 32, T>(c, st)
                                  : cudaErrorInvalidValue;
  switch (c.co) {
    case 8:
      return ring::launch_conv<K, 8, T>(conv2d_same_kernel<K, 8, T>, c, st);
    case 16:
      return ring::launch_conv<K, 16, T>(conv2d_same_kernel<K, 16, T>, c,
                                         st);
    case 32:
      return ring::launch_conv<K, 32, T>(conv2d_same_kernel<K, 32, T>, c,
                                         st);
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
int conv2d_same_float(const ring::ConvCall& c, cudaStream_t st) {
  cudaError_t e;
  switch (c.K) {
    case 1: e = launch_k1<1, T>(c, st); break;
    case 3: e = launch_k1<3, T>(c, st); break;
    case 5: e = launch_k1<5, T>(c, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

// y [B,H,W,Cout] = conv of x [B,H,W,Cin] with w2 [K*K*Cin, Cout], float32,
// x's pixels Cs >= Cin elements apart (its rows and images packed over
// them: a channel-padded map) and y contiguous, on the plan of
// ops/conv_plan.py::k1_plan (tile width tw, imgs images a tile, channel
// groups of co, slices blocks a cluster, ns ring stages or 0 for the
// one-image tile, weights resident or not). Returns the error of the
// launch's setup, or cudaGetLastError() after the launch.
int evf_conv2d_same(const float* x, const float* w2, float* y, int B, int H,
                    int W, int Cin, int Cs, int Cout, int K, int tw,
                    int imgs, int co, int slices, int ns, int resident,
                    void* stream) {
  const ring::ConvCall c{x, w2, y,  B,    H,  W,      Cin, Cs,
                         Cout, K, tw, imgs, co, slices, ns, resident};
  return conv2d_same_float<float>(c, static_cast<cudaStream_t>(stream));
}

// The same in bfloat16: x, w2 and y bfloat16, the sum in float32 rounded
// once to y.
int evf_conv2d_same_bf16(const bf16* x, const bf16* w2, bf16* y, int B,
                         int H, int W, int Cin, int Cs, int Cout, int K,
                         int tw, int imgs, int co, int slices, int ns,
                         int resident, void* stream) {
  const ring::ConvCall c{x, w2, y,  B,    H,  W,      Cin, Cs,
                         Cout, K, tw, imgs, co, slices, ns, resident};
  return conv2d_same_float<bf16>(c, static_cast<cudaStream_t>(stream));
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
