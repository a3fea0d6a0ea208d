// K2: fused convolution + LIF update, FP32, for sm_90a.
//
// Replaces event_flow_tpu/ops/fused_lif_pallas.py::_fused_fwd, which
// applies the LIF update to the accumulator of the im2col strip matmul.
// Here the mainloop is K1's (conv_tile.cuh). The recurrent cell's current
// conv(x, w) + conv(z_rec, w_rec) is one accumulator fed by two K
// segments (the concat trick of event_flow_tpu/models/snn_cells.py::
// _fused_current), so no current tensor is ever written. The LIF
// epilogue runs on the accumulator in registers and writes only v' and z':
//
//   hard reset:  v' = v*l*(1-z) + (1-l)*cur
//   soft reset:  v' = v*l + (1-l)*cur - z*th
//   z' = (v' - th > 0)
//
// What bounds it on the H100: at the slice shape (1 x 180 x 240, 32
// channels, k = 3) a feedforward cell does 0.8 GFLOP (1.6 recurrent) and
// moves about 28 MB (x, v, z in; v', z' out), about 30 FLOP per byte.
// Against 67 TFLOP/s of FP32 on CUDA cores and 3.35 TB/s, that is bound
// by arithmetic. This first version reaches a small fraction of that
// roof (times in PERF.md): its grid is 1.4 waves of 2 blocks per SM and
// its inner loop makes one shared-memory float4 load per 4 FMA. Moving
// the mainloop onto tensor cores (TF32 or bf16 with wgmma) is the later
// step; the kernel then becomes bound by bytes, which is where keeping
// the current out of device memory pays.

#include "conv_tile.cuh"

namespace {

using namespace evf;

template <int K, int CO, bool HARD, bool REC>
__global__ void __launch_bounds__(NT) fused_conv_lif_kernel(
    const float* __restrict__ x, const float* __restrict__ w2,
    const float* __restrict__ zr, const float* __restrict__ wr2,
    const float* __restrict__ v, const float* __restrict__ z,
    const float* __restrict__ leak, const float* __restrict__ thresh,
    float* __restrict__ v_out, float* __restrict__ z_out, int H, int W,
    int Cin, int Cout) {
  __shared__ Tile<K, CO> s;
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  accumulate<K, CO>(s, acc, x, Cin, w2, Cout, b, H, W, y0, x0, co0);
  if constexpr (REC)
    accumulate<K, CO>(s, acc, zr, Cout, wr2, Cout, b, H, W, y0, x0, co0);
  const int gy = y0 + threadIdx.x / TW;
  const int gx = x0 + threadIdx.x % TW;
  if (gy >= H || gx >= W) return;
  const size_t base = (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const int co = co0 + o;
    if (co >= Cout) continue;
    const float vv = v[base + co];
    const float zz = z[base + co];
    const float l = leak[co];
    const float th = thresh[co];
    // same expression order as the JAX cells
    const float vn = HARD ? vv * l * (1.f - zz) + (1.f - l) * acc[o]
                          : vv * l + (1.f - l) * acc[o] - zz * th;
    v_out[base + co] = vn;
    z_out[base + co] = (vn - th > 0.f) ? 1.f : 0.f;
  }
}

template <int K, int CO, bool HARD>
void launch_co(const float* x, const float* w2, const float* zr,
               const float* wr2, const float* v, const float* z,
               const float* leak, const float* thresh, float* v_out,
               float* z_out, int B, int H, int W, int Cin, int Cout,
               cudaStream_t st) {
  const dim3 g = grid_for(B, H, W, Cout, CO);
  if (zr != nullptr)
    fused_conv_lif_kernel<K, CO, HARD, true><<<g, NT, 0, st>>>(
        x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out, H, W, Cin, Cout);
  else
    fused_conv_lif_kernel<K, CO, HARD, false><<<g, NT, 0, st>>>(
        x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out, H, W, Cin, Cout);
}

template <int K>
void launch(const float* x, const float* w2, const float* zr,
            const float* wr2, const float* v, const float* z,
            const float* leak, const float* thresh, float* v_out,
            float* z_out, int B, int H, int W, int Cin, int Cout, bool hard,
            cudaStream_t st) {
  if (Cout <= 8) {
    if (hard)
      launch_co<K, 8, true>(x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out,
                            B, H, W, Cin, Cout, st);
    else
      launch_co<K, 8, false>(x, w2, zr, wr2, v, z, leak, thresh, v_out,
                             z_out, B, H, W, Cin, Cout, st);
  } else {
    if (hard)
      launch_co<K, 32, true>(x, w2, zr, wr2, v, z, leak, thresh, v_out,
                             z_out, B, H, W, Cin, Cout, st);
    else
      launch_co<K, 32, false>(x, w2, zr, wr2, v, z, leak, thresh, v_out,
                              z_out, B, H, W, Cin, Cout, st);
  }
}

}  // namespace

extern "C" {

// (v_out, z_out) [B,H,W,Cout] = LIF update of (v, z) driven by
// conv(x, w2) [+ conv(zr, wr2) when zr is not null]. leak and thresh are
// [Cout], post-squash. Returns cudaGetLastError() after the launch.
int evf_fused_conv_lif(const float* x, const float* w2, const float* zr,
                       const float* wr2, const float* v, const float* z,
                       const float* leak, const float* thresh, float* v_out,
                       float* z_out, int B, int H, int W, int Cin, int Cout,
                       int K, int hard_reset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool hard = hard_reset != 0;
  switch (K) {
    case 1:
      launch<1>(x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out, B, H, W,
                Cin, Cout, hard, st);
      break;
    case 3:
      launch<3>(x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out, B, H, W,
                Cin, Cout, hard, st);
      break;
    case 5:
      launch<5>(x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out, B, H, W,
                Cin, Cout, hard, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
