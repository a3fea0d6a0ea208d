// K2: fused convolution + LIF update, FP32 in and out, for sm_90a.
//
// Replaces event_flow_tpu/ops/fused_lif_pallas.py::_fused_fwd, which
// applies the LIF update to the accumulator of the im2col strip matmul.
// Here the mainloop is K1's (conv_tile.cuh): an implicit GEMM on the
// tensor cores in 3xTF32 over halo tiles staged with cp.async. The
// recurrent cell's current conv(x, w) + conv(z_rec, w_rec) is one
// accumulator fed by two K segments (the concat trick of
// event_flow_tpu/models/snn_cells.py::_fused_current), so no current
// tensor is ever written. The LIF epilogue runs on the accumulator in the
// MMA's fragment layout and writes only v' and z':
//
//   hard reset:  v' = v*l*(1-z) + (1-l)*cur
//   soft reset:  v' = v*l + (1-l)*cur - z*th
//   z' = (v' - th > 0)
//
// What bounds it on the H100: at the training recipe (8 x 128 x 128, 32
// channels, k = 3) a feedforward cell does 2.4 GFLOP (7.2 in 3xTF32,
// 4.8 and 14.5 recurrent) and must move about 84 MB (x, v, z in; v', z'
// out; 101 MB recurrent), which is bound by bytes at 3.35 TB/s. So each
// quad of lanes reads and writes 32 contiguous bytes of v, z, v' and z'
// (float2 per lane, whole sectors), the halo and weights arrive by
// cp.async in one pass of all 32 channels, and the arithmetic runs on the
// tensor cores.

#include "conv_tile.cuh"

namespace {

using namespace evf;

template <int K, int CO, bool HARD, bool REC>
__global__ void __launch_bounds__(NT, 2) fused_conv_lif_kernel(
    const float* __restrict__ x, const float* __restrict__ w2,
    const float* __restrict__ zr, const float* __restrict__ wr2,
    const float* __restrict__ v, const float* __restrict__ z,
    const float* __restrict__ leak, const float* __restrict__ thresh,
    float* __restrict__ v_out, float* __restrict__ z_out, int H, int W,
    int Cin, int Cout, int cpad_max, int flags) {
  extern __shared__ __align__(16) float smem[];
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[MT][CO / 8][4] = {};
  accumulate<K, CO>(smem, acc, x, Cin, w2, Cout, b, H, W, y0, x0, co0,
                    cpad_max, flags & kVecX, flags & kVecW);
  if constexpr (REC)
    accumulate<K, CO>(smem, acc, zr, Cout, wr2, Cout, b, H, W, y0, x0, co0,
                      cpad_max, flags & kVecR, flags & kVecWR);
  // same expression order as the JAX cells
  auto lif = [](float vv, float zz, float l, float th, float cur, float& vn,
                float& zn) {
    vn = HARD ? vv * l * (1.f - zz) + (1.f - l) * cur
              : vv * l + (1.f - l) * cur - zz * th;
    zn = (vn - th > 0.f) ? 1.f : 0.f;
  };
  const bool vec2 = flags & kVec2;
  for_each_pair<CO>(
      acc, H, W, Cout, b, y0, x0, co0,
      [&](size_t i, int co, float a0, float a1) {
        if (vec2) {
          const float2 vv = *reinterpret_cast<const float2*>(v + i);
          const float2 zz = *reinterpret_cast<const float2*>(z + i);
          const float2 l = *reinterpret_cast<const float2*>(leak + co);
          const float2 th = *reinterpret_cast<const float2*>(thresh + co);
          float2 vn, zn;
          lif(vv.x, zz.x, l.x, th.x, a0, vn.x, zn.x);
          lif(vv.y, zz.y, l.y, th.y, a1, vn.y, zn.y);
          *reinterpret_cast<float2*>(v_out + i) = vn;
          *reinterpret_cast<float2*>(z_out + i) = zn;
        } else {
          float vn, zn;
          lif(v[i], z[i], leak[co], thresh[co], a0, vn, zn);
          v_out[i] = vn;
          z_out[i] = zn;
          if (co + 1 < Cout) {
            lif(v[i + 1], z[i + 1], leak[co + 1], thresh[co + 1], a1, vn,
                zn);
            v_out[i + 1] = vn;
            z_out[i + 1] = zn;
          }
        }
      });
}

struct Args {
  const float *x, *w2, *zr, *wr2, *v, *z, *leak, *thresh;
  float *v_out, *z_out;
  int B, H, W, Cin, Cout;
};

template <int K, int CO, bool HARD, bool REC>
cudaError_t launch_inst(const Args& a, cudaStream_t st) {
  auto kernel = fused_conv_lif_kernel<K, CO, HARD, REC>;
  const cudaError_t e = allow_smem(kernel, smem_bytes<K, CO>(CCH));
  if (e != cudaSuccess) return e;
  int cpad = pass_pad(a.Cin, 0);
  if (REC && pass_pad(a.Cout, 0) > cpad) cpad = pass_pad(a.Cout, 0);
  const bool out2 = a.Cout % 2 == 0 && aligned(a.v, 8) && aligned(a.z, 8) &&
                    aligned(a.leak, 8) && aligned(a.thresh, 8) &&
                    aligned(a.v_out, 8) && aligned(a.z_out, 8);
  const bool w4 = a.Cout % 4 == 0;
  const int flags = (a.Cin % 4 == 0 && aligned(a.x, 16) ? kVecX : 0) |
                    (w4 && aligned(a.w2, 16) ? kVecW : 0) |
                    (REC && w4 && aligned(a.zr, 16) ? kVecR : 0) |
                    (REC && w4 && aligned(a.wr2, 16) ? kVecWR : 0) |
                    (out2 ? kVec2 : 0);
  kernel<<<grid_for(a.B, a.H, a.W, a.Cout, CO), NT, smem_bytes<K, CO>(cpad),
           st>>>(a.x, a.w2, a.zr, a.wr2, a.v, a.z, a.leak, a.thresh,
                 a.v_out, a.z_out, a.H, a.W, a.Cin, a.Cout, cpad, flags);
  return cudaSuccess;
}

template <int K, int CO>
cudaError_t launch_co(const Args& a, bool hard, cudaStream_t st) {
  const bool rec = a.zr != nullptr;
  if (hard)
    return rec ? launch_inst<K, CO, true, true>(a, st)
               : launch_inst<K, CO, true, false>(a, st);
  return rec ? launch_inst<K, CO, false, true>(a, st)
             : launch_inst<K, CO, false, false>(a, st);
}

template <int K>
cudaError_t launch(const Args& a, bool hard, cudaStream_t st) {
  if (a.Cout <= 8) return launch_co<K, 8>(a, hard, st);
  return launch_co<K, 32>(a, hard, st);
}

}  // namespace

extern "C" {

// (v_out, z_out) [B,H,W,Cout] = LIF update of (v, z) driven by
// conv(x, w2) [+ conv(zr, wr2) when zr is not null]. leak and thresh are
// [Cout], post-squash. Returns the error of the shared-memory attribute,
// or cudaGetLastError() after the launch.
int evf_fused_conv_lif(const float* x, const float* w2, const float* zr,
                       const float* wr2, const float* v, const float* z,
                       const float* leak, const float* thresh, float* v_out,
                       float* z_out, int B, int H, int W, int Cin, int Cout,
                       int K, int hard_reset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out,
               B, H, W, Cin, Cout};
  const bool hard = hard_reset != 0;
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1>(a, hard, st); break;
    case 3: e = launch<3>(a, hard, st); break;
    case 5: e = launch<5>(a, hard, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
