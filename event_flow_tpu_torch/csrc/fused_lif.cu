// K2: fused convolution + LIF update for sm_90a, FP32 in and out, or
// bfloat16 x, w, v, z (and z_rec, w_rec) in and bfloat16 v', z' out with
// the update in FP32.
//
// Replaces event_flow_tpu/ops/fused_lif_pallas.py::_fused_fwd, which
// applies the LIF update to the accumulator of the im2col strip matmul;
// on bfloat16 operands it accumulates in float32, does the update in
// float32 with leak and thresh kept float32, and writes bfloat16 v' and z'
// (fused_lif_pallas.py:119-141). Here the mainloop is K1's
// (conv_tile.cuh): an implicit GEMM on the tensor cores (3xTF32, or one
// exact TF32 pass on bfloat16) over halo tiles staged with cp.async. The
// recurrent cell's current conv(x, w) + conv(z_rec, w_rec) is one
// accumulator fed by two K segments (the concat trick of
// event_flow_tpu/models/snn_cells.py::_fused_current), so no current
// tensor is ever written. The LIF epilogue runs on the accumulator in the
// MMA's fragment layout and writes only v' and z':
//
//   hard reset:  v' = v*l*(1-z) + (1-l)*cur
//   soft reset:  v' = v*l + (1-l)*cur - z*th
//   z' = (v' - th > 0)          (from the float32 v', before its rounding)
//
// What bounds it on the H100: at the training recipe (8 x 128 x 128, 32
// channels, k = 3) a feedforward cell does 2.4 GFLOP (7.2 in 3xTF32,
// 4.8 and 14.5 recurrent) and must move about 84 MB (x, v, z in; v', z'
// out; 101 MB recurrent; half of each in bfloat16), which is bound by
// bytes at 3.35 TB/s. So each quad of lanes reads and writes 32 (16)
// contiguous bytes of v, z, v' and z' (element pairs per lane, whole
// sectors), the halo and weights arrive by cp.async in one pass of all
// 32 channels, and the arithmetic runs on the tensor cores.

#include "conv_tile.cuh"

namespace {

using namespace evf;

template <int K, int CO, bool HARD, bool REC, class T>
__global__ void __launch_bounds__(NT, 2) fused_conv_lif_kernel(
    const T* __restrict__ x, const T* __restrict__ w2,
    const T* __restrict__ zr, const T* __restrict__ wr2,
    const T* __restrict__ v, const T* __restrict__ z,
    const float* __restrict__ leak, const float* __restrict__ thresh,
    T* __restrict__ v_out, T* __restrict__ z_out, int H, int W, int Cin,
    int Cout, int cpad_max, Steps steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int y0, x0;
  tile_origin(W, &y0, &x0);
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO;
  float acc[MT][CO / 8][4] = {};
  accumulate<K, CO, T>(smem, acc, x, Cin, w2, Cout, b, H, W, y0, x0, co0,
                       cpad_max, steps.x, steps.w);
  if constexpr (REC)
    accumulate<K, CO, T>(smem, acc, zr, Cout, wr2, Cout, b, H, W, y0, x0,
                         co0, cpad_max, steps.r, steps.wr);
  // same expression order as the JAX cells
  auto lif = [](float vv, float zz, float l, float th, float cur, float& vn,
                float& zn) {
    vn = HARD ? vv * l * (1.f - zz) + (1.f - l) * cur
              : vv * l + (1.f - l) * cur - zz * th;
    zn = (vn - th > 0.f) ? 1.f : 0.f;
  };
  for_each_pair<CO>(
      acc, H, W, Cout, b, y0, x0, co0,
      [&](size_t i, int co, float a0, float a1) {
        if (steps.out2) {
          const float2 vv = get2(v + i);
          const float2 zz = get2(z + i);
          const float2 l = *reinterpret_cast<const float2*>(leak + co);
          const float2 th = *reinterpret_cast<const float2*>(thresh + co);
          float2 vn, zn;
          lif(vv.x, zz.x, l.x, th.x, a0, vn.x, zn.x);
          lif(vv.y, zz.y, l.y, th.y, a1, vn.y, zn.y);
          put2(v_out + i, vn.x, vn.y);
          put2(z_out + i, zn.x, zn.y);
        } else {
          float vn, zn;
          lif(widen(v[i]), widen(z[i]), leak[co], thresh[co], a0, vn, zn);
          put(v_out + i, vn);
          put(z_out + i, zn);
          if (co + 1 < Cout) {
            lif(widen(v[i + 1]), widen(z[i + 1]), leak[co + 1],
                thresh[co + 1], a1, vn, zn);
            put(v_out + i + 1, vn);
            put(z_out + i + 1, zn);
          }
        }
      });
}

template <class T>
struct Args {
  const T *x, *w2, *zr, *wr2, *v, *z;
  const float *leak, *thresh;
  T *v_out, *z_out;
  int B, H, W, Cin, Cout;
};

template <int K, int CO, bool HARD, bool REC, class T>
cudaError_t launch_inst(const Args<T>& a, cudaStream_t st) {
  auto kernel = fused_conv_lif_kernel<K, CO, HARD, REC, T>;
  const cudaError_t e = allow_smem(kernel, smem_bytes<K, CO, T>(CCH));
  if (e != cudaSuccess) return e;
  int cpad = pass_pad(a.Cin, 0);
  if (REC && pass_pad(a.Cout, 0) > cpad) cpad = pass_pad(a.Cout, 0);
  const size_t pair = 2 * sizeof(T);
  const bool out2 = a.Cout % 2 == 0 && aligned(a.v, pair) &&
                    aligned(a.z, pair) && aligned(a.leak, 8) &&
                    aligned(a.thresh, 8) && aligned(a.v_out, pair) &&
                    aligned(a.z_out, pair);
  const Steps steps{copy_step<T>(a.x, a.Cin),
                    copy_step<T>(a.w2, a.Cout),
                    REC ? copy_step<T>(a.zr, a.Cout) : 0,
                    REC ? copy_step<T>(a.wr2, a.Cout) : 0, out2};
  kernel<<<grid_for(a.B, a.H, a.W, a.Cout, CO), NT,
           smem_bytes<K, CO, T>(cpad), st>>>(
      a.x, a.w2, a.zr, a.wr2, a.v, a.z, a.leak, a.thresh, a.v_out, a.z_out,
      a.H, a.W, a.Cin, a.Cout, cpad, steps);
  return cudaSuccess;
}

template <int K, int CO, class T>
cudaError_t launch_co(const Args<T>& a, bool hard, cudaStream_t st) {
  const bool rec = a.zr != nullptr;
  if (hard)
    return rec ? launch_inst<K, CO, true, true, T>(a, st)
               : launch_inst<K, CO, true, false, T>(a, st);
  return rec ? launch_inst<K, CO, false, true, T>(a, st)
             : launch_inst<K, CO, false, false, T>(a, st);
}

template <int K, class T>
cudaError_t launch(const Args<T>& a, bool hard, cudaStream_t st) {
  if (a.Cout <= 8) return launch_co<K, 8, T>(a, hard, st);
  return launch_co<K, 32, T>(a, hard, st);
}

template <class T>
int fused_conv_lif(const Args<T>& a, int K, int hard_reset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool hard = hard_reset != 0;
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1, T>(a, hard, st); break;
    case 3: e = launch<3, T>(a, hard, st); break;
    case 5: e = launch<5, T>(a, hard, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (v_out, z_out) [B,H,W,Cout] = LIF update of (v, z) driven by
// conv(x, w2) [+ conv(zr, wr2) when zr is not null], float32. leak and
// thresh are [Cout], post-squash. Returns the error of the shared-memory
// attribute, or cudaGetLastError() after the launch.
int evf_fused_conv_lif(const float* x, const float* w2, const float* zr,
                       const float* wr2, const float* v, const float* z,
                       const float* leak, const float* thresh, float* v_out,
                       float* z_out, int B, int H, int W, int Cin, int Cout,
                       int K, int hard_reset, void* stream) {
  const Args<float> a{x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out,
                      B, H, W, Cin, Cout};
  return fused_conv_lif<float>(a, K, hard_reset, stream);
}

// The same with x, w2, zr, wr2, v, z, v_out and z_out bfloat16; leak and
// thresh float32, the update in float32.
int evf_fused_conv_lif_bf16(const bf16* x, const bf16* w2, const bf16* zr,
                            const bf16* wr2, const bf16* v, const bf16* z,
                            const float* leak, const float* thresh,
                            bf16* v_out, bf16* z_out, int B, int H, int W,
                            int Cin, int Cout, int K, int hard_reset,
                            void* stream) {
  const Args<bf16> a{x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out,
                     B, H, W, Cin, Cout};
  return fused_conv_lif<bf16>(a, K, hard_reset, stream);
}

}  // extern "C"
