// K2: fused convolution + LIF update for sm_90a, FP32 in and out, or
// bfloat16 x, w, v, z (and z_rec, w_rec) in and bfloat16 v', z' out with
// the update in FP32.
//
// Replaces event_flow_tpu/ops/fused_lif_pallas.py::_fused_fwd, which
// applies the LIF update to the accumulator of the im2col strip matmul;
// on bfloat16 operands it accumulates in float32, does the update in
// float32 with leak and thresh kept float32, and writes bfloat16 v' and z'
// (fused_lif_pallas.py:119-141). Here the mainloop is the one-process
// mainloop of conv_tile.cuh: an implicit GEMM on the tensor cores (3xTF32,
// or m16n8k16 bf16 MMAs on bfloat16) over halo tiles staged with cp.async.
// The recurrent cell's current conv(x, w) + conv(z_rec, w_rec) is one
// accumulator fed by two K segments (the concat trick of
// event_flow_tpu/models/snn_cells.py::_fused_current), so no current
// tensor is ever written. The recurrent segment reads z_rec with its own
// channel count Crec: Cout on one process, every channel of the cell
// where a mesh's model axis splits Cout (JAX's GSPMD gathers z for the
// recurrent conv there, event_flow_tpu/parallel/mesh.py:45-58); that
// route, Crec != Cout, runs on the persistent float mainloop of
// conv_ring.cuh (fused_lif_ring.cu), whose next pass loads by TMA during
// the current pass's MMAs, and is bitwise the one-process cell's channels.
// The LIF epilogue runs on the accumulator in the MMA's fragment layout
// and writes only v' and z':
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
//
// K2-s8 (evf_fused_conv_lif_s8): the int8 variant for int8 serving,
// JAX's XLA cell route under set_conv_quant("int8") (an int8 conv, then
// the update in float32; no Pallas kernel: models/conv.py:93-141,
// snn_cells.py:99-107). The recurrent segment adds into the one int32
// accumulator, which is JAX's int8 conv over concat([x, z]) under one
// activation scale. State and update stay float32, every operation of the
// update rounded on its own in the plain version's order, so v' and z'
// are bitwise the plain version's. Bound by bytes: at 1 x 180 x 240 x 32
// a cell moves 23.5 MB (int8 x; v, z in and v', z' out in float32), 7.0
// us at 3.35 TB/s, against 27.6 MB for the float32 K2; the activation's
// quantization before it (ops/quant.py) reads the float32 x twice more.
// It runs on the persistent int8 mainloop of conv_s8.cuh (shared with
// K1-s8), which is built for those bytes: each block walks a run of
// output tiles with the next tile's int8 halo and its v and z tiles
// loading into a shared-memory ring on mbarriers while the current tile
// multiplies and updates; the weights, scale, leak and threshold of the
// block's channel group are staged once; the update reads v and z from
// shared memory and writes v' and z' back there, and whole pixel rows go
// out as 16-byte stores; at the deep, small maps (512 -> 512 on 12 x 15)
// a cluster of blocks splits each tile's input channels and adds its
// int32 sums in distributed shared memory, so the map fills the SMs.
//
// K2-s8 bf16 (evf_fused_conv_lif_s8_bf16): int8 serving under the bfloat16
// policy, where JAX's cells run XLA's bfloat16 chain (snn_cells.py:59-64,
// :181-206), not the Pallas kernel's float32 update: the current is the
// float32 int8 current rounded to bfloat16 (conv.py:218), leak and thresh
// are rounded to bfloat16 (_like), and each multiply, add and subtract of
// the update is done in float32 (__fmul_rn, __fadd_rn, __fsub_rn: no FMA
// contraction) and rounded to bfloat16 before the next, as XLA's CPU code
// and torch's bfloat16 operations do; v, z, v' and z' are bfloat16, so
// the state moves half the bytes. v' and z' are bitwise the plain form's.

#include "conv_ring.cuh"
#include "conv_s8.cuh"

namespace {

using namespace evf;

template <int K, int CO, bool HARD, bool REC, class T>
__global__ void __launch_bounds__(NT, 2) fused_conv_lif_kernel(
    const T* __restrict__ x, const T* __restrict__ w2,
    const T* __restrict__ zr, const T* __restrict__ wr2,
    const T* __restrict__ v, const T* __restrict__ z,
    const float* __restrict__ leak, const float* __restrict__ thresh,
    T* __restrict__ v_out, T* __restrict__ z_out, int H, int W, int Cin,
    int Cout, int Crec, int cpad_max, Steps steps) {
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
    accumulate<K, CO, T>(smem, acc, zr, Crec, wr2, Cout, b, H, W, y0, x0,
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
  int B, H, W, Cin, Cout, Crec;
};

template <int K, int CO, bool HARD, bool REC, class T>
cudaError_t launch_inst(const Args<T>& a, cudaStream_t st) {
  auto kernel = fused_conv_lif_kernel<K, CO, HARD, REC, T>;
  const cudaError_t e = allow_smem(kernel, smem_bytes<K, CO, T>(CCH));
  if (e != cudaSuccess) return e;
  int cpad = pass_pad(a.Cin, 0);
  if (REC && pass_pad(a.Crec, 0) > cpad) cpad = pass_pad(a.Crec, 0);
  const size_t pair = 2 * sizeof(T);
  const bool out2 = a.Cout % 2 == 0 && aligned(a.v, pair) &&
                    aligned(a.z, pair) && aligned(a.leak, 8) &&
                    aligned(a.thresh, 8) && aligned(a.v_out, pair) &&
                    aligned(a.z_out, pair);
  const Steps steps{copy_step<T>(a.x, a.Cin),
                    copy_step<T>(a.w2, a.Cout),
                    REC ? copy_step<T>(a.zr, a.Crec) : 0,
                    REC ? copy_step<T>(a.wr2, a.Cout) : 0, out2};
  kernel<<<grid_for(a.B, a.H, a.W, a.Cout, CO), NT,
           smem_bytes<K, CO, T>(cpad), st>>>(
      a.x, a.w2, a.zr, a.wr2, a.v, a.z, a.leak, a.thresh, a.v_out, a.z_out,
      a.H, a.W, a.Cin, a.Cout, a.Crec, cpad, steps);
  return cudaSuccess;
}

// K2-s8: the LIF update of K2 driven by the int8 current
// cur = float(int32 conv of xq with wq [+ zq with wrq]) * scale[co], the
// recurrent segment summed into the same int32 accumulator (JAX's one
// int8 conv over concat([x, z]) under one activation scale, whose sum is
// the same integer); v, z, v', z' float32, or (T = bf16) bfloat16 with
// every value of the update rounded to bfloat16; the persistent int8
// mainloop and LIF epilogue of conv_s8.cuh
template <int K, int CO, class T>
__global__ void __launch_bounds__(NT, 2)
    fused_conv_lif_s8_kernel(const __grid_constant__ s8::Params p) {
  s8::run<K, CO, T, true>(p);
}

template <class T>
struct ArgsS8 {
  const int8_t *x, *wq, *zr, *wrq;
  const float* scale;
  const T *v, *z;
  const float *leak, *thresh;
  T *v_out, *z_out;
  int B, H, W, Cin, Cout, tw, slices;
};

// K2-s8 at K and CO; the reset and the recurrent segment are run-time
// values of the one kernel
template <int K, int CO, class T>
cudaError_t launch_co(const ArgsS8<T>& a, bool hard, cudaStream_t st) {
  s8::Params p = {};
  p.x = a.x;
  p.wx = a.wq;
  p.zr = a.zr;
  p.wr = a.wrq;
  p.scale = a.scale;
  p.leak = a.leak;
  p.thresh = a.thresh;
  p.v = a.v;
  p.z = a.z;
  p.out0 = a.v_out;
  p.out1 = a.z_out;
  p.B = a.B;
  p.H = a.H;
  p.W = a.W;
  p.Cin = a.Cin;
  p.Crec = a.zr ? a.Cout : 0;
  p.Cout = a.Cout;
  p.hard = hard;
  return s8::launch<K, CO, T, true>(fused_conv_lif_s8_kernel<K, CO, T>, p,
                                    a.tw, a.slices, st);
}

// K2's launch_inst at K, CO, the reset and whether recurrent
template <int K, int CO, class T>
cudaError_t launch_co(const Args<T>& a, bool hard, cudaStream_t st) {
  const bool rec = a.zr != nullptr;
  if (hard)
    return rec ? launch_inst<K, CO, true, true>(a, st)
               : launch_inst<K, CO, true, false>(a, st);
  return rec ? launch_inst<K, CO, false, true>(a, st)
             : launch_inst<K, CO, false, false>(a, st);
}

// launch_co of the arguments' kind (Args<T> or ArgsS8<T>) at K and the CO
// of Cout (8 where Cout <= 8, else 32)
template <int K, class A>
cudaError_t launch(const A& a, bool hard, cudaStream_t st) {
  if (a.Cout <= 8) return launch_co<K, 8>(a, hard, st);
  return launch_co<K, 32>(a, hard, st);
}

// K2 rec with Crec != Cout (a rank's share of a cell under a mesh's model
// axis) on conv_ring.cuh's mainloop; K2-s8's recurrent input is always its
// own Cout channels
template <class T>
ring::Call ring_call(const Args<T>& a, int K, bool hard) {
  return {a.x,      a.w2,    a.zr,  a.wr2, a.v,    a.z,    a.leak,
          a.thresh, a.v_out, a.z_out, a.B, a.H,    a.W,    a.Cin,
          a.Cout,   a.Crec,  K,     hard};
}
template <class T>
bool on_ring(const Args<T>& a) {
  return a.zr != nullptr && a.Crec != a.Cout;
}
template <class T>
bool on_ring(const ArgsS8<T>&) {
  return false;
}
inline cudaError_t launch_ring(const Args<float>& a, int K, bool hard,
                               cudaStream_t st) {
  return ring::launch_f32(ring_call(a, K, hard), st);
}
inline cudaError_t launch_ring(const Args<bf16>& a, int K, bool hard,
                               cudaStream_t st) {
  return ring::launch_bf16(ring_call(a, K, hard), st);
}
template <class T>
cudaError_t launch_ring(const ArgsS8<T>&, int, bool, cudaStream_t) {
  return cudaErrorInvalidValue;
}

template <class A>
int fused_conv_lif(const A& a, int K, int hard_reset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool hard = hard_reset != 0;
  cudaError_t e;
  if (on_ring(a)) {
    e = launch_ring(a, K, hard, st);
  } else {
    switch (K) {
      case 1: e = launch<1>(a, hard, st); break;
      case 3: e = launch<3>(a, hard, st); break;
      case 5: e = launch<5>(a, hard, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (v_out, z_out) [B,H,W,Cout] = LIF update of (v, z) driven by
// conv(x [B,H,W,Cin], w2 [K*K*Cin, Cout]) [+ conv(zr [B,H,W,Crec], wr2
// [K*K*Crec, Cout]) when zr is not null], float32. leak and thresh are
// [Cout], post-squash. Crec is Cout for a recurrent cell on one process;
// under the model axis of a mesh zr is the spike map of every channel
// and Cout this process's share. Returns the error of the shared-memory
// attribute, or cudaGetLastError() after the launch.
int evf_fused_conv_lif(const float* x, const float* w2, const float* zr,
                       const float* wr2, const float* v, const float* z,
                       const float* leak, const float* thresh, float* v_out,
                       float* z_out, int B, int H, int W, int Cin, int Cout,
                       int Crec, int K, int hard_reset, void* stream) {
  const Args<float> a{x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out,
                      B, H, W, Cin, Cout, Crec};
  return fused_conv_lif(a, K, hard_reset, stream);
}

// The same with x, w2, zr, wr2, v, z, v_out and z_out bfloat16; leak and
// thresh float32, the update in float32.
int evf_fused_conv_lif_bf16(const bf16* x, const bf16* w2, const bf16* zr,
                            const bf16* wr2, const bf16* v, const bf16* z,
                            const float* leak, const float* thresh,
                            bf16* v_out, bf16* z_out, int B, int H, int W,
                            int Cin, int Cout, int Crec, int K,
                            int hard_reset, void* stream) {
  const Args<bf16> a{x, w2, zr, wr2, v, z, leak, thresh, v_out, z_out,
                     B, H, W, Cin, Cout, Crec};
  return fused_conv_lif(a, K, hard_reset, stream);
}

// K2-s8: (v_out, z_out) [B,H,W,Cout] float32 = LIF update of (v, z)
// driven by float(int32 conv of xq [B,H,W,Cin] with wq [Cout][K][K][Cin]
// [+ zq [B,H,W,Cout] with wrq [Cout][K][K][Cout] when zq is not null]) *
// scale[co]; xq, wq, zq, wrq int8, scale, v, z, leak and thresh float32.
int evf_fused_conv_lif_s8(const int8_t* x, const int8_t* wq,
                          const int8_t* zr, const int8_t* wrq,
                          const float* scale, const float* v, const float* z,
                          const float* leak, const float* thresh,
                          float* v_out, float* z_out, int B, int H, int W,
                          int Cin, int Cout, int K, int hard_reset, int tw,
                          int slices, void* stream) {
  const ArgsS8<float> a{x,    wq,     zr,    wrq,   scale, v, z, leak,
                        thresh, v_out, z_out, B, H, W, Cin, Cout, tw,
                        slices};
  return fused_conv_lif(a, K, hard_reset, stream);
}

// The same with v, z, v_out and z_out bfloat16 and the update in
// bfloat16, each operation rounded on its own (leak and thresh float32,
// rounded to bfloat16 first).
int evf_fused_conv_lif_s8_bf16(const int8_t* x, const int8_t* wq,
                               const int8_t* zr, const int8_t* wrq,
                               const float* scale, const bf16* v,
                               const bf16* z, const float* leak,
                               const float* thresh, bf16* v_out,
                               bf16* z_out, int B, int H, int W, int Cin,
                               int Cout, int K, int hard_reset, int tw,
                               int slices, void* stream) {
  const ArgsS8<bf16> a{x,    wq,     zr,    wrq,   scale, v, z, leak,
                       thresh, v_out, z_out, B, H, W, Cin, Cout, tw,
                       slices};
  return fused_conv_lif(a, K, hard_reset, stream);
}

}  // extern "C"
