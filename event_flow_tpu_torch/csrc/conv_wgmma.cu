// bfloat16 K1 and B2 on the warpgroup-MMA mainloop of conv_wgmma.cuh,
// where ops/conv_plan.py's plans take that route (k 3, the deep maps: 512
// input channels or more in whole 64-channel blocks, 64 output channels or
// more in whole 16-byte rows): RecEVFlowNet's and E2VID's gates, the
// spiking U-Net's 8 x 8 x 8 512-channel cells and 8 x 16 x 16 1024 -> 256
// decoder, each forward conv or dx (K1) and weight gradient (B2). They
// replace, there, the same Pallas kernels as conv.cu's K1 and conv_dw.cu's
// B2 (event_flow_tpu/ops/conv_pallas.py::_conv_fwd and ::_conv_dw); what
// bounds them and how the mainloop meets it is conv_wgmma.cuh's note.
//
// Each kernel's plan arrives as integers (tile width and images, K1's
// slices and weight stages, B2's chunks and stages); the host side here
// re-derives the layout and refuses (cudaErrorInvalidValue) a plan that
// does not fit or that TMA cannot stage, so a mismatch with the Python
// plan is loud. Where a plan splits K1's passes into slices or B2's pixels
// into chunks, the kernel writes float32 partials and a second launch
// (conv2d_same_wgmma_sum_kernel, conv_dw_wgmma_sum_kernel) adds them in
// order and rounds once.

#include "conv_wgmma.cuh"

namespace {

using namespace evf;

constexpr int SUM_THREADS = 256;

template <int K>
__global__ void __launch_bounds__(wg::K1_THREADS, 1)
    conv2d_same_wgmma_kernel(const __grid_constant__ wg::K1Params p) {
  wg::k1_run<K>(p);
}

__global__ void __launch_bounds__(SUM_THREADS)
    conv2d_same_wgmma_sum_kernel(const float* __restrict__ part,
                                 bf16* __restrict__ y, int parts,
                                 long long n) {
  wg::sum_parts(part, y, parts, n);
}

template <int K, class TO>
__global__ void __launch_bounds__(wg::DW_THREADS, 1)
    conv_dw_wgmma_kernel(const __grid_constant__ wg::DwParams p) {
  wg::dw_run<K, TO>(p);
}

__global__ void __launch_bounds__(SUM_THREADS)
    conv_dw_wgmma_sum_kernel(const float* __restrict__ part,
                             bf16* __restrict__ dw, int parts, long long n) {
  wg::sum_parts(part, dw, parts, n);
}

// the blocks of the fixed-order sum of n elements, four a thread
inline int sum_blocks(long long n) {
  const long long b = (n / 4 + SUM_THREADS - 1) / SUM_THREADS;
  return (int)(b < 32768 ? b : 32768);
}

// The launch of `kernel` on its persistent grid: the units, or as many
// blocks as the card holds at once.
template <class P>
cudaError_t launch(void (*kernel)(P), const P& p, int threads, int smem,
                   int units, cudaStream_t st) {
  int cap = 0;
  const cudaError_t e = block_capacity(
      reinterpret_cast<const void*>(kernel), threads, smem, &cap);
  if (e != cudaSuccess) return e;
  kernel<<<units < cap ? units : cap, threads, smem, st>>>(p);
  return cudaGetLastError();
}

int conv2d_same_wgmma(const bf16* x, const bf16* w, bf16* y, float* part,
                      int B, int H, int W, int Cin, int Cs, int Cout, int K,
                      int tw, int imgs, int slices, int ws,
                      cudaStream_t st) {
  wg::K1Params p = {};
  // Cin and Cout in 16-byte rows: the TMA boxes, the slices' sum by four
  if (K != 3 || B < 1 || H < 1 || W < 1 || Cin < 1 || Cin % 8 || Cs < Cin ||
      Cout < 1 || Cout % 8 || !wg::set_geo(p.g, B, H, W, tw, imgs) ||
      !aligned(y, 8) || (slices > 1 && !aligned(part, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.Cin = Cin;
  p.Cout = Cout;
  p.groups = (Cout + wg::K1_BN - 1) / wg::K1_BN;
  p.passes = (Cin + wg::CH - 1) / wg::CH;
  p.slices = slices;
  p.units = p.g.tiles * p.groups * slices;
  p.hs_bytes = wg::halo_bytes(p.g, K);
  p.ws = ws;
  p.off_w = wg::BARS + wg::HS * p.hs_bytes;
  const int smem = p.off_w + ws * wg::W_STAGE;
  if (slices < 1 || slices > p.passes || slices > wg::MAX_SLICES ||
      ws < 2 || ws > wg::MAX_STAGES || smem > MAX_SMEM ||
      (slices > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdims[4] = {(cuuint64_t)Cin * 2, (cuuint64_t)K * K,
                               (cuuint64_t)Cout, 1};
  const cuuint32_t wbox[4] = {(cuuint32_t)wg::ROW, 1, (cuuint32_t)wg::K1_BN,
                              1};
  if (!wg::encode_map(&p.map_x, x, p.g, Cin, Cs, tw + K - 1,
                      p.g.th + K - 1) ||
      !s8::encode(&p.map_w, w, 4, wdims, (cuuint64_t)Cin * 2, wbox, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  p.y = y;
  p.part = part;
  cudaError_t e = launch(conv2d_same_wgmma_kernel<3>, p, wg::K1_THREADS,
                         smem, p.units, st);
  if (e != cudaSuccess || slices == 1) return static_cast<int>(e);
  const long long n = (long long)B * H * W * Cout;
  conv2d_same_wgmma_sum_kernel<<<sum_blocks(n), SUM_THREADS, 0, st>>>(
      part, y, slices, n);
  return static_cast<int>(cudaGetLastError());
}

int conv_dw_wgmma(const bf16* x, const bf16* g, float* part, bf16* dw, int B,
                  int H, int W, int Cin, int Cs, int Cout, int K, int tw,
                  int imgs, int chunks, int ns, cudaStream_t st) {
  wg::DwParams p = {};
  // whole 16-byte runs of dw for the bulk copies: Cin a multiple of 8
  if (K != 3 || B < 1 || H < 1 || W < 1 || Cin < 1 || Cin % 8 || Cs < Cin ||
      Cout < 1 || !wg::set_geo(p.g, B, H, W, tw, imgs) || !aligned(dw, 16) ||
      (chunks > 1 && !aligned(part, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.Cin = Cin;
  p.Cout = Cout;
  p.cblocks = (Cin + wg::CH - 1) / wg::CH;
  p.coblocks = (Cout + wg::DW_BN - 1) / wg::DW_BN;
  if (chunks < 1 || chunks > p.g.tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  p.per_chunk = (p.g.tiles + chunks - 1) / chunks;
  p.chunks = chunks;
  p.items = chunks * p.cblocks * p.coblocks;
  p.halo_bytes = wg::halo_bytes(p.g, K);
  p.stage_bytes = p.halo_bytes + wg::G_STAGE;
  p.ns = ns;
  p.off_out = wg::BARS + ns * p.stage_bytes;
  const int smem = p.off_out + wg::OUT_BYTES;
  if ((p.g.tiles + p.per_chunk - 1) / p.per_chunk != chunks || ns < 2 ||
      ns > wg::MAX_STAGES || smem > MAX_SMEM ||
      (chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!wg::encode_map(&p.map_x, x, p.g, Cin, Cs, tw + K - 1,
                      p.g.th + K - 1) ||
      !wg::encode_map(&p.map_g, g, p.g, Cout, Cout, tw, p.g.th))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (chunks == 1) {
    p.dst = dw;
    return static_cast<int>(launch(conv_dw_wgmma_kernel<3, bf16>, p,
                                   wg::DW_THREADS, smem, p.items, st));
  }
  p.dst = part;
  e = launch(conv_dw_wgmma_kernel<3, float>, p, wg::DW_THREADS, smem,
             p.items, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)Cout * Cin * K * K;
  conv_dw_wgmma_sum_kernel<<<sum_blocks(n), SUM_THREADS, 0, st>>>(part, dw,
                                                                  chunks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y [B,H,W,Cout] bfloat16 = the conv of x [B,H,W,Cin] bfloat16 (its pixels
// Cs >= Cin elements apart) with w [Cout][K][K][Cin] bfloat16 (OHWI) on
// the wgmma route of ops/conv_plan.py::k1_plan (tile width tw, imgs images
// a tile, slices of the 64-channel passes, ws weight stages); part is a
// float32 [slices, B*H*W*Cout] scratch where slices > 1. Returns the first
// CUDA error of the setup or the launches, or 0.
int evf_conv2d_same_wgmma_bf16(const bf16* x, const bf16* w, bf16* y,
                               float* part, int B, int H, int W, int Cin,
                               int Cs, int Cout, int K, int tw, int imgs,
                               int slices, int ws, void* stream) {
  return conv2d_same_wgmma(x, w, y, part, B, H, W, Cin, Cs, Cout, K, tw,
                           imgs, slices, ws,
                           static_cast<cudaStream_t>(stream));
}

// dw [Cout, Cin, K, K] bfloat16 (OIHW) = the weight gradient of x
// [B,H,W,Cin] (pixels Cs >= Cin apart) and g [B,H,W,Cout], bfloat16, on
// the wgmma route of ops/conv_plan.py::b2_plan (pixel tile width tw, imgs
// images a tile, chunks of the pixel tiles, ns ring stages); part is a
// float32 [chunks, Cout*Cin*K*K] scratch where chunks > 1.
int evf_conv_dw_wgmma_bf16(const bf16* x, const bf16* g, float* part,
                           bf16* dw, int B, int H, int W, int Cin, int Cs,
                           int Cout, int K, int tw, int imgs, int chunks,
                           int ns, void* stream) {
  return conv_dw_wgmma(x, g, part, dw, B, H, W, Cin, Cs, Cout, K, tw, imgs,
                       chunks, ns, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
