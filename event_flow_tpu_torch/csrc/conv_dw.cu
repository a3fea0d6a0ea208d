// B2: weight gradient of the same-padded stride-1 NHWC convolution, FP32,
// for sm_90a.
//
//   dw2[(dy*K + dx)*Cin + ci, co] = sum_{b,i,j} x[b, i+dy-p, j+dx-p, ci]
//                                               * g[b, i, j, co]
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_dw (_dw_kernel), which
// builds the im2col matrix of x in device memory and carries the sum over
// M = B*H*W pixels from one grid step to the next in M-chunks of 4096. On
// the H100 blocks run in no order and nothing carries between them, so the
// sum over M is split: each block owns a chunk of TILES_PER_CHUNK output
// tiles of 8 x 32 pixels, stages for each tile the x tile with its (K-1)
// halo (CI = 8 input channels per block, zero outside the image) and the
// matching g tile (up to CO output channels) in static shared memory, and
// keeps its partial [K*K*CI, CO] sum in registers. The partials go to a
// [chunks, K*K*Cin, Cout] scratch; a second launch sums them over the
// chunks in a fixed order and a fixed tree. No float atomics: the result
// is bitwise the same from run to run, as the Pallas kernel's is.
//
// What bounds it: at the training recipe (8 x 128 x 128, 32 -> 32, k = 3)
// one dw is 2.4 GFLOP against about 34 MB read, so in FP32 on CUDA cores
// it is bound by arithmetic; the inner loop does about one shared-memory
// load per FMA (the x value is a broadcast across the warp, the g value is
// reused for the thread's K*K*CI*CO/256 accumulators), which caps it at a
// fraction of the FP32 peak. Tensor cores are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 8;        // tile rows
constexpr int TW = 32;       // tile columns
constexpr int NT = TH * TW;  // threads per block = pixels per tile
constexpr int CI = 8;        // input channels per block
constexpr int TILES_PER_CHUNK = 4;

template <int K, int CO>
struct __align__(16) DwTile {
  float in[CI][TH + K - 1][TW + K - 1];  // x tile with halo, channel-major
  float g[NT][CO];                       // g tile, pixel-major
};

// grid: (chunks, ceil(Cin / CI), ceil(Cout / CO))
template <int K, int CO>
__global__ void __launch_bounds__(NT)
    conv_dw_partial_kernel(const float* __restrict__ x,
                           const float* __restrict__ g,
                           float* __restrict__ part, int B, int H, int W,
                           int Cin, int Cout) {
  constexpr int P = K / 2;
  constexpr int SH = TH + K - 1;
  constexpr int SW = TW + K - 1;
  constexpr int R = K * K * CI;                   // rows of the block's sum
  constexpr int NQ = (R * CO + NT - 1) / NT;      // accumulators per thread
  constexpr int RSTEP = NT / CO;                  // row stride between them
  __shared__ DwTile<K, CO> s;

  const int tid = threadIdx.x;
  const int ci0 = blockIdx.y * CI;
  const int co0 = blockIdx.z * CO;
  const int o = tid % CO;  // this thread's output channel within the group

  // shared-memory offset of each accumulator's (dy, dx, ci) tap
  int off[NQ];
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = tid / CO + q * RSTEP;
    const int ci = r % CI;
    const int t = r / CI;
    off[q] = (r < R) ? (ci * SH + t / K) * SW + t % K : 0;
    acc[q] = 0.f;
  }

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  const int first = blockIdx.x * TILES_PER_CHUNK;
  const int last = min(ntiles, first + TILES_PER_CHUNK);
  const float* s_in = &s.in[0][0][0];

  for (int tile = first; tile < last; ++tile) {
    const int b = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    const int y0 = (rem / tiles_x) * TH;
    const int x0 = (rem % tiles_x) * TW;
    __syncthreads();  // the previous tile has been read
    for (int i = tid; i < SH * SW * CI; i += NT) {
      const int ci = i % CI;
      const int p = i / CI;
      const int gy = y0 + p / SW - P;
      const int gx = x0 + p % SW - P;
      const int c = ci0 + ci;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
        val = x[(((size_t)b * H + gy) * W + gx) * Cin + c];
      s.in[ci][p / SW][p % SW] = val;
    }
    for (int i = tid; i < NT * CO; i += NT) {
      const int oo = i % CO;
      const int p = i / CO;
      const int gy = y0 + p / TW;
      const int gx = x0 + p % TW;
      const int co = co0 + oo;
      float val = 0.f;
      if (gy < H && gx < W && co < Cout)
        val = g[(((size_t)b * H + gy) * W + gx) * Cout + co];
      s.g[p][oo] = val;
    }
    __syncthreads();
#pragma unroll 1
    for (int py = 0; py < TH; ++py) {
#pragma unroll 1
      for (int px = 0; px < TW; ++px) {
        const float gv = s.g[py * TW + px][o];
        const int base = py * SW + px;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[q] = fmaf(s_in[off[q] + base], gv, acc[q]);
      }
    }
  }

  const int co = co0 + o;
  const size_t rows = (size_t)K * K * Cin;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = tid / CO + q * RSTEP;
    const int c = ci0 + r % CI;
    if (r < R && c < Cin && co < Cout)
      part[((size_t)blockIdx.x * rows + (size_t)(r / CI) * Cin + c) * Cout +
           co] = acc[q];
  }
}

// out[e] = sum over chunks of part[chunk, e], e < n: one block per group of
// 32 elements; each of the 8 warps sums a fixed stride of chunks, then the
// 8 partials are added in warp order.
__global__ void __launch_bounds__(NT)
    chunk_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int chunks, int n) {
  __shared__ float red[NT / 32][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (e < n)
    for (int c = warp; c < chunks; c += NT / 32)
      sum += part[(size_t)c * n + e];
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && e < n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) total += red[w][lane];
    out[e] = total;
  }
}

inline int num_chunks(int B, int H, int W) {
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return (tiles + TILES_PER_CHUNK - 1) / TILES_PER_CHUNK;
}

template <int K, int CO>
void launch(const float* x, const float* g, float* part, int B, int H, int W,
            int Cin, int Cout, cudaStream_t st) {
  const dim3 grid(num_chunks(B, H, W), (Cin + CI - 1) / CI,
                  (Cout + CO - 1) / CO);
  conv_dw_partial_kernel<K, CO><<<grid, NT, 0, st>>>(x, g, part, B, H, W,
                                                      Cin, Cout);
}

template <int K>
void launch_k(const float* x, const float* g, float* part, int B, int H,
              int W, int Cin, int Cout, cudaStream_t st) {
  if (Cout <= 8)
    launch<K, 8>(x, g, part, B, H, W, Cin, Cout, st);
  else
    launch<K, 32>(x, g, part, B, H, W, Cin, Cout, st);
}

}  // namespace

extern "C" {

// Number of chunks of the partial sums, so that the caller can allocate
// the [chunks, K*K*Cin, Cout] scratch.
int evf_conv_dw_chunks(int B, int H, int W) { return num_chunks(B, H, W); }

// dw2 [K*K*Cin, Cout] = im2col(x)^T g for x [B,H,W,Cin], g [B,H,W,Cout];
// part is the caller's [evf_conv_dw_chunks(B,H,W), K*K*Cin, Cout] scratch.
// Returns the first cudaGetLastError() after the two launches.
int evf_conv_dw(const float* x, const float* g, float* part, float* dw2,
                int B, int H, int W, int Cin, int Cout, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch_k<1>(x, g, part, B, H, W, Cin, Cout, st); break;
    case 3: launch_k<3>(x, g, part, B, H, W, Cin, Cout, st); break;
    case 5: launch_k<5>(x, g, part, B, H, W, Cin, Cout, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * K * Cin * Cout;
  chunk_sum_kernel<<<(n + 31) / 32, NT, 0, st>>>(part, dw2,
                                                 num_chunks(B, H, W), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
