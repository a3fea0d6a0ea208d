// Shared mainloop of K1 (conv.cu) and K2 (fused_lif.cu): a direct NHWC
// convolution in FP32 on CUDA cores.
//
// One block of 256 threads owns an 8 x 32 output tile of one image and up
// to CO output channels; each thread owns one output pixel and keeps CO
// float accumulators in registers. The K segment (kernel taps x input
// channels) is walked in passes of CI = 8 input channels: each pass
// stages the input tile plus its (K-1)-pixel halo, zero-filled outside
// the image and past the last channel, and the matching weight rows into
// static shared memory (at most 39.4 KB at K = 5, CO = 32). Weight rows
// are read as float4 broadcasts; the input tile is stored channel-major
// so that neighbouring threads read neighbouring words.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace evf {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 32;       // output columns per block: one warp per row
constexpr int NT = TH * TW;  // threads per block, one output pixel each
constexpr int CI = 8;        // input channels staged per pass

template <int K, int CO>
struct __align__(16) Tile {
  float w[K * K * CI][CO];               // rows (dy, dx, ci), CO columns
  float in[CI][TH + K - 1][TW + K - 1];  // channel-major halo tile
};

// acc[o] += the conv of src with w2 at this thread's pixel, output
// channel co0 + o. src is NHWC [B, H, W, C]; w2 is [K*K*C, Cout] in
// (dy, dx, c) row order. Every thread of the block must call it.
template <int K, int CO>
__device__ __forceinline__ void accumulate(
    Tile<K, CO>& s, float (&acc)[CO], const float* __restrict__ src, int C,
    const float* __restrict__ w2, int Cout, int b, int H, int W, int y0,
    int x0, int co0) {
  constexpr int P = K / 2;
  constexpr int SH = TH + K - 1;
  constexpr int SW = TW + K - 1;
  const int tid = threadIdx.x;
  const int ty = tid / TW;
  const int tx = tid % TW;
  for (int c0 = 0; c0 < C; c0 += CI) {
    __syncthreads();  // the previous pass has finished reading the tile
    for (int i = tid; i < SH * SW * CI; i += NT) {
      const int ci = i % CI;
      const int p = i / CI;
      const int sx = p % SW;
      const int sy = p / SW;
      const int gy = y0 + sy - P;
      const int gx = x0 + sx - P;
      const int c = c0 + ci;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        val = src[(((size_t)b * H + gy) * W + gx) * C + c];
      s.in[ci][sy][sx] = val;
    }
    for (int i = tid; i < K * K * CI * CO; i += NT) {
      const int o = i % CO;
      const int r = i / CO;
      const int ci = r % CI;
      const int t = r / CI;
      const int c = c0 + ci;
      const int co = co0 + o;
      float val = 0.f;
      if (c < C && co < Cout) val = w2[((size_t)t * C + c) * Cout + co];
      s.w[r][o] = val;
    }
    __syncthreads();
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
#pragma unroll
        for (int ci = 0; ci < CI; ++ci) {
          const float xv = s.in[ci][ty + dy][tx + dx];
          const float4* wr =
              reinterpret_cast<const float4*>(s.w[(dy * K + dx) * CI + ci]);
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 wv = wr[q];
            acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }
}

// grid: (tiles over H x W, output-channel groups of CO, batch)
__device__ __forceinline__ void tile_origin(int W, int* y0, int* x0) {
  const int tiles_x = (W + TW - 1) / TW;
  *y0 = (blockIdx.x / tiles_x) * TH;
  *x0 = (blockIdx.x % tiles_x) * TW;
}

inline dim3 grid_for(int B, int H, int W, int Cout, int co) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return dim3(tiles, (Cout + co - 1) / co, B);
}

}  // namespace evf
