// Shared mainloop of K1 (conv.cu) and K2 (fused_lif.cu): an implicit-GEMM
// NHWC convolution on Hopper's tensor cores in 3xTF32, for sm_90a.
//
// GEMM view of one block: M = an 8 x 32 tile of output pixels (one warp
// per output row, two m16 tiles per warp), N = CO output channels (8 or
// 32, n8 tiles), K = taps x input channels. No im2col matrix exists: the A
// tile of tap (dy, dx) is the shared-memory halo tile shifted by (dy, dx).
//
// Staging. The input channels of a segment are walked in passes of up to
// CCH = 32 (one pass for every cell of the model), each padded with zeros
// to a multiple of 8, the MMA's k. A pass copies the halo tile
// (TH + K - 1) x (TW + K - 1) and the pass's weight rows into dynamic
// shared memory with cp.async: 16-byte cp.async.cg where the channel
// count is a multiple of 4 and the pointer is 16-byte aligned, 4-byte
// cp.async.ca otherwise (the head's 2 input channels), the zero-fill form
// (source size 0) for halo pixels outside the image and padded channels.
// The halo tile is pixel-major with channels innermost and each pixel's
// row padded by 4 floats (stride cpad + 4, an odd multiple of 4 words),
// so the 8 pixels x 4 channels of an A fragment load fall on 32 distinct
// banks; weight rows are padded to CO + 8 floats (8 at CO = 8), so the
// 4 k x 8 n of a B fragment load do too. At K = 3, CO = 32 a pass takes
// 95 KB, two blocks per SM (passes of 16 channels, for more blocks per SM,
// measured 5-8 % slower on the 32-channel cells).
//
// Precision. mma.sync.m16n8k8 with TF32 operands keeps 10 mantissa bits,
// about 1e-4 of error on the cells' current, beyond the f32 tolerance the
// kernels are held to (tests/test_torch_precision.py). Each operand is
// split as hi = tf32(a), lo = tf32(a - hi), and each product is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, small terms first ("3xTF32"); the
// dropped lo*lo term is below 2^-21 of the product. The tensor cores add
// with truncation, so over a whole tap loop their running sum drifts by
// more than 1e-5 at dense inputs of magnitude 3 (measured on the H100):
// each k8 step's three MMAs go into a fresh fragment that is added to the
// FP32 accumulator on the CUDA cores, rounded to nearest. Every output is
// a fixed sequence of operations, so results are bitwise repeatable (no
// split-K, no atomics).
//
// Epilogue. The accumulator stays in the MMA's fragment layout: the quad
// of lanes 4g..4g+3 holds 8 consecutive channels of one pixel, so K1 and
// K2 read and write 32 contiguous bytes per quad as float2 (scalar where
// Cout is odd or a pointer is not 8-byte aligned). No thread walks the
// channels of a pixel.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace evf {

constexpr int TH = 8;          // output rows per block, one warp each
constexpr int TW = 32;         // output columns per block
constexpr int NT = 32 * TH;    // threads per block
constexpr int MT = TW / 16;    // m16 tiles per warp
constexpr int CCH = 32;        // input channels staged per pass, at most

// launch flags: which operands take 16-byte copies, which epilogue float2
enum : int { kVecX = 1, kVecW = 2, kVecR = 4, kVecWR = 8, kVec2 = 16 };

// channels of the pass starting at c0, padded to the MMA's k of 8
__host__ __device__ inline int pass_pad(int C, int c0) {
  const int c = C - c0 < CCH ? C - c0 : CCH;
  return (c + 7) & ~7;
}

template <int CO>
__host__ __device__ constexpr int wstride() { return CO == 8 ? 8 : CO + 8; }

// dynamic shared memory of one block for passes of at most cpad channels
template <int K, int CO>
inline size_t smem_bytes(int cpad) {
  return sizeof(float) *
         ((size_t)(TH + K - 1) * (TW + K - 1) * (cpad + 4) +
          (size_t)K * K * cpad * wstride<CO>());
}

inline bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(a - __uint_as_float(hi));
}

// d += a * b, m16n8k8, TF32 operands, FP32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy the halo tile of channels [c0, c0 + cpad) of src and the matching
// weight rows into shared memory, zero outside the image and past C and
// Cout; returns when the whole block's copies have landed.
template <int K, int CO>
__device__ __forceinline__ void stage(float* s_in, float* s_w,
                                      const float* __restrict__ src, int C,
                                      const float* __restrict__ w2, int Cout,
                                      int b, int H, int W, int y0, int x0,
                                      int co0, int c0, int cpad, bool vec_x,
                                      bool vec_w) {
  constexpr int P = K / 2;
  constexpr int SH = TH + K - 1;
  constexpr int SW = TW + K - 1;
  constexpr int WS = wstride<CO>();
  const int cs = cpad + 4;
  const int tid = threadIdx.x;
  // halo: consecutive threads take consecutive 16 (or 4) bytes of NHWC
  const int per_px = vec_x ? cpad / 4 : cpad;
  for (int i = tid; i < SH * SW * per_px; i += NT) {
    const int p = i / per_px;
    const int ci = (i - p * per_px) * (vec_x ? 4 : 1);
    const int gy = y0 + p / SW - P;
    const int gx = x0 + p % SW - P;
    const int c = c0 + ci;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
    const float* g = ok ? src + (((size_t)b * H + gy) * W + gx) * C + c : src;
    if (vec_x)
      cp16(s_in + p * cs + ci, g, ok);
    else
      cp4(s_in + p * cs + ci, g, ok);
  }
  // weights: rows (tap, ci) of the pass, CO columns from co0
  const int per_row = vec_w ? CO / 4 : CO;
  for (int i = tid; i < K * K * cpad * per_row; i += NT) {
    const int r = i / per_row;
    const int o = (i - r * per_row) * (vec_w ? 4 : 1);
    const int t = r / cpad;
    const int c = c0 + r - t * cpad;
    const int co = co0 + o;
    const bool ok = c < C && co < Cout;
    const float* g = ok ? w2 + ((size_t)t * C + c) * Cout + co : w2;
    if (vec_w)
      cp16(s_w + r * WS + o, g, ok);
    else
      cp4(s_w + r * WS + o, g, ok);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
}

// acc += the conv of src [B,H,W,C] with w2 [K*K*C, Cout] ((dy, dx, c) row
// order) over this block's tile, output channels co0 .. co0 + CO. smem
// holds passes of up to cpad_max channels. Every thread must call it.
// acc[m][n] is the m16n8 fragment of output pixels x0 + 16m + (0..15) of
// row y0 + warp, channels co0 + 8n + (0..7).
template <int K, int CO>
__device__ __forceinline__ void accumulate(
    float* smem, float (&acc)[MT][CO / 8][4], const float* __restrict__ src,
    int C, const float* __restrict__ w2, int Cout, int b, int H, int W,
    int y0, int x0, int co0, int cpad_max, bool vec_x, bool vec_w) {
  constexpr int SW = TW + K - 1;
  constexpr int WS = wstride<CO>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (pixel) / column (channel)
  const int t = lane & 3;   // fragment k
  float* s_in = smem;
  float* s_w = smem + (TH + K - 1) * SW * (cpad_max + 4);
  for (int c0 = 0; c0 < C; c0 += CCH) {
    const int cpad = pass_pad(C, c0);
    const int cs = cpad + 4;
    __syncthreads();  // the previous pass has finished reading the tiles
    stage<K, CO>(s_in, s_w, src, C, w2, Cout, b, H, W, y0, x0, co0, c0, cpad,
                 vec_x, vec_w);
#pragma unroll 1
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K;
      const int dx = tap - dy * K;
      const float* a_tap = s_in + ((warp + dy) * SW + dx + g) * cs + t;
      const float* b_tap = s_w + (tap * cpad + t) * WS + g;
      for (int kk = 0; kk < cpad; kk += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* a = a_tap + m * 16 * cs + kk;
          split(a[0], ah[m][0], al[m][0]);            // pixel g,   k t
          split(a[8 * cs], ah[m][1], al[m][1]);       // pixel g+8, k t
          split(a[4], ah[m][2], al[m][2]);            // pixel g,   k t+4
          split(a[8 * cs + 4], ah[m][3], al[m][3]);   // pixel g+8, k t+4
        }
#pragma unroll
        for (int n = 0; n < CO / 8; ++n) {
          const float* bp = b_tap + kk * WS + 8 * n;
          uint32_t bh[2], bl[2];
          split(bp[0], bh[0], bl[0]);        // k t,   channel g
          split(bp[4 * WS], bh[1], bl[1]);   // k t+4, channel g
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float part[4] = {};
            mma(part, al[m], bh);
            mma(part, ah[m], bl);
            mma(part, ah[m], bh);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[m][n][r] += part[r];
          }
        }
      }
    }
  }
}

// Calls f(i, co, a0, a1) for each pair of outputs this lane holds inside
// the image and below Cout: NHWC index i of channel co (even), and the
// values of channels co and co + 1 (a1 unused where co + 1 == Cout). For
// one (m, half, n) the warp's quads cover 8 pixels x 8 channels.
template <int CO, class F>
__device__ __forceinline__ void for_each_pair(
    const float (&acc)[MT][CO / 8][4], int H, int W, int Cout, int b, int y0,
    int x0, int co0, F&& f) {
  const int lane = threadIdx.x & 31;
  const int gy = y0 + (threadIdx.x >> 5);
  if (gy >= H) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + 16 * m + 8 * half + (lane >> 2);
      if (gx >= W) continue;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
      for (int n = 0; n < CO / 8; ++n) {
        const int co = co0 + 8 * n + 2 * (lane & 3);
        if (co < Cout)
          f(pix * Cout + co, co, acc[m][n][2 * half], acc[m][n][2 * half + 1]);
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

// Let kernel use the dynamic shared memory of passes of CCH channels
// (above the default 48 KB); call before each launch of an instance.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace evf
