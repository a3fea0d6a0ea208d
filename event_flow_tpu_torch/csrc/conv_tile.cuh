// The one-process mainloop of K1 and K2 where their plans keep its
// one-image tile (ops/conv_plan.py: x's or z_rec's pixel stride not a
// whole 16-byte row, float32 calls of many passes whose tiles fill the
// card, and K1's 1 x 1 heads of 64 input channels or fewer): an
// implicit-GEMM NHWC convolution on Hopper's tensor cores, for sm_90a,
// over float32 operands in 3xTF32 (mma.sync m16n8k8) or bfloat16 operands
// on the bf16 tensor cores (mma.sync m16n8k16, fragments from ldmatrix).
// Every other K1 and K2 call runs on the persistent float mainloop of
// conv_ring.cuh, which keeps this one's sum order (accumulate below) and
// so its bits; the int8 kernels K1-s8 and K2-s8 on their own
// (conv_s8.cuh). All of them use the copies, ldmatrix and MMAs below.
//
// GEMM view of one block: M = an 8 x 32 tile of output pixels (one warp
// per output row, two m16 tiles per warp), N = CO output channels (8 or
// 32, n8 tiles), K = taps x input channels. No im2col matrix exists: the A
// tile of tap (dy, dx) is the shared-memory halo tile shifted by (dy, dx).
//
// Staging. The input channels of a segment are walked in passes of up to
// CCH = 32 (one pass for every cell of the model), each padded with zeros
// to a multiple of 8. A pass copies the halo tile (TH + K - 1) x
// (TW + K - 1) and the pass's weight rows into dynamic shared memory with
// cp.async, in the operands' own element type: 16-byte cp.async.cg where
// the channel count is a multiple of 16 bytes' worth and the pointer is
// 16-byte aligned, else an 8- or 4-byte cp.async.ca, the widest the count
// and pointer allow (float32 pairs: the head's 2 input channels and the
// U-Net's 130 to 1026; bfloat16 pairs for those counts), a synchronous
// 2-byte store for an odd bfloat16 channel count, the zero-fill form
// (source size 0) for halo pixels outside the image and padded channels.
// The halo tile is pixel-major with channels innermost; weight rows are
// k-major with the output channels contiguous, padded to CO + 8 elements
// (8 at CO = 8). In float32 the pixel stride is cpad + 4 floats (an odd
// multiple of 4 words), so the 8 pixels x 4 channels of an A fragment
// load fall on 32 distinct banks, and the 4 k x 8 n of a B fragment load
// do not conflict either. In bfloat16 the pixel stride is cpad | 8 values
// and the weight row CO + 8 (or 8), odd multiples of 8 values: every 8
// channels of a pixel or 8 output channels of a weight row are one
// 16-byte row, aligned, and the 8 rows that one ldmatrix matrix reads fall
// on 8 distinct groups of 4 banks. At K = 3, CO = 32 a float32 pass takes
// 95 KB, two blocks per SM (passes of 16 channels, for more blocks per SM,
// measured 5-8 % slower on the 32-channel cells); a bfloat16 pass half.
//
// Precision. mma.sync.m16n8k8 with TF32 operands keeps 10 mantissa bits,
// about 1e-4 of error on the cells' current, beyond the f32 tolerance the
// kernels are held to (tests/test_torch_precision.py). Each float32
// operand is split as hi = tf32(a), lo = tf32(a - hi), and each product is
// taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, small terms first
// ("3xTF32"); the dropped lo*lo term is below 2^-21 of the product. The
// tensor cores add with truncation, so over a whole tap loop their
// running sum drifts by more than 1e-5 at dense inputs of magnitude 3
// (measured on the H100): each k8 step's MMAs go into a fresh fragment
// that is added to the FP32 accumulator on the CUDA cores, rounded to
// nearest. Every output is a fixed sequence of operations, so results are
// bitwise repeatable (no split-K, no atomics).
//
// A bfloat16 step (taps_bf16) is 16 channels of one tap: ldmatrix.x4
// loads each m16 tile of A (16 pixels x 16 channels) straight from the
// halo tile, ldmatrix.x4.trans two n8 tiles of B from the k-major weight
// rows, and one mma.sync.m16n8k16.f32.bf16 per m16 x n8 tile multiplies
// them. Products of bfloat16 values are exact in FP32, so nothing asks
// for TF32; each step goes into a fresh fragment added to the FP32
// accumulator, as above. A pass of 8 mod 16 channels ends in a step of 8,
// whose upper half is zeroed in both operands. Per 16 channels a warp
// runs 4 ldmatrix and 8 MMAs, where the TF32 route took 32 scalar loads,
// 32 conversions and 16 MMAs. What bounds it: at LIFFireNet's cells (8 x
// 128 x 128, 32 -> 32, k 3) a feedforward bfloat16 call must move 42 MB,
// 12.5 us at 3.35 TB/s; it takes about 0.03 ms on the H100 (PERF.md).
// Builds that dropped the staging or the MMAs showed the two taking
// similar times, one after the other: a block stages, then multiplies.
// Staging a pass in two cp.async groups, more blocks per SM and
// accumulating inside the MMA were tried on the card and not kept: none
// moved the time by much.
//
// Epilogue. The accumulator stays in the MMA's fragment layout: the quad
// of lanes 4g..4g+3 holds 8 consecutive channels of one pixel, so K2
// reads and writes 32 (bfloat16: 16) contiguous bytes per quad as element
// pairs (scalar where Cout is odd or a pointer is not aligned to a pair).
// No thread walks the channels of a pixel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace evf {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;          // output rows per block, one warp each
constexpr int TW = 32;         // output columns per block
constexpr int NT = 32 * TH;    // threads per block
constexpr int MT = TW / 16;    // m16 tiles per warp
constexpr int CCH = 32;        // input channels staged per pass, at most
constexpr int MAX_SMEM = 232448;  // dynamic shared memory of one block

// elements per cp.async of each operand, and whether the epilogue moves
// element pairs
struct Steps {
  int x, w, r, wr;
  bool out2;
};

// channels of the pass starting at c0, padded to the MMA's k of 8
__host__ __device__ inline int pass_pad(int C, int c0) {
  const int c = C - c0 < CCH ? C - c0 : CCH;
  return (c + 7) & ~7;
}

template <int CO>
__host__ __device__ constexpr int wstride() { return CO == 8 ? 8 : CO + 8; }

// pixel stride of the halo tile, in elements, for passes of cpad channels
template <class T>
__host__ __device__ inline int halo_stride(int cpad) {
  return sizeof(T) == 4 ? cpad + 4 : (cpad | 8);
}

// dynamic shared memory of one block for passes of at most cpad channels
template <int K, int CO, class T>
inline size_t smem_bytes(int cpad) {
  return sizeof(T) *
         ((size_t)(TH + K - 1) * (TW + K - 1) * halo_stride<T>(cpad) +
          (size_t)K * K * cpad * wstride<CO>());
}

inline bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// elements per copy of rows of C elements of T from p: 16 bytes where C
// and p allow, else 8, 4, 2, or one element
template <class T>
inline int copy_step(const void* p, int C) {
  for (int bytes = 16; bytes >= 2 && bytes >= (int)sizeof(T); bytes /= 2) {
    const int n = bytes / (int)sizeof(T);
    if (C % n == 0 && aligned(p, bytes)) return n;
  }
  return 1;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Copy `step` elements of T from src to shared dst, zeros where !ok: a
// cp.async of 16, 8 or 4 bytes, or a synchronous store of one bfloat16.
template <class T>
__device__ __forceinline__ void copy(T* dst, const T* src, bool ok,
                                     int step) {
  const int bytes = step * (int)sizeof(T);
  if (bytes == 16)
    cp16(dst, src, ok);
  else if (bytes == 8)
    cp8(dst, src, ok);
  else if (bytes == 4)
    cp4(dst, src, ok);
  else
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
}

// element loads and stores through float
__device__ __forceinline__ float widen(float a) { return a; }
__device__ __forceinline__ float widen(bf16 a) { return __bfloat162float(a); }
__device__ __forceinline__ void put(float* p, float a) { *p = a; }
__device__ __forceinline__ void put(bf16* p, float a) {
  *p = __float2bfloat16_rn(a);
}
__device__ __forceinline__ float2 get2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 get2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// a float rounded to T's precision (to nearest even), as a float: one
// operation of T done in float32 and rounded back
template <class T>
__device__ __forceinline__ float round_as(float a);
template <>
__device__ __forceinline__ float round_as<float>(float a) {
  return a;
}
template <>
__device__ __forceinline__ float round_as<bf16>(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
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

// floor(a / d) for 0 <= a < 2^20 and a small divisor d, from inv = 1.f / d:
// a + 0.5 is at least 0.5 / d away from a multiple of d, far above the
// float product's rounding
__device__ __forceinline__ int div_small(int a, float inv) {
  return __float2int_rz((a + 0.5f) * inv);
}

// split on the integer units (conv_ring.cuh, conv_dw.cu): cvt.rna.tf32.f32
// rounds to the nearest TF32 value, ties away from zero, which is adding
// half of the 13 dropped bits' unit to the magnitude and dropping them,
// the same bits for every finite value, at a fraction of the conversion's
// cost, whose throughput set the time of a stage's split (conv_ring.cuh)
// and of B2's per-step path.
__device__ __forceinline__ uint32_t tf32_bits(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// hi and lo of the 3xTF32 split. The add carries a NaN of a large payload
// (the card's own is 0x7fffffff) into the sign bit, so a NaN's hi may be
// +-0; its lo, the rounding of a - hi, a NaN that the card's arithmetic
// makes 0x7fffffff, is clamped first to 0x7fffefff (signed min: finite
// and negative values pass unchanged), which rounds to the NaN 0x7fffe000.
// So a NaN stays a NaN in the lo products, and an infinity gives a NaN lo,
// as the conversion's did; one integer min more than the plain rounding.
__device__ __forceinline__ void split_bits(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(a);
  const int r = __float_as_int(a - __uint_as_float(hi));
  lo = static_cast<uint32_t>(min(r, 0x7fffefff) + 0x1000) & 0xffffe000u;
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

// d += a * b, m16n8k16, bfloat16 operands (two per register, the lower k
// in the low half), FP32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: 8 x 8 matrices of 16-bit values, lanes 8j .. 8j + 7 giving
// the shared-memory addresses of matrix j's 8 rows of 16 bytes (x2: lanes
// 0 .. 15 only). Lane 4g + t receives row g, values 2t and 2t + 1 of each;
// with .trans, value g of rows 2t and 2t + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a * b, m16n8k32, int8 operands (four per register, the lowest k in
// the lowest byte), int32 accumulator: exact (conv_s8.cuh)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Copy the halo tile of channels [c0, c0 + cpad) of src (pixels ps >= C
// elements apart) and the matching weight rows into shared memory, zero
// outside the image and past C and Cout; returns when the whole block's
// copies have landed.
template <int K, int CO, class T>
__device__ __forceinline__ void stage(T* s_in, T* s_w,
                                      const T* __restrict__ src, int C,
                                      int ps, const T* __restrict__ w2,
                                      int Cout,
                                      int b, int H, int W, int y0, int x0,
                                      int co0, int c0, int cpad, int step_x,
                                      int step_w) {
  constexpr int P = K / 2;
  constexpr int SH = TH + K - 1;
  constexpr int SW = TW + K - 1;
  constexpr int WS = wstride<CO>();
  const int cs = halo_stride<T>(cpad);
  const int tid = threadIdx.x;
  // halo: consecutive threads take consecutive copies of NHWC
  const int per_px = cpad / step_x;
  for (int i = tid; i < SH * SW * per_px; i += NT) {
    const int p = i / per_px;
    const int ci = (i - p * per_px) * step_x;
    const int gy = y0 + p / SW - P;
    const int gx = x0 + p % SW - P;
    const int c = c0 + ci;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
    const T* g = ok ? src + (((size_t)b * H + gy) * W + gx) * ps + c : src;
    copy(s_in + p * cs + ci, g, ok, step_x);
  }
  // weights: rows (tap, ci) of the pass, CO columns from co0
  const int per_row = CO / step_w;
  for (int i = tid; i < K * K * cpad * per_row; i += NT) {
    const int r = i / per_row;
    const int o = (i - r * per_row) * step_w;
    const int t = r / cpad;
    const int c = c0 + r - t * cpad;
    const int co = co0 + o;
    const bool ok = c < C && co < Cout;
    const T* g = ok ? w2 + ((size_t)t * C + c) * Cout + co : w2;
    copy(s_w + r * WS + o, g, ok, step_w);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
}

// acc += every tap of a staged bfloat16 pass of cpad channels, m16n8k16
// on fragments that ldmatrix loads: A from the halo tile (pixel
// (warp + dy, dx) of the tile on), B from the tap's weight rows. Lane l gives the address of row l % 16 (A: pixel, B: k) at
// channels 8 (l / 16) on (A: k, B: n), so the four matrices of A are
// pixels 0-7 and 8-15 at k 0-7, then at k 8-15, and .trans turns the
// k-major weight rows into B's column fragments, two n8 tiles per load.
// Every 16-byte row is aligned, and 8 rows of one matrix fall on 8
// distinct bank groups (pixel stride cs and row stride WS are odd
// multiples of 8 values). Each k16 step goes into a fresh fragment added
// to acc in FP32, as in the float32 path.
template <int K, int CO>
__device__ __forceinline__ void taps_bf16(float (&acc)[MT][CO / 8][4],
                                          const bf16* s_in, const bf16* s_w,
                                          int cpad, int cs) {
  constexpr int SW = TW + K - 1;
  constexpr int WS = wstride<CO>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = lane & 15;
  const int col = 8 * (lane >> 4);
#pragma unroll 1
  for (int tap = 0; tap < K * K; ++tap) {
    const int dy = tap / K;
    const bf16* a_px = s_in + ((warp + dy) * SW + tap - dy * K) * cs;
    const bf16* b_k = s_w + tap * cpad * WS;
    for (int kk = 0; kk < cpad; kk += 16) {
      // a pass of 8 mod 16 channels ends in a k16 step holding 8: its
      // upper k half reads the lower half's rows again and is zeroed in A
      // and B
      const bool half = cpad - kk == 8;
      const bf16* a = a_px + row * cs + kk + (half ? 0 : col);
      const bf16* b = b_k + (kk + (half ? row & 7 : row)) * WS + col;
      uint32_t af[MT][4], bfr[CO / 8][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldsm_x4(af[m], a + m * 16 * cs);
        if (half) af[m][2] = af[m][3] = 0u;
      }
      if constexpr (CO == 8) {
        ldsm_x2_t(bfr[0], b);
        if (half) bfr[0][1] = 0u;
      } else {
#pragma unroll
        for (int n = 0; n < CO / 8; n += 2) {
          uint32_t q[4];
          ldsm_x4_t(q, b + 8 * n);
          bfr[n][0] = q[0];
          bfr[n][1] = half ? 0u : q[1];
          bfr[n + 1][0] = q[2];
          bfr[n + 1][1] = half ? 0u : q[3];
        }
      }
#pragma unroll
      for (int n = 0; n < CO / 8; ++n)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float part[4] = {};
          mma_bf16(part, af[m], bfr[n]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] += part[r];
        }
    }
  }
}

// acc += the conv of src [B,H,W,C] (pixels ps >= C elements apart) with
// w2 [K*K*C, Cout] ((dy, dx, c) row order) over this block's tile, output
// channels co0 .. co0 + CO. smem holds passes of up to cpad_max channels.
// Every thread must call it.
// acc[m][n] is the m16n8 fragment of output pixels x0 + 16m + (0..15) of
// row y0 + warp, channels co0 + 8n + (0..7).
template <int K, int CO, class T>
__device__ __forceinline__ void accumulate(
    T* smem, float (&acc)[MT][CO / 8][4], const T* __restrict__ src, int C,
    int ps, const T* __restrict__ w2, int Cout, int b, int H, int W, int y0, int x0,
    int co0, int cpad_max, int step_x, int step_w) {
  constexpr int SW = TW + K - 1;
  constexpr int WS = wstride<CO>();
  T* s_in = smem;
  T* s_w = smem + (TH + K - 1) * SW * halo_stride<T>(cpad_max);
  for (int c0 = 0; c0 < C; c0 += CCH) {
    const int cpad = pass_pad(C, c0);
    const int cs = halo_stride<T>(cpad);
    __syncthreads();  // the previous pass has finished reading the tiles
    stage<K, CO, T>(s_in, s_w, src, C, ps, w2, Cout, b, H, W, y0, x0, co0,
                    c0, cpad, step_x, step_w);
    if constexpr (sizeof(T) == 2) {
      taps_bf16<K, CO>(acc, s_in, s_w, cpad, cs);
    } else {
      const int lane = threadIdx.x & 31;
      const int warp = threadIdx.x >> 5;
      const int g = lane >> 2;  // fragment row (pixel) / column (channel)
      const int t = lane & 3;   // fragment k
#pragma unroll 1
      for (int tap = 0; tap < K * K; ++tap) {
        const int dy = tap / K;
        const int dx = tap - dy * K;
        const T* a_tap = s_in + ((warp + dy) * SW + dx + g) * cs + t;
        const T* b_tap = s_w + (tap * cpad + t) * WS + g;
        for (int kk = 0; kk < cpad; kk += 8) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const T* a = a_tap + m * 16 * cs + kk;
            split(a[0], ah[m][0], al[m][0]);            // pixel g,   k t
            split(a[8 * cs], ah[m][1], al[m][1]);       // pixel g+8, k t
            split(a[4], ah[m][2], al[m][2]);            // pixel g,   k t+4
            split(a[8 * cs + 4], ah[m][3], al[m][3]);   // pixel g+8, k t+4
          }
#pragma unroll
          for (int n = 0; n < CO / 8; ++n) {
            const T* bp = b_tap + kk * WS + 8 * n;
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
}

// Calls f(i, co, a0, a1) for each pair of outputs this lane holds inside
// the image and below Cout: NHWC index i of channel co (even), and the
// accumulators of channels co and co + 1 (a1 unused where co + 1 ==
// Cout). For one (m, half, n) the warp's quads cover 8
// pixels x 8 channels.
template <int CO, class A, class F>
__device__ __forceinline__ void for_each_pair(
    const A (&acc)[MT][CO / 8][4], int H, int W, int Cout, int b, int y0,
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

// Blocks of kernel the card holds at once at `threads` a block and smem
// bytes of dynamic shared memory (the kernel allowed MAX_SMEM first),
// cached per kernel, shape of launch and device: the persistent grids
// of B2 and of the wgmma route.
inline cudaError_t block_capacity(const void* kernel, int threads, int smem,
                                  int* out) {
  struct Entry {
    const void* kernel;
    int threads, smem, dev, cap;
  };
  static Entry cache[256];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].threads == threads &&
        cache[i].smem == smem && cache[i].dev == dev) {
      *out = cache[i].cap;
      return cudaSuccess;
    }
  int per_sm = 0, sms = 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (used < 256) cache[used++] = {kernel, threads, smem, dev, per_sm * sms};
  *out = per_sm * sms;
  return cudaSuccess;
}

}  // namespace evf
