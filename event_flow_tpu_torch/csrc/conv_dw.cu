// B2: weight gradient of the same-padded stride-1 NHWC convolution, for
// sm_90a: FP32 results from Hopper's tensor cores in 3xTF32, or from
// bfloat16 x and g on the bf16 tensor cores (mma.sync m16n8k16, fragments
// from ldmatrix.trans), summed in FP32 and rounded once to a bfloat16 dw.
//
//   dw[co, ci, dy, dx] = sum_{b,i,j} x[b, i+dy-p, j+dx-p, ci] * g[b, i, j, co]
//
// Replaces event_flow_tpu/ops/conv_pallas.py::_conv_dw (_dw_kernel), which
// multiplies an im2col matrix of x by g and carries the sum over the B*H*W
// pixels from one grid step to the next; on bfloat16 operands it sums in
// float32 and rounds dw to bfloat16 (conv_pallas.py:185).
//
// GEMM view: M = rows r = (dy*K + dx)*cr + ci over a block's cb input
// channels (cr = cb in float32, cb padded to 8 in bfloat16: row_channels),
// N = output channels, K = pixels. No im2col matrix exists: row r of the
// A operand at pixel p is the shared-memory halo tile of x read at p
// shifted by (dy, dx), so each lane keeps the halo offset of its rows in
// registers and the pixel only moves a base pointer. A block owns an
// output tile of K*K*CB rows (CB = 32 input channels, 8 at K = 5) by 32
// output channels (8 where Cout <= 8) and walks a chunk of pixel tiles of
// 128 pixels (32 x 4, 16 x 8 or 8 x 16 after the image's width): for each
// tile it stages the halo tile of its channels and the g tile with
// cp.async in their own element type (16 bytes where the channel count
// allows, else 8 or 4, a synchronous store for an odd bfloat16 count;
// zero-filled outside the image and past Cin and Cout) into one of two
// buffers, so that the next tile loads while this one multiplies. Both
// tiles are pixel-major with channels innermost. Warps split the rows (3
// m16 tiles each) and, where the rows are few (the head's 2 input
// channels, the 1 x 1 heads), the pixels of a tile as well.
//
// float32: the pixel stride is 8 or 24 mod 32 floats, so the 4 pixels x 8
// rows (or columns) of a fragment load hit 32 distinct banks; eight
// consecutive pixels of one tile row are one k8 step of mma.sync.m16n8k8.
// Operands split as hi = tf32(a), lo = tf32(a - hi), each product taken
// as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi into a fresh fragment per k8 step
// that is added to the FP32 accumulator on the CUDA cores (the tensor
// cores add by truncation; K1's note in conv_tile.cuh). Where every x of
// a staged tile is already a TF32 value (spikes, event counts: the
// training cells' inputs), x's lo part is zero and its product is
// skipped, so such a tile takes two MMAs per product; the test reads the
// tile once.
//
// bfloat16 (tile_mma_bf16): one step is 16 pixels. Both operands pair
// their values along the pixels, and both tiles hold 8 channels of a
// pixel in one 16-byte row, so ldmatrix.x4.trans over 8-pixel x 8-channel
// blocks gives A (8 rows = one tap's 8 channels, which is why a tap's
// rows are padded to 8; a pad channel's row is multiplied and dropped)
// and B (two n8 tiles of g per load). The pixel stride, 8 mod 16 values,
// keeps every row aligned and puts the 8 rows of a matrix on 8 distinct
// groups of 4 banks. One mma.sync.m16n8k16.f32.bf16 per m16 x n8 tile,
// exact products, a fresh fragment per step added in FP32. A tile of 8
// mod 16 pixels (8 wide, an odd number of rows) ends in a step of 8 whose
// upper half is zeroed in both operands. No tile is zeroed first: every
// value a kept row reads is staged.
//
// Work split and the fixed-order sum. The pixels are split into chunks
// only where the output tiles leave SMs idle, into enough chunks for about
// two blocks per SM: at the FireNet shapes (one output tile) 256 chunks,
// at the U-Net's 512 -> 512 on 8 x 8 (256 tiles) none. A block's warps that
// split the pixels add their parts in shared memory in warp order, then
// the block writes its tile in OIHW order, one contiguous run of K*K*cb
// floats per output channel, to the result or, with several chunks, to its
// chunk's slice of the scratch; a second launch adds the chunks in a fixed
// order. No float atomics: the result is bitwise the same from run to run.
// The scratch is chunks x the output: 9.4 MB at 32 -> 32 (a quarter of x
// and g); at the U-Net's deep shapes the output alone outweighs x and g.
//
// What bounds it: at the training recipe (8 x 128 x 128, 32 -> 32, k = 3)
// one call must read x and g once, 33.6 MB, 10.0 us at 3.35 TB/s; its
// 2.42 GFLOP take 4.9 us at the TF32 peak. On the card a float32 call
// takes 7x the bytes' bound (chip_smoke.py; PERF.md): each MMA pass costs
// time (a dense x tile, three passes, takes about 14 us longer than a
// spike tile, two), and so does the per-step path around it (fragment
// loads, splits, FP32 adds) with only 12 warps per SM to hide its latency.
// A variant with wgmma (g pre-split in shared memory as B) was no faster.
// In bfloat16 the bytes halve (5.0 us) and the per-step path shrinks to 5
// ldmatrix and 12 MMAs per 16 pixels; a call takes about 0.03 ms, 6x its
// bound and faster than cuDNN's bf16 wgrad at that shape, but 3x slower
// than it at 512 -> 512 on 8 x 8 (PERF.md). Builds that dropped phases
// in turns put the rest in the staging, the MMAs and the epilogue with its
// scratch, in that order of size, and they do not overlap much; a ring of
// more staging buffers and accumulating inside the MMA were tried on the
// card and not kept.

#include <algorithm>

#include "conv_tile.cuh"

namespace {

using evf::aligned;
using evf::bf16;
using evf::copy;
using evf::copy_step;
using evf::ldsm_x2_t;
using evf::ldsm_x4_t;
using evf::mma;
using evf::mma_bf16;
using evf::put;
using evf::split;

constexpr int PIX = 128;      // pixels per tile
constexpr int MW = 3;         // m16 tiles per warp
constexpr int MAX_WARPS = 8;
constexpr int SUM_THREADS = 256;

template <int K>
__host__ __device__ constexpr int cblock() { return K == 5 ? 8 : 32; }

// pixel stride of the halo tile for cb channels, in elements: float32 an
// odd multiple of 8 floats (8 or 24 mod 32), so that 4 pixels x 8
// channels of a fragment load hit 32 banks; bfloat16 8 mod 16 values, so
// that every 8 channels of a pixel are one aligned 16-byte row and the 8
// pixels an ldmatrix matrix reads hit 8 distinct groups of 4 banks
template <class T>
__host__ __device__ inline int halo_stride(int cb) {
  int cs = (cb + 7) & ~7;
  if (sizeof(T) == 2) return cs | 8;
  if (cs % 32 == 0 || cs % 32 == 16) cs += 8;
  return cs;
}

// channels of one tap's rows of the GEMM for a block of cb input
// channels: float32 cb; bfloat16 cb padded to 8, so that 8 consecutive
// rows are one tap's 8 channels, a 16-byte row of the halo tile that
// ldmatrix reads (a pad channel's row is multiplied and dropped)
template <class T>
__host__ __device__ inline int row_channels(int cb) {
  return sizeof(T) == 2 ? (cb + 7) & ~7 : cb;
}

struct Geo {
  int H, W, Cin, Cout;
  int tw, tw_log, th;        // pixel tile: th rows of tw pixels
  int tiles_x, tiles_y, ntiles;
  int per_chunk;             // tiles per block
  int wm, wk;                // warps along the rows, along the pixels
  int vec_x, vec_g;          // elements per copy
};

// elements of one staging buffer: the halo tile and the g tile
template <int K>
__host__ __device__ inline int stage_elems(const Geo& geo, int cs, int gs) {
  return (geo.th + K - 1) * (geo.tw + K - 1) * cs + geo.th * geo.tw * gs;
}

// floor(a / d) for 0 <= a < 2^20 and a small divisor d, from inv = 1.f / d:
// a + 0.5 is at least 0.5 / d away from a multiple of d, far above the
// float product's rounding
__device__ __forceinline__ int div_small(int a, float inv) {
  return __float2int_rz((a + 0.5f) * inv);
}

// Copy tile `tile`'s halo of channels [c0, c0 + cb) of x and its g tile of
// columns [co0, co0 + BN) into the buffer at s; does not wait.
template <int K, int BN, class T>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ x,
                                      const T* __restrict__ g,
                                      const Geo& geo, int tile, int c0,
                                      int cb, int cs, int co0) {
  constexpr int P = K / 2;
  constexpr int GS = evf::wstride<BN>();
  const int sw = geo.tw + K - 1;
  const int sh = geo.th + K - 1;
  const int per_img = geo.tiles_x * geo.tiles_y;
  const int b = tile / per_img;
  const int rem = tile - b * per_img;
  const int y0 = (rem / geo.tiles_x) * geo.th;
  const int x0 = (rem % geo.tiles_x) * geo.tw;
  const int step_x = geo.vec_x;
  const int per_px = cb / step_x;  // cb is a multiple of step_x
  const float inv_px = 1.f / per_px;
  const float inv_sw = 1.f / sw;
  for (int i = threadIdx.x; i < sh * sw * per_px; i += blockDim.x) {
    const int p = div_small(i, inv_px);
    const int ci = (i - p * per_px) * step_x;
    const int hy = div_small(p, inv_sw);
    const int gy = y0 + hy - P;
    const int gx = x0 + p - hy * sw - P;
    const bool ok = gy >= 0 && gy < geo.H && gx >= 0 && gx < geo.W;
    const T* src =
        ok ? x + (((size_t)b * geo.H + gy) * geo.W + gx) * geo.Cin + c0 + ci
           : x;
    copy(s + p * cs + ci, src, ok, step_x);
  }
  // g: per_pg divides the block's 32 * w threads, so each thread keeps
  // its columns and walks the pixels
  T* sg = s + sh * sw * cs;
  const int step_g = geo.vec_g;
  const int per_pg = BN / step_g;
  const int o = (threadIdx.x % per_pg) * step_g;
  const int co = co0 + o;
  for (int p = threadIdx.x / per_pg; p < geo.th * geo.tw;
       p += blockDim.x / per_pg) {
    const int gy = y0 + (p >> geo.tw_log);
    const int gx = x0 + (p & (geo.tw - 1));
    const bool ok = gy < geo.H && gx < geo.W && co < geo.Cout;
    const T* src =
        ok ? g + (((size_t)b * geo.H + gy) * geo.W + gx) * geo.Cout + co : g;
    copy(sg + p * GS + o, src, ok, step_g);
  }
}

// acc += this warp's share of one staged float32 tile: k8 steps wk,
// wk + nwk, ... of its 8-pixel steps. EXACT: every x of the tile is a TF32
// value (spikes, event counts), so x's lo part is zero and its product,
// zero, is skipped.
template <int K, int NT, bool EXACT>
__device__ __forceinline__ void tile_mma(float (&acc)[MW][NT][4],
                                         const float* sx, const float* sg,
                                         const int (&roff)[MW][2], int mt,
                                         int steps, int wk, int nwk,
                                         int tw_log, int cs) {
  constexpr int GS = evf::wstride<8 * NT>();
  const int sw = (1 << tw_log) + K - 1;
  const int gq = (threadIdx.x & 31) >> 2;  // fragment row / column
  const int t = threadIdx.x & 3;           // fragment k
  for (int s = wk; s < steps; s += nwk) {
    const int p = 8 * s + t;  // k slot t; slot t + 4 is pixel p + 4
    const int py = p >> tw_log;
    const float* xa = sx + (py * sw + p - (py << tw_log)) * cs;
    const float* gb = sg + p * GS + gq;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      split(gb[8 * n], bh[n][0], bl[n][0]);           // k t,   col gq
      split(gb[4 * GS + 8 * n], bh[n][1], bl[n][1]);  // k t+4, col gq
    }
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (m >= mt) continue;
      const float a[4] = {xa[roff[m][0]],            // row gq,   k t
                          xa[roff[m][1]],            // row gq+8, k t
                          xa[4 * cs + roff[m][0]],   // row gq,   k t+4
                          xa[4 * cs + roff[m][1]]};  // row gq+8, k t+4
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EXACT)
          ah[e] = __float_as_uint(a[e]);
        else
          split(a[e], ah[e], al[e]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float part[4] = {};
        if (!EXACT) mma(part, al, bh[n]);
        mma(part, ah, bl[n]);
        mma(part, ah, bh[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[e];
      }
    }
  }
}

// acc += this warp's share of one staged bfloat16 tile: k16 steps wk,
// wk + nwk, ... of 16 pixels each, m16n8k16 on fragments that
// ldmatrix.trans loads, since both operands pair along the pixels. A: lane
// l gives pixel l % 8 + 8 (l / 16) of the step in the halo tile, at
// aoff[m], the offset of the 8 rows (one tap, 8 channels) of half
// (l / 8) % 2 of m16 tile m; B: pixel l % 16 of the g tile at columns
// 8 (l / 16) of each pair of n8 tiles. Each k16 step goes into a fresh
// fragment added to acc in FP32.
template <int K, int NT>
__device__ __forceinline__ void tile_mma_bf16(float (&acc)[MW][NT][4],
                                              const bf16* sx, const bf16* sg,
                                              const int (&aoff)[MW], int mt,
                                              int npix, int wk, int nwk,
                                              int tw_log, int cs) {
  constexpr int GS = evf::wstride<8 * NT>();
  const int sw = (1 << tw_log) + K - 1;
  const int lane = threadIdx.x & 31;
  const int col = 8 * (lane >> 4);
  const int steps = (npix + 15) / 16;
  for (int s = wk; s < steps; s += nwk) {
    // a tile of 8 mod 16 pixels (8 wide, an odd number of rows) ends in a
    // k16 step holding 8: its upper k half reads the lower half's pixels
    // again and is zeroed in A and B
    const bool half = npix - 16 * s == 8;
    const int pa = 16 * s + (lane & 7) + (half ? 0 : col);
    const int pb = 16 * s + (half ? lane & 7 : lane & 15);
    const int py = pa >> tw_log;
    const bf16* xa = sx + (py * sw + pa - (py << tw_log)) * cs;
    const bf16* gb = sg + pb * GS + col;
    uint32_t b[NT][2];
    if constexpr (NT == 1) {
      ldsm_x2_t(b[0], gb);
      if (half) b[0][1] = 0u;
    } else {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t q[4];
        ldsm_x4_t(q, gb + 8 * n);
        b[n][0] = q[0];
        b[n][1] = half ? 0u : q[1];
        b[n + 1][0] = q[2];
        b[n + 1][1] = half ? 0u : q[3];
      }
    }
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (m >= mt) continue;
      uint32_t a[4];
      ldsm_x4_t(a, xa + aoff[m]);
      if (half) a[2] = a[3] = 0u;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float part[4] = {};
        mma_bf16(part, a, b[n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[e];
      }
    }
  }
}

// grid: (chunks, ceil(Cin / CB), ceil(Cout / BN)); 32 * wm * wk threads.
// dst: the OIHW result in T (one chunk) or the float32 [chunks,
// Cout*Cin*K*K] scratch.
template <int K, int NT, class T, class TO>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
    conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   TO* __restrict__ dst, Geo geo) {
  constexpr int KK = K * K;
  constexpr int CB = cblock<K>();
  constexpr int BN = 8 * NT;
  constexpr int GS = evf::wstride<BN>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  constexpr bool BF16 = sizeof(T) == 2;
  const int c0 = blockIdx.y * CB;
  const int cb = min(CB, geo.Cin - c0);
  const int co0 = blockIdx.z * BN;
  const int cs = halo_stride<T>(cb);
  const int sw = geo.tw + K - 1;
  const int cr = row_channels<T>(cb);  // channels of a tap's rows
  const int rows = KK * cr;
  const int outs = KK * cb;            // rows with a result
  const int warp = threadIdx.x >> 5;
  const int wm = warp % geo.wm;
  const int wk = warp / geo.wm;
  const int gq = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  // m16 tiles of this warp that hold rows (warp-uniform)
  const int mt = min(MW, (rows + 15) / 16 - wm * MW);

  // float32: the halo offset of rows gq and gq + 8 of each m16 tile;
  // bfloat16: of the first of the 8 rows of the half (lane / 8) % 2 that
  // this lane addresses for ldmatrix. A row past the block's reads row 0
  // and its sum is never written.
  int roff[MW][2];
  int aoff[MW];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = (wm * MW + m) * 16 + (BF16 ? 0 : gq) + 8 * h;
      if (r >= rows) r = 0;
      const int tap = r / cr;
      roff[m][h] = ((tap / K) * sw + tap % K) * cs + (r - tap * cr);
      if (h == (((threadIdx.x & 31) >> 3) & 1)) aoff[m] = roff[m][h];
    }

  float acc[MW][NT][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int sf = stage_elems<K>(geo, cs, GS);
  const int halo = (geo.th + K - 1) * sw * cs;
  const int npix = geo.th * geo.tw;
  const int first = blockIdx.x * geo.per_chunk;
  const int last = min(geo.ntiles, first + geo.per_chunk);
  if constexpr (!BF16) {
    // the halo's pad channels [cb, cs) are never copied: zero them once,
    // so that the TF32 test below reads only values of x or zeros (a
    // bfloat16 pad channel only feeds a row that is dropped)
    for (int i = threadIdx.x; i < 2 * sf; i += blockDim.x)
      reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
    __syncthreads();
  }
  if (first < last) {
    stage<K, BN, T>(smem, x, g, geo, first, c0, cb, cs, co0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int tile = first; tile < last; ++tile) {
    const int i = tile - first;
    if (tile + 1 < last)
      stage<K, BN, T>(smem + ((i + 1) & 1) * sf, x, g, geo, tile + 1, c0, cb,
                      cs, co0);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::
                     : "memory");
    __syncthreads();  // tile i has landed for every thread
    const T* sx = smem + (i & 1) * sf;
    if constexpr (BF16) {
      if (mt > 0)
        tile_mma_bf16<K, NT>(acc, sx, sx + halo, aoff, mt, npix, wk, geo.wk,
                             geo.tw_log, cs);
    } else {
      // is every staged x a TF32 value (its low 13 mantissa bits zero)?
      uint32_t low = 0;
      for (int j = threadIdx.x; j < halo; j += blockDim.x)
        low |= __float_as_uint(sx[j]) & 0x1fffu;
      const bool exact_tile = !__syncthreads_or(low != 0);
      if (mt > 0) {
        if (exact_tile)
          tile_mma<K, NT, true>(acc, sx, sx + halo, roff, mt, npix / 8, wk,
                                geo.wk, geo.tw_log, cs);
        else
          tile_mma<K, NT, false>(acc, sx, sx + halo, roff, mt, npix / 8, wk,
                                 geo.wk, geo.tw_log, cs);
      }
    }
    __syncthreads();  // every thread is done with buffer i & 1
  }

  // The warps that split the pixels add their sums in warp order into
  // s_out [column][ci * KK + tap] (row stride odd), then the block writes
  // one contiguous OIHW run of outs elements per output channel.
  float* s_out = reinterpret_cast<float*>(smem_raw);
  const int rs = outs | 1;
  for (int k = 0; k < geo.wk; ++k) {
    if (wk == k) {
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        if (m >= mt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * MW + m) * 16 + gq + 8 * h;
          if (r >= rows) continue;
          const int tap = r / cr;
          const int ci = r - tap * cr;
          if (BF16 && ci >= cb) continue;  // a pad channel's row
          const int j = ci * KK + tap;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* d = s_out + (8 * n + 2 * t + e) * rs + j;
              const float v = acc[m][n][2 * h + e];
              *d = k == 0 ? v : *d + v;
            }
        }
      }
    }
    __syncthreads();
  }
  const int ncol = min(BN, geo.Cout - co0);
  TO* out = dst + (size_t)blockIdx.x * geo.Cout * geo.Cin * KK;
  for (int i = threadIdx.x; i < ncol * outs; i += blockDim.x) {
    const int col = i / outs;
    const int j = i - col * outs;
    put(out + ((size_t)(co0 + col) * geo.Cin + c0) * KK + j,
        s_out[col * rs + j]);
  }
}

// out[e] = sum over chunks of part[chunk, e], e < n, in a fixed order:
// one block per group of 32 elements, each of the NW warps sums a fixed
// stride of chunks, then the NW partials are added in warp order and the
// total rounded once to TO.
template <class TO>
__global__ void __launch_bounds__(SUM_THREADS)
    chunk_sum_kernel(const float* __restrict__ part, TO* __restrict__ out,
                     int chunks, int n) {
  constexpr int NW = SUM_THREADS / 32;
  __shared__ float red[NW][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (e < n)
    for (int c = warp; c < chunks; c += NW) sum += part[(size_t)c * n + e];
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && e < n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) total += red[w][lane];
    put(out + e, total);
  }
}

struct Plan {
  Geo geo;
  dim3 grid;
  int threads;
  size_t smem;
};

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

// The launch for a shape: the pixel tile after the width, the warps after
// the rows (row_channels), and the chunks of the pixel split (see the
// note at the top), the same for both element types.
template <int K, int NT, class T>
Plan make_plan(int B, int H, int W, int Cin, int Cout) {
  constexpr int KK = K * K;
  constexpr int CB = cblock<K>();
  constexpr int BN = 8 * NT;
  Plan pl{};
  Geo& geo = pl.geo;
  geo.H = H, geo.W = W, geo.Cin = Cin, geo.Cout = Cout;
  geo.tw = W > 16 ? 32 : W > 8 ? 16 : 8;
  geo.tw_log = geo.tw == 32 ? 5 : geo.tw == 16 ? 4 : 3;
  geo.th = std::min(PIX / geo.tw, H);
  geo.tiles_x = (W + geo.tw - 1) / geo.tw;
  geo.tiles_y = (H + geo.th - 1) / geo.th;
  geo.ntiles = B * geo.tiles_x * geo.tiles_y;
  const int mtiles = (KK * row_channels<T>(std::min(CB, Cin)) + 15) / 16;
  geo.wm = (mtiles + MW - 1) / MW;
  geo.wk = std::max(1, MAX_WARPS / geo.wm);
  const int cblocks = (Cin + CB - 1) / CB;
  const int coblocks = (Cout + BN - 1) / BN;
  // split the pixels only where the output tiles leave SMs idle: then
  // into enough chunks for about two blocks per SM
  const long long out_tiles = (long long)cblocks * coblocks;
  long long chunks = out_tiles >= num_sms()
                         ? 1
                         : (2LL * num_sms() + out_tiles - 1) / out_tiles;
  if (chunks > geo.ntiles) chunks = geo.ntiles;
  geo.per_chunk = (int)((geo.ntiles + chunks - 1) / chunks);
  chunks = (geo.ntiles + geo.per_chunk - 1) / geo.per_chunk;
  pl.grid = dim3((unsigned)chunks, cblocks, coblocks);
  pl.threads = 32 * geo.wm * geo.wk;
  const int cs = halo_stride<T>(std::min(CB, Cin));
  const size_t stages =
      2 * sizeof(T) * (size_t)stage_elems<K>(geo, cs, evf::wstride<BN>());
  const size_t out_tile =
      sizeof(float) * (size_t)BN * ((KK * std::min(CB, Cin)) | 1);
  pl.smem = stages > out_tile ? stages : out_tile;
  return pl;
}

template <int K, int NT, class T>
int run(const T* x, const T* g, float* part, T* out, int B, int H, int W,
        int Cin, int Cout, cudaStream_t st) {
  Plan pl = make_plan<K, NT, T>(B, H, W, Cin, Cout);
  pl.geo.vec_x = copy_step<T>(x, Cin);
  pl.geo.vec_g = copy_step<T>(g, Cout);
  const int chunks = (int)pl.grid.x;
  cudaError_t err;
  if (chunks == 1) {
    auto* kernel = conv_dw_kernel<K, NT, T, T>;
    err = evf::allow_smem(kernel, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<pl.grid, pl.threads, pl.smem, st>>>(x, g, out, pl.geo);
    return static_cast<int>(cudaGetLastError());
  }
  auto* kernel = conv_dw_kernel<K, NT, T, float>;
  err = evf::allow_smem(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<pl.grid, pl.threads, pl.smem, st>>>(x, g, part, pl.geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * K * Cin * Cout;
  chunk_sum_kernel<T><<<(n + 31) / 32, SUM_THREADS, 0, st>>>(part, out,
                                                             chunks, n);
  return static_cast<int>(cudaGetLastError());
}

template <int K, class T>
int run_k(const T* x, const T* g, float* part, T* out, int B, int H, int W,
          int Cin, int Cout, cudaStream_t st) {
  if (Cout <= 8) return run<K, 1, T>(x, g, part, out, B, H, W, Cin, Cout, st);
  return run<K, 4, T>(x, g, part, out, B, H, W, Cin, Cout, st);
}

template <int K>
int chunks_k(int B, int H, int W, int Cin, int Cout) {
  return (int)(Cout <= 8 ? make_plan<K, 1, float>(B, H, W, Cin, Cout)
                         : make_plan<K, 4, float>(B, H, W, Cin, Cout)).grid.x;
}

bool valid(int B, int H, int W, int Cin, int Cout) {
  return B > 0 && H > 0 && W > 0 && Cin > 0 && Cout > 0;
}

template <class T>
int conv_dw(const T* x, const T* g, float* part, T* dw, int B, int H, int W,
            int Cin, int Cout, int K, void* stream) {
  if (!valid(B, H, W, Cin, Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return run_k<1, T>(x, g, part, dw, B, H, W, Cin, Cout, st);
    case 3: return run_k<3, T>(x, g, part, dw, B, H, W, Cin, Cout, st);
    case 5: return run_k<5, T>(x, g, part, dw, B, H, W, Cin, Cout, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Chunks of the pixel split for this shape (either element type): 1 means
// no scratch; else the caller passes a float32 [chunks, Cout*Cin*K*K]
// scratch. -1 for a shape or K the kernel does not take.
int evf_conv_dw_chunks(int B, int H, int W, int Cin, int Cout, int K) {
  if (!valid(B, H, W, Cin, Cout)) return -1;
  switch (K) {
    case 1: return chunks_k<1>(B, H, W, Cin, Cout);
    case 3: return chunks_k<3>(B, H, W, Cin, Cout);
    case 5: return chunks_k<5>(B, H, W, Cin, Cout);
    default: return -1;
  }
}

// dw [Cout, Cin, K, K] (OIHW) = the weight gradient of x [B,H,W,Cin] and
// g [B,H,W,Cout], float32; part is the scratch of evf_conv_dw_chunks
// (unused where it returns 1). Returns the first CUDA error of the
// launches, or 0.
int evf_conv_dw(const float* x, const float* g, float* part, float* dw,
                int B, int H, int W, int Cin, int Cout, int K, void* stream) {
  return conv_dw<float>(x, g, part, dw, B, H, W, Cin, Cout, K, stream);
}

// The same with x, g and dw bfloat16: the sum in float32 rounded once to
// dw; part stays float32.
int evf_conv_dw_bf16(const bf16* x, const bf16* g, float* part, bf16* dw,
                     int B, int H, int W, int Cin, int Cout, int K,
                     void* stream) {
  return conv_dw<bf16>(x, g, part, dw, B, H, W, Cin, Cout, K, stream);
}

}  // extern "C"
