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
// GEMM view: M = rows r = (dy*K + dx)*cr + ci over an output tile's cb
// input channels (cr = cb in float32, cb padded to 8 in bfloat16:
// row_channels), N = output channels, K = pixels. No im2col matrix exists:
// row r of the A operand at pixel p is the shared-memory halo tile of x
// read at p shifted by (dy, dx), so each lane keeps the halo offset of its
// rows in registers and the pixel only moves a base pointer. An output
// tile is K*K*CB rows (CB = 32 input channels, 8 at K = 5) by 32 output
// channels (8 where Cout <= 8). The plan (ops/conv_plan.py::b2_plan):
//
// - Pixel tiles of 128 pixels that span images: imgs images of th rows of
//   tw pixels (tw 32, 16 or 8), the fewest tiles, the wider on a tie, so
//   that an 8 x 8 map fills a tile with two images where the one-image
//   tile of 8 x 16 held 64 pixels; wherever one image's tile is among the
//   fewest it is the previous one-image tile, whose order the sums keep.
// - Items: one output tile over one chunk of the pixel tiles. The pixels
//   are split into chunks only where the output tiles leave SMs idle (the
//   FireNet shapes: one output tile, 256 chunks; the decoders'; none at
//   the U-Net's and the gates' deep shapes), into as many chunks as keep
//   the items within one round of two blocks per SM (a few items past it
//   make a second round that doubles the call), from the shape and the
//   SM count alone.
// - A persistent grid: as many blocks as the occupancy API says fit (two
//   per SM), no more than the items, each walking a run of consecutive
//   items through one ring of up to 4 staging buffers on mbarriers. A
//   buffer's halo tile of x and g tile each arrive as one TMA copy of a 4-D
//   box (channels x w x h x images) as wide as the padded pixel stride
//   below, so the hardware lays the pixels out at that stride (the
//   channels past the block are read and never multiplied; the border,
//   the images past B and the channels past C are zero-filled); where a
//   map's pixel rows are not whole 16-byte rows (2, 130, 258, 514
//   channels) or a pointer is not 16-byte aligned, the threads copy it by
//   cp.async (16 bytes where the channel count allows, else 8 or 4, a
//   synchronous store for an odd bfloat16 count) onto the same barrier.
//   The ring runs across items, so the next item's first tiles load during
//   this item's last MMAs and its epilogue.
//
// Both tiles are pixel-major with channels innermost. Warps split the rows
// (3 m16 tiles each) and, where the rows are few (the head's 2 input
// channels, the 1 x 1 heads), the pixels of a tile as well. g is zero at
// a tile's slots outside the map; where a tile overhangs the map (12 x 15
// and other maps that tiles do not divide, never the training maps) the
// MMAs also take x as zero there, so that a NaN or infinity in x's last
// rows or columns reaches only the taps of dw that read it.
//
// float32: the pixel stride is 8 or 24 mod 32 floats, so the 4 pixels x 8
// rows (or columns) of a fragment load hit 32 distinct banks; eight
// consecutive pixels of a tile are one k8 step of mma.sync.m16n8k8.
// Operands split as hi = tf32(a), lo = tf32(a - hi), rounded with integer
// operations (the conversion's bits at a quarter of its cost: the
// conversion's throughput set the per-step path at dense tiles), each
// product taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi into a fresh fragment
// per k8 step that is added to the FP32 accumulator on the CUDA cores (the
// tensor cores add by truncation; conv_tile.cuh's note). Where every x of
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
// exact products, a fresh fragment per step added in FP32.
//
// The epilogue and the fixed-order sum. A block's warps that split the
// pixels add their parts in shared memory in warp order (in a staging
// buffer just read where the tile fits there, else an area of its own),
// then the block writes its tile in OIHW order, one contiguous run of
// K*K*cb floats per output channel, to the result or, with several
// chunks, to its chunk's slice of the scratch; a second launch adds the
// chunks in a fixed order. No float atomics: the result is bitwise the
// same from run to run (not the one-image tiles' sums, whose pixels were
// added in another order).
//
// What bounds it: at the training recipe (8 x 128 x 128, 32 -> 32, k = 3)
// one call must read x and g once, 33.6 MB, 10.0 us at 3.35 TB/s; its
// 2.42 GFLOP take 4.9 us at the TF32 peak. At the U-Net's and the gates'
// deep maps the operations (E2VID's gate, 512 -> 1024 on 8 x 16 x 16:
// 19.3 GFLOP, 39 us at the TF32 peak, three times that in 3xTF32 at dense
// x) or the result's bytes (1024 -> 1024 at serving's 12 x 15: 37.7 MB of
// dw). On the card the per-step path (fragment loads, splits, FP32 adds,
// mma.sync) with 12 warps per SM sets the dense tiles' pace. Builds
// without the staging, the MMAs or the epilogue put a third of the deep
// maps' time in the threads' staging instructions, which TMA now takes
// over, and showed mma.sync's rate alone at a fifth of the bf16 peak
// (PERF.md). A variant with wgmma (g pre-split in shared memory as B) was
// no faster.

#include <algorithm>

#include "conv_s8.cuh"  // occupancy, align_up; conv_tile.cuh's copies, MMAs

namespace {

using evf::aligned;
using evf::bf16;
using evf::copy;
using evf::copy_step;
using evf::div_small;
using evf::ldsm_x2_t;
using evf::ldsm_x4_t;
using evf::mma;
using evf::mma_bf16;
using evf::put;
using evf::split_bits;

constexpr int PIX = 128;      // pixels per tile
constexpr int MW = 3;         // m16 tiles per warp
constexpr int MAX_WARPS = 8;
constexpr int NS_MAX = 4;     // staging buffers of the ring, at most
constexpr int SUM_THREADS = 256;
constexpr int MAX_SMEM = 232448;

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

__host__ __device__ inline int log2i(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

struct Geo {
  int B, H, W, Cin, Cout;
  // pixel tile: imgs images of th rows of tw pixels, 1 << pix_log pixels
  // an image
  int tw, tw_log, th, imgs, pix_log;
  int tiles_x, tiles_y, ntiles;  // pixel tiles
  int per_chunk, chunks;         // pixel tiles of a chunk, chunks
  int cblocks, coblocks, items;  // output tiles; items = chunks x those
  int wm, wk;                    // warps along the rows, along the pixels
  int vec_x, vec_g;              // elements per copy by the threads
  int x_tma, g_tma;              // x's halo tile, g's tile by TMA
  int ns;                        // staging buffers
  int stage_bytes;               // bytes of a staging buffer
  int out_alias;                 // the epilogue's tile in a read buffer
  int off_out;                   // else its byte offset
};

// The kernel's parameters: the TMA maps of x (boxes of a whole input
// channel block's halo, and of the last block's where it is narrower) and
// of g, the tensors, the geometry.
struct Params {
  CUtensorMap map_x, map_xl, map_g;
  const void *x, *g;
  void* dst;
  Geo geo;
};

constexpr int BARS = 128;  // bytes before the first staging buffer: the
                           // ring's mbarriers

// An item's output tile and chunk: input channels [c0, c0 + cb), output
// channels from co0, pixel tiles [t0, t0 + n).
struct Item {
  int c0, cb, co0, chunk, t0, n;
};

template <int K, int BN>
__device__ __forceinline__ Item item_of(const Geo& geo, int i) {
  const int outs = geo.cblocks * geo.coblocks;
  const int chunk = i / outs;
  const int o = i - chunk * outs;
  const int cbi = o / geo.coblocks;
  Item it;
  it.c0 = cbi * cblock<K>();
  it.cb = min(cblock<K>(), geo.Cin - it.c0);
  it.co0 = (o - cbi * geo.coblocks) * BN;
  it.chunk = chunk;
  it.t0 = chunk * geo.per_chunk;
  it.n = min(geo.per_chunk, geo.ntiles - it.t0);
  return it;
}

// the halo pixel of pixel p of a tile (p = (img * th + row) * tw + col)
__device__ __forceinline__ int halo_px(const Geo& geo, int p, int sw,
                                       int sh) {
  const int img = p >> geo.pix_log;
  const int r = p & ((1 << geo.pix_log) - 1);
  return (img * sh + (r >> geo.tw_log)) * sw + (r & (geo.tw - 1));
}

// The first image and origin of pixel tile `tile`.
struct Origin {
  int b0, y0, x0;
};

__device__ __forceinline__ Origin origin_of(const Geo& geo, int tile) {
  const int per_img = geo.tiles_x * geo.tiles_y;
  const int bt = tile / per_img;
  const int rem = tile - bt * per_img;
  return {bt * geo.imgs, (rem / geo.tiles_x) * geo.th,
          (rem % geo.tiles_x) * geo.tw};
}

// The pixel slots of a tile inside the map: images below `img`, rows below
// `row`, columns below `col` of each image's th x tw. A tile that overhangs
// the map (partial) zeroes x where a slot lies outside it: g is zero there,
// but a NaN or infinity of x's last rows or columns, read by such a slot's
// taps, would still make NaN * 0 = NaN in taps of dw that never read it.
struct Inside {
  int img, row, col;
  bool partial;
};

__device__ __forceinline__ Inside inside_of(const Geo& geo, const Origin& o) {
  Inside in;
  in.img = geo.B - o.b0;
  in.row = geo.H - o.y0;
  in.col = geo.W - o.x0;
  in.partial = in.img < geo.imgs || in.row < geo.th || in.col < geo.tw;
  return in;
}

__device__ __forceinline__ bool slot_inside(const Geo& geo, const Inside& in,
                                            int p) {
  const int r = p & ((1 << geo.pix_log) - 1);
  return (p >> geo.pix_log) < in.img && (r >> geo.tw_log) < in.row &&
         (r & (geo.tw - 1)) < in.col;
}

// bytes of a halo tile of cs channels a pixel, where the g tile starts
template <int K, class T>
__host__ __device__ inline int g_offset(const Geo& geo, int cs) {
  const int halo = geo.imgs * (geo.th + K - 1) * (geo.tw + K - 1) * cs *
                   (int)sizeof(T);
  return (halo + 127) & ~127;
}

// Stage pixel tile `tile`'s halo of the item's channels of x and its g
// tile of the item's columns into the buffer at s, completing on bar:
// each as one TMA copy where its map exists (thread 0; a box as wide as
// the halo stride, so the hardware lays the pixels out at that stride;
// the channels past the block are read and never multiplied, those past
// C are zero), else by every thread's cp.async; then every thread arrives.
// Does not wait.
template <int K, int BN, class T>
__device__ __forceinline__ void stage(const Params& p, T* s, uint64_t* bar,
                                      const Item& it, int tile) {
  constexpr int P = K / 2;
  constexpr int GS = evf::wstride<BN>();
  constexpr int ES = sizeof(T);
  const Geo& geo = p.geo;
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const int sw = geo.tw + K - 1;
  const int sh = geo.th + K - 1;
  const int cs = halo_stride<T>(it.cb);
  const Origin o = origin_of(geo, tile);
  const int b0 = o.b0, y0 = o.y0, x0 = o.x0;
  T* sg = s + g_offset<K, T>(geo, cs) / ES;
  if (threadIdx.x == 0 && (geo.x_tma || geo.g_tma)) {
    evf::s8::mbar_expect(
        bar, (geo.x_tma ? geo.imgs * sh * sw * cs * ES : 0) +
                 (geo.g_tma ? PIX * GS * ES : 0));
    if (geo.x_tma)
      evf::s8::tma_load(s,
                        it.cb == min(cblock<K>(), geo.Cin) ? &p.map_x
                                                            : &p.map_xl,
                        it.c0 * ES, x0 - P, y0 - P, b0, bar);
    if (geo.g_tma)
      evf::s8::tma_load(sg, &p.map_g, it.co0 * ES, x0, y0, b0, bar);
  }
  if (!geo.x_tma) {
    const int step_x = geo.vec_x;
    const int per_px = it.cb / step_x;  // cb is a multiple of step_x
    const float inv_px = 1.f / per_px;
    const float inv_sw = 1.f / sw;
    const float inv_img = 1.f / (sh * sw);
    for (int i = threadIdx.x; i < geo.imgs * sh * sw * per_px;
         i += blockDim.x) {
      const int q = div_small(i, inv_px);
      const int ci = (i - q * per_px) * step_x;
      const int img = div_small(q, inv_img);
      const int r = q - img * sh * sw;
      const int hy = div_small(r, inv_sw);
      const int b = b0 + img;
      const int gy = y0 + hy - P;
      const int gx = x0 + r - hy * sw - P;
      const bool ok = b < geo.B && gy >= 0 && gy < geo.H && gx >= 0 &&
                      gx < geo.W;
      const T* src = ok ? x + (((size_t)b * geo.H + gy) * geo.W + gx) *
                                  geo.Cin + it.c0 + ci
                        : x;
      copy(s + q * cs + ci, src, ok, step_x);
    }
  }
  if (!geo.g_tma) {
    // per_pg divides the block's 32 * w threads, so each thread keeps its
    // columns and walks the pixels
    const int step_g = geo.vec_g;
    const int per_pg = BN / step_g;
    const int o = (threadIdx.x % per_pg) * step_g;
    const int co = it.co0 + o;
    for (int q = threadIdx.x / per_pg; q < PIX; q += blockDim.x / per_pg) {
      const int r = q & ((1 << geo.pix_log) - 1);
      const int b = b0 + (q >> geo.pix_log);
      const int gy = y0 + (r >> geo.tw_log);
      const int gx = x0 + (r & (geo.tw - 1));
      const bool ok = b < geo.B && gy < geo.H && gx < geo.W && co < geo.Cout;
      const T* src = ok ? g + (((size_t)b * geo.H + gy) * geo.W + gx) *
                                  geo.Cout + co
                        : g;
      copy(sg + q * GS + o, src, ok, step_g);
    }
  }
  evf::s8::mbar_arrive_copies(bar);
}

// acc += this warp's share of one staged float32 tile: k8 steps wk,
// wk + nwk, ... of its 8-pixel steps. EXACT: every x of the tile is a TF32
// value (spikes, event counts), so x's lo part is zero and its product,
// zero, is skipped. PARTIAL: the tile overhangs the map, and x is taken as
// zero at its slots outside it (Inside).
template <int K, int NT, bool EXACT, bool PARTIAL>
__device__ __forceinline__ void tile_mma(float (&acc)[MW][NT][4],
                                         const float* sx, const float* sg,
                                         const int (&roff)[MW][2], int mt,
                                         int wk, const Geo& geo, int cs,
                                         const Inside& in) {
  constexpr int GS = evf::wstride<8 * NT>();
  const int sw = geo.tw + K - 1;
  const int sh = geo.th + K - 1;
  const int gq = (threadIdx.x & 31) >> 2;  // fragment row / column
  const int t = threadIdx.x & 3;           // fragment k
  for (int s = wk; s < PIX / 8; s += geo.wk) {
    const int p = 8 * s + t;  // k slot t; slot t + 4 is pixel p + 4
    // pixels p and p + 4 share a tile row (tw is a multiple of 8)
    const float* xa = sx + halo_px(geo, p, sw, sh) * cs;
    const float* xb = xa + 4 * cs;
    const float* gb = sg + p * GS + gq;
    const bool in_a = !PARTIAL || slot_inside(geo, in, p);
    const bool in_b = !PARTIAL || slot_inside(geo, in, p + 4);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      split_bits(gb[8 * n], bh[n][0], bl[n][0]);           // k t,   col gq
      split_bits(gb[4 * GS + 8 * n], bh[n][1], bl[n][1]);  // k t+4, col gq
    }
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (m >= mt) continue;
      const float a[4] = {in_a ? xa[roff[m][0]] : 0.f,   // row gq,   k t
                          in_a ? xa[roff[m][1]] : 0.f,   // row gq+8, k t
                          in_b ? xb[roff[m][0]] : 0.f,   // row gq,   k t+4
                          in_b ? xb[roff[m][1]] : 0.f};  // row gq+8, k t+4
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EXACT)
          ah[e] = __float_as_uint(a[e]);
        else
          split_bits(a[e], ah[e], al[e]);
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
// fragment added to acc in FP32. PARTIAL as in tile_mma.
template <int K, int NT, bool PARTIAL>
__device__ __forceinline__ void tile_mma_bf16(float (&acc)[MW][NT][4],
                                              const bf16* sx, const bf16* sg,
                                              const int (&aoff)[MW], int mt,
                                              int wk, const Geo& geo, int cs,
                                              const Inside& in) {
  constexpr int GS = evf::wstride<8 * NT>();
  const int sw = geo.tw + K - 1;
  const int sh = geo.th + K - 1;
  const int lane = threadIdx.x & 31;
  const int col = 8 * (lane >> 4);
  // PARTIAL: this lane's A pixels (the MMA's k) of step s are slots 16 s +
  // 2t, + 1 (a[0], a[1]) and + 8, + 9 (a[2], a[3]), one bfloat16 each half
  // of a register. Their columns repeat from step to step (tw 8, 16) or
  // every other step (tw 32, the row's halves), so the column test is made
  // once a tile, and a step tests the rows of slots 16 s + 2t and + 8.
  const int t2 = 2 * (lane & 3);
  uint32_t cols_lo[2] = {~0u, ~0u}, cols_hi[2] = {~0u, ~0u};
  if constexpr (PARTIAL) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (16 * h) & (geo.tw - 1);
      cols_lo[h] = ((c + ((t2) & (geo.tw - 1)) < in.col) ? 0xffffu : 0u) |
                   ((c + ((t2 + 1) & (geo.tw - 1)) < in.col) ? 0xffff0000u
                                                             : 0u);
      cols_hi[h] =
          ((c + ((t2 + 8) & (geo.tw - 1)) < in.col) ? 0xffffu : 0u) |
          ((c + ((t2 + 9) & (geo.tw - 1)) < in.col) ? 0xffff0000u : 0u);
    }
  }
  for (int s = wk; s < PIX / 16; s += geo.wk) {
    const int pa = 16 * s + (lane & 7) + col;
    const bf16* xa = sx + halo_px(geo, pa, sw, sh) * cs;
    const bf16* gb = sg + (16 * s + (lane & 15)) * GS + col;
    uint32_t keep_lo = ~0u, keep_hi = ~0u;
    if constexpr (PARTIAL) {
      const bool h = ((16 * s) & (geo.tw - 1)) != 0;
      const int pl = 16 * s + t2, ph = pl + 8;
      const int rows = geo.pix_log - geo.tw_log;  // log2 th
      const bool row_lo =
          (pl >> geo.pix_log) < in.img &&
          ((pl >> geo.tw_log) & ((1 << rows) - 1)) < in.row;
      const bool row_hi =
          (ph >> geo.pix_log) < in.img &&
          ((ph >> geo.tw_log) & ((1 << rows) - 1)) < in.row;
      // selects, not an indexed load, keep the masks in registers
      keep_lo = row_lo ? (h ? cols_lo[1] : cols_lo[0]) : 0u;
      keep_hi = row_hi ? (h ? cols_hi[1] : cols_hi[0]) : 0u;
    }
    uint32_t b[NT][2];
    if constexpr (NT == 1) {
      ldsm_x2_t(b[0], gb);
    } else {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t q[4];
        ldsm_x4_t(q, gb + 8 * n);
        b[n][0] = q[0];
        b[n][1] = q[1];
        b[n + 1][0] = q[2];
        b[n + 1][1] = q[3];
      }
    }
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (m >= mt) continue;
      uint32_t a[4];
      ldsm_x4_t(a, xa + aoff[m]);
      if constexpr (PARTIAL) {
        a[0] &= keep_lo;
        a[1] &= keep_lo;
        a[2] &= keep_hi;
        a[3] &= keep_hi;
      }
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

// A walk over the block's items and their pixel tiles.
struct Cursor {
  int item, tile;  // the item, its tile (0 .. n - 1)
};

// grid: min(items, the blocks the card holds); 32 * wm * wk threads.
// p.dst: the OIHW result in TO = T (one chunk) or the float32 [chunks,
// Cout*Cin*K*K] scratch.
template <int K, int NT, class T, class TO>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
    conv_dw_kernel(const __grid_constant__ Params p) {
  constexpr int KK = K * K;
  constexpr int BN = 8 * NT;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geo& geo = p.geo;
  TO* dst = static_cast<TO*>(p.dst);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  auto buf = [&](int s) {
    return reinterpret_cast<T*>(smem_raw + BARS + s * geo.stage_bytes);
  };

  const int warp = threadIdx.x >> 5;
  const int wm = warp % geo.wm;
  const int wk = warp / geo.wm;
  const int gq = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int sw = geo.tw + K - 1;
  const int sh = geo.th + K - 1;
  const int it0 = (int)((long long)blockIdx.x * geo.items / gridDim.x);
  const int it1 = (int)((long long)(blockIdx.x + 1) * geo.items / gridDim.x);
  const size_t numel = (size_t)geo.Cout * geo.Cin * KK;
  // the threads copy x's halo: in float32 its pad channels [cb, cs) are
  // never copied and must read as zeros for the TF32 test below (a
  // bfloat16 pad channel only feeds a row that is dropped; TMA writes
  // every byte of its box)
  const bool zero_pads = !BF16 && !geo.x_tma;

  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.ns; ++s) evf::s8::mbar_init(&full[s], blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (geo.x_tma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.map_x))
                   : "memory");
    if (geo.g_tma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.map_g))
                   : "memory");
  }
  if (zero_pads)
    for (int i = threadIdx.x; i < geo.ns * geo.stage_bytes / 4;
         i += blockDim.x)
      reinterpret_cast<uint32_t*>(smem_raw + BARS)[i] = 0u;
  __syncthreads();

  // the ring: stage the next tile of the walk (nothing past its end)
  Cursor in = {it0, 0};
  Item in_item = item_of<K, BN>(geo, it0);
  int issued = 0;
  auto issue_next = [&]() {
    if (in.item < it1) {
      const int s = issued % geo.ns;
      stage<K, BN, T>(p, buf(s), &full[s], in_item, in_item.t0 + in.tile);
      if (++in.tile == in_item.n) {
        in.tile = 0;
        if (++in.item < it1) in_item = item_of<K, BN>(geo, in.item);
      }
    }
    ++issued;
  };
  for (int s = 0; s < geo.ns - 1; ++s) issue_next();

  float acc[MW][NT][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  int step = 0;
  for (int i = it0; i < it1; ++i) {
    const Item it = item_of<K, BN>(geo, i);
    const int cs = halo_stride<T>(it.cb);
    const int cr = row_channels<T>(it.cb);  // channels of a tap's rows
    const int rows = KK * cr;
    const int outs = KK * it.cb;            // rows with a result
    // m16 tiles of this warp that hold rows (warp-uniform)
    const int mt = min(MW, (rows + 15) / 16 - wm * MW);
    // float32: the halo offset of rows gq and gq + 8 of each m16 tile;
    // bfloat16: of the first of the 8 rows of the half (lane / 8) % 2 that
    // this lane addresses for ldmatrix. A row past the tile's reads row 0
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
    const int halo = geo.imgs * sh * sw * cs;
    const int goff = g_offset<K, T>(geo, cs) / (int)sizeof(T);

    for (int tile = 0; tile < it.n; ++tile, ++step) {
      issue_next();
      const int s = step % geo.ns;
      evf::s8::mbar_wait(&full[s], (step / geo.ns) & 1);
      const T* sx = buf(s);
      const Inside in = inside_of(geo, origin_of(geo, it.t0 + tile));
      if constexpr (BF16) {
        if (mt > 0) {
          if (in.partial)
            tile_mma_bf16<K, NT, true>(acc, sx, sx + goff, aoff, mt, wk, geo,
                                       cs, in);
          else
            tile_mma_bf16<K, NT, false>(acc, sx, sx + goff, aoff, mt, wk,
                                        geo, cs, in);
        }
      } else {
        // is every staged x a TF32 value (its low 13 mantissa bits zero)?
        uint32_t low = 0;
        for (int j = threadIdx.x; j < halo; j += blockDim.x)
          low |= __float_as_uint(sx[j]) & 0x1fffu;
        const bool exact_tile = !__syncthreads_or(low != 0);
        if (mt > 0) {
          if (in.partial)
            tile_mma<K, NT, false, true>(acc, sx, sx + goff, roff, mt, wk,
                                         geo, cs, in);
          else if (exact_tile)
            tile_mma<K, NT, true, false>(acc, sx, sx + goff, roff, mt, wk,
                                         geo, cs, in);
          else
            tile_mma<K, NT, false, false>(acc, sx, sx + goff, roff, mt, wk,
                                          geo, cs, in);
        }
      }
      __syncthreads();  // every thread is done with this buffer
    }

    // The warps that split the pixels add their sums in warp order into
    // s_out [column][ci * KK + tap] (row stride odd), then the block writes
    // one contiguous OIHW run of outs elements per output channel. s_out
    // is the buffer just read where the tile fits there: the ring's other
    // buffers are in flight.
    float* s_out = reinterpret_cast<float*>(
        geo.out_alias ? reinterpret_cast<unsigned char*>(
                            buf((step - 1) % geo.ns))
                      : smem_raw + geo.off_out);
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
            if (BF16 && ci >= it.cb) continue;  // a pad channel's row
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
    const int ncol = min(BN, geo.Cout - it.co0);
    TO* out = dst + (size_t)it.chunk * numel;
    for (int j = threadIdx.x; j < ncol * outs; j += blockDim.x) {
      const int col = j / outs;
      const int e = j - col * outs;
      put(out + ((size_t)(it.co0 + col) * geo.Cin + it.c0) * KK + e,
          s_out[col * rs + e]);
    }
    if (geo.out_alias) {
      if (zero_pads) {
        __syncthreads();  // s_out is read
        // back to zeros, for the pad channels of the tiles staged there
        for (int j = threadIdx.x; j < BN * rs; j += blockDim.x)
          s_out[j] = 0.f;
      }
      // TMA writes this buffer next, after these threads' writes
      evf::s8::fence_async_smem();
    }
    __syncthreads();  // s_out is done with before its buffer is staged
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  }
}

// out[e] = sum over chunks of part[chunk, e], e < n, in a fixed order:
// one block per group of 32 elements, each of the NW warps sums a fixed
// stride of chunks, then the NW partials are added in warp order and the
// total rounded once to TO.
template <class TO>
__global__ void __launch_bounds__(SUM_THREADS)
    conv_dw_sum_kernel(const float* __restrict__ part, TO* __restrict__ out,
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

// The geometry of the plan (ops/conv_plan.py::b2_plan: pixel tile width
// tw and images imgs, chunks, ring buffers ns) and its shared memory
// (ops/conv_plan.py::b2_smem computes the same); -1 where the plan is not
// one the kernel takes.
template <int K, int NT, class T>
int make_geo(Geo& geo, int B, int H, int W, int Cin, int Cout, int tw,
             int imgs, int chunks, int ns) {
  constexpr int KK = K * K;
  constexpr int CB = cblock<K>();
  constexpr int BN = 8 * NT;
  if ((tw != 8 && tw != 16 && tw != 32) || imgs < 1 || tw * imgs > PIX ||
      (imgs & (imgs - 1)) || ns < 2 || ns > NS_MAX || chunks < 1)
    return -1;
  geo.B = B, geo.H = H, geo.W = W, geo.Cin = Cin, geo.Cout = Cout;
  geo.tw = tw;
  geo.tw_log = log2i(tw);
  geo.imgs = imgs;
  geo.th = PIX / (tw * imgs);
  geo.pix_log = log2i(geo.th * tw);
  geo.tiles_x = (W + tw - 1) / tw;
  geo.tiles_y = (H + geo.th - 1) / geo.th;
  geo.ntiles = ((B + imgs - 1) / imgs) * geo.tiles_x * geo.tiles_y;
  geo.per_chunk = (geo.ntiles + chunks - 1) / chunks;
  if ((geo.ntiles + geo.per_chunk - 1) / geo.per_chunk != chunks) return -1;
  geo.chunks = chunks;
  geo.cblocks = (Cin + CB - 1) / CB;
  geo.coblocks = (Cout + BN - 1) / BN;
  geo.items = chunks * geo.cblocks * geo.coblocks;
  const int mtiles = (KK * row_channels<T>(std::min(CB, Cin)) + 15) / 16;
  geo.wm = (mtiles + MW - 1) / MW;
  geo.wk = std::max(1, MAX_WARPS / geo.wm);
  geo.ns = ns;
  // a buffer: the halo tile of the widest block, the g tile from a
  // 128-byte boundary; buffers 128-byte aligned (TMA's destinations)
  geo.stage_bytes = evf::s8::align_up(
      g_offset<K, T>(geo, halo_stride<T>(std::min(CB, Cin))) +
          PIX * evf::wstride<BN>() * (int)sizeof(T),
      128);
  const int out_bytes = 4 * BN * ((KK * std::min(CB, Cin)) | 1);
  geo.out_alias = out_bytes <= geo.stage_bytes;
  geo.off_out = BARS + ns * geo.stage_bytes;
  const int smem = geo.off_out + (geo.out_alias ? 0 : out_bytes);
  return smem <= MAX_SMEM ? smem : -1;
}

// The map of an NHWC tensor of C elements of T a pixel for boxes of `box`
// elements a pixel over (w, h) pixels of `imgs` images; false where TMA
// does not take it (rows that are not whole 16-byte rows, an unaligned
// pointer).
template <class T>
bool encode_box(CUtensorMap* map, const void* base, const Geo& geo, int C,
                int box, int w, int h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)geo.W,
                              (cuuint64_t)geo.H, (cuuint64_t)geo.B};
  const cuuint32_t boxes[4] = {(cuuint32_t)(box * sizeof(T)), (cuuint32_t)w,
                               (cuuint32_t)h, (cuuint32_t)geo.imgs};
  return (C * sizeof(T)) % 16 == 0 && (box * sizeof(T)) % 16 == 0 &&
         evf::s8::encode(map, base, 4, dims, boxes, 0);
}

// blocks of kernel the card holds at once at `threads` and smem bytes,
// cached per kernel, shape of launch and device
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

template <int K, int NT, class T>
int run(const T* x, const T* g, float* part, T* out, int B, int H, int W,
        int Cin, int Cout, int tw, int imgs, int chunks, int ns,
        cudaStream_t st) {
  constexpr int CB = cblock<K>();
  Params p = {};
  Geo& geo = p.geo;
  const int smem =
      make_geo<K, NT, T>(geo, B, H, W, Cin, Cout, tw, imgs, chunks, ns);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.g = g;
  geo.vec_x = copy_step<T>(x, Cin);
  geo.vec_g = copy_step<T>(g, Cout);
  // the halo boxes of a whole block and of the last one where narrower;
  // g's box of the output tile's columns
  const int sw = tw + K - 1, sh = geo.th + K - 1;
  const int last = Cin - (geo.cblocks - 1) * CB;
  geo.x_tma = encode_box<T>(&p.map_x, x, geo, Cin,
                            halo_stride<T>(std::min(CB, Cin)), sw, sh) &&
              (last == CB || Cin < CB ||
               encode_box<T>(&p.map_xl, x, geo, Cin, halo_stride<T>(last),
                             sw, sh));
  geo.g_tma = encode_box<T>(&p.map_g, g, geo, Cout, evf::wstride<8 * NT>(),
                            tw, geo.th);
  const int threads = 32 * geo.wm * geo.wk;
  // the persistent grid: the items, or as many blocks as the card holds
  auto launch = [&](auto* kernel, void* dst) {
    int cap = 0;
    const cudaError_t e = block_capacity(
        reinterpret_cast<const void*>(kernel), threads, smem, &cap);
    if (e != cudaSuccess) return e;
    p.dst = dst;
    kernel<<<geo.items < cap ? geo.items : cap, threads, smem, st>>>(p);
    return cudaGetLastError();
  };
  if (chunks == 1)
    return static_cast<int>(launch(conv_dw_kernel<K, NT, T, T>, out));
  cudaError_t err = launch(conv_dw_kernel<K, NT, T, float>, part);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * K * Cin * Cout;
  conv_dw_sum_kernel<T><<<(n + 31) / 32, SUM_THREADS, 0, st>>>(part, out,
                                                              chunks, n);
  return static_cast<int>(cudaGetLastError());
}

template <int K, class T>
int run_k(const T* x, const T* g, float* part, T* out, int B, int H, int W,
          int Cin, int Cout, int tw, int imgs, int chunks, int ns,
          cudaStream_t st) {
  if (Cout <= 8)
    return run<K, 1, T>(x, g, part, out, B, H, W, Cin, Cout, tw, imgs,
                        chunks, ns, st);
  return run<K, 4, T>(x, g, part, out, B, H, W, Cin, Cout, tw, imgs, chunks,
                      ns, st);
}

bool valid(int B, int H, int W, int Cin, int Cout) {
  return B > 0 && H > 0 && W > 0 && Cin > 0 && Cout > 0;
}

template <class T>
int conv_dw(const T* x, const T* g, float* part, T* dw, int B, int H, int W,
            int Cin, int Cout, int K, int tw, int imgs, int chunks, int ns,
            void* stream) {
  if (!valid(B, H, W, Cin, Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return run_k<1, T>(x, g, part, dw, B, H, W, Cin, Cout, tw, imgs,
                         chunks, ns, st);
    case 3:
      return run_k<3, T>(x, g, part, dw, B, H, W, Cin, Cout, tw, imgs,
                         chunks, ns, st);
    case 5:
      return run_k<5, T>(x, g, part, dw, B, H, W, Cin, Cout, tw, imgs,
                         chunks, ns, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dw [Cout, Cin, K, K] (OIHW) = the weight gradient of x [B,H,W,Cin] and
// g [B,H,W,Cout], float32, on the plan of ops/conv_plan.py::b2_plan
// (pixel tile width tw, imgs images a tile, chunks of the pixel split, ns
// staging buffers); part is a float32 [chunks, Cout*Cin*K*K] scratch
// where chunks > 1 (unused at 1). Returns the first CUDA error of the
// launches, or 0.
int evf_conv_dw(const float* x, const float* g, float* part, float* dw,
                int B, int H, int W, int Cin, int Cout, int K, int tw,
                int imgs, int chunks, int ns, void* stream) {
  return conv_dw<float>(x, g, part, dw, B, H, W, Cin, Cout, K, tw, imgs,
                        chunks, ns, stream);
}

// The same with x, g and dw bfloat16: the sum in float32 rounded once to
// dw; part stays float32.
int evf_conv_dw_bf16(const bf16* x, const bf16* g, float* part, bf16* dw,
                     int B, int H, int W, int Cin, int Cout, int K, int tw,
                     int imgs, int chunks, int ns, void* stream) {
  return conv_dw<bf16>(x, g, part, dw, B, H, W, Cin, Cout, K, tw, imgs,
                       chunks, ns, stream);
}

}  // extern "C"
