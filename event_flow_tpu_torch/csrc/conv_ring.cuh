// The persistent float mainloop of K1 (conv.cu) and of K2 (fused_lif.cu:
// the feedforward cell, the recurrent one on one process, and the
// recurrent one where a mesh's model axis splits the cell's output
// channels, Crec != Cout: this rank's Cout of the cell's Crec, the input x
// and the recurrent input z_rec over every channel), for sm_90a: an
// implicit GEMM on the tensor cores, float32 operands in 3xTF32
// (mma.sync m16n8k8) or bfloat16 operands (mma.sync m16n8k16), whose next
// pass loads by TMA during the current pass's MMAs. Replaces
// event_flow_tpu/ops/conv_pallas.py::_conv_fwd (K1: the forward conv and,
// with the kernel flipped and its channels swapped, dx in _cp_bwd) and
// event_flow_tpu/ops/fused_lif_pallas.py::_fused_fwd (K2), also under
// JAX's GSPMD split of the cell (event_flow_tpu/parallel/mesh.py:45-58).
//
// What bounds it on the H100. K1 at the LIFFireNet dx (8 x 128 x 128, 32
// -> 32, k 3) moves 34 MB, 10 us at 3.35 TB/s, for 2.4 GFLOP (three times
// that in 3xTF32); at RecEVFlowNet's ConvGRU gate (8 x 8 x 8, 1024 ->
// 1024) it does 9.66 GFLOP, 19.5 us at the TF32 peak (58.6 in 3xTF32), on
// 512 output pixels, and at serving's 1 x 12 x 15 its 37.7 MB of weights
// take 11.3 us. K2 at the spiking U-Net's 8 x 8 x 8 cells (512 -> 512, 512
// recurrent) does 2.4 (4.8) GFLOP on 512 pixels, 4.9 (9.8) us at the TF32
// peak, and at LIFFireNet's cells moves 84 MB (x, v, z in; v', z' out),
// 25 us; bfloat16 half the bytes. The parent's K2 ran the one-process
// mainloop (conv_tile.cuh), which stages a pass, then multiplies, one 8 x
// 32 tile of one image a block, its weight rows restaged for every pass,
// with 32 output channels a block, and splits every float32 operand into
// TF32 hi and lo at each of the 9 taps that read it; at an 8 x 8 map its
// tile is a quarter full and 256 such tiles restage every weight. This
// one keeps loads in flight, converts each value once and fills its
// tiles:
//
// - Work. The output is cut into tiles of TILE = 256 pixels, imgs images
//   of th x tw each (tw 32, 16 or 8; imgs 1, 2, 4 or 8), so that the
//   U-Net's and the gates' 8 x 8 maps fill a tile with 4 images, and into
//   channel groups of CO output channels (8, 16 or 32); an item is one
//   tile of one group, group-major. The tiles, groups, split and ring are
//   ops/conv_plan.py's (k1_plan, k2_plan: the fewest tiles that fit, the
//   smaller halo on a tie; the group of the least estimated time), passed
//   in as integers; an item's passes are x's, then z_rec's.
// - A persistent grid: as many blocks (or clusters) as the occupancy API
//   says fit (one per SM in float32, two in bfloat16), no more than the
//   items, each walking a run of consecutive items, so its weights change
//   rarely.
// - Split K at serving's deep shapes (one image, 256 input channels or
//   more for K1, 512 for K2) whose items cannot fill the card (1 x 12 x
//   15, 1 x 24 x 30): the passes of an item are split over the `slices`
//   blocks of a thread-block cluster, and the first block adds the
//   others' float32 fragments from their shared memory in rank order (a
//   fixed order: bitwise repeatable, but not one process's sum order).
// - A ring of up to NS stages on mbarriers. A step is one pass of 32 input
//   channels of one item, x's passes, then z_rec's. Thread 0 issues a
//   step's halo tile as one TMA copy (cp.async.bulk.tensor over the NHWC
//   map, a 4-D box of 32 channels x (tw + k - 1) x (th + k - 1) x imgs
//   whose origin sits at (-p, -p) of every image, 128-byte float32 or
//   64-byte bfloat16 pixel rows under TMA's swizzle of that width; the
//   hardware zero-fills the border, which is each image's padding, the
//   images past B and the channels past C). x's pixels may lie Cs >= C
//   elements apart (a map whose channels are padded to whole 16-byte rows:
//   the U-Net decoders' inputs, ops/resize.py); TMA reads C channels of
//   each and zero-fills the rest of the box, so the pad is never read.
//   Where a contiguous map's pixel rows are not whole 16-byte rows (2, 5,
//   130 channels) or a pointer is not 16-byte aligned, the threads copy
//   the halo with cp.async into the same layout. Both complete on the
//   stage's mbarrier. The thread copies take contiguous maps only: a
//   padded map that TMA cannot stage is refused (the plan puts it on the
//   one-image tile, whose copies take the stride), since reading a stride
//   there changed the code the compiler made of the whole loop and cost
//   the TMA path 5 % at K1's bfloat16 deep maps on the H100 (PERF.md).
// - Weights once per channel group: the group's rows of every pass stay in
//   shared memory, reloaded where the group changes; where they do not
//   fit (the deep cells and gates) each stage carries its pass's rows.
//   Both arrive by cp.async, rows of the group's channels as w2 holds them.
// - 3xTF32 without re-splitting (float32). Once a stage has landed, the
//   threads split each of its values once into a TF32 hi plane and lo
//   plane of a work area (the resident weights are split once as they
//   land), the stage is free, and the next step's TMA copy into it is
//   issued before the taps: the taps read hi and lo fragments (A by
//   ldmatrix, B by 32-bit loads) and convert nothing. The split rounds
//   with integer operations, the conversion instruction's bits for every
//   finite value, and keeps a NaN a NaN (conv_tile.cuh::split_bits).
//   Splitting A as the taps load it, as the one-process mainloop does,
//   measured slower on the H100 although it halves A's shared-memory
//   reads (PERF.md). bfloat16 taps read the landed stage itself.
// - The epilogue. K1 stores y from the fragments, element pairs per lane
//   (32 contiguous bytes a quad of lanes in float32). K2: at an item's
//   first pass each lane loads its v and z (4 channels of one pixel per
//   n8 tile, 16 float32 or 8 bfloat16 bytes) into registers, leak and
//   threshold in the epilogue; the epilogue swaps half of each
//   accumulator fragment with the neighbouring lane so that each lane
//   holds those 4 channels, and stores v' and z' as 16 (8) bytes a lane.
//   Where Cout is not a multiple of 4 or a pointer not aligned, it reads
//   and writes element by element. Pixels in an image past B load and
//   store nothing. A group of 32
//   needs about 190 registers a thread in bfloat16 too, so that instance
//   runs one block a SM in either type.
// - A warp whose pixels lie outside the map (below a map shorter than the
//   tile, or in an image past B) skips the taps.
//
// What bounds it: at LIFFireNet's cells the float32 taps load A's hi and
// lo planes and B's words, 24 shared-memory wavefronts per warp for 12
// MMAs at a group of 16 (32 for 24 at 32), so the shared-memory port and
// the mma.sync pipe set their time; one block per SM (about 200 KB of
// shared memory) leaves the split, the epilogue and the stores to overlap
// little with them; in bfloat16 two blocks share an SM.
//
// What it keeps: each output element's float operations and their order
// are one process's (conv_tile.cuh::accumulate, the parent tree's K1 and
// K2): x's passes of up to 32 channels padded to the MMA's k, then
// z_rec's; the taps in order; each k8 step (bfloat16: k16; a pass of 8 mod
// 16 channels ends in a step whose upper 8 channels are zero in both
// operands) into a fresh fragment, in float32 the terms lo*hi, hi*lo,
// hi*hi in that order, added to the FP32 accumulator on the CUDA cores;
// the LIF update's expression (fused_lif.cu). So K1's y is bitwise the
// one-process K1's, and K2's v' and z' the one-process K2's, wherever the
// plan does not split K; K2 rec's v' and z' under the model axis are
// bitwise the one-process cell's channels [r Cout, (r + 1) Cout). bfloat16
// K1 at the deep maps does not run here: ops/conv_plan.py::wgmma_route
// sends it to the warpgroup-MMA mainloop of conv_wgmma.cuh, whose sums run
// in the tensor core's own fixed order (float32 K1 stays here, bitwise).

#pragma once

#include "conv_s8.cuh"  // mbarriers, TMA copies and maps, occupancy

namespace evf {
namespace ring {

constexpr int TILE = 256;        // output pixels per tile: 8 warps x 32
constexpr int NS = 4;            // stages of the ring, at most
constexpr int ALIGN = 1024;      // a swizzle pattern's span
// two blocks per SM: 228 KB less 1 KB reserved per block, halved
constexpr int HALF_SMEM = 115712;
constexpr int MAX_SLICES = 4;    // blocks of a cluster splitting K

// how a map's halo tile arrives
enum Halo { kTma = 0, kCopy = 1 };

// A call of K2 (fused_lif.cu's arguments; zr null for the feedforward
// cell) with its plan (ops/conv_plan.py::k2_plan), whose fields are
// ConvCall's below.
struct Call {
  const void *x, *w2, *zr, *wr2, *v, *z;
  const float *leak, *thresh;
  void *v_out, *z_out;
  int B, H, W, Cin, Cs, Cout, Crec, K;  // Cs: x's pixel stride
  bool hard;
  int tw, imgs, co, slices, ns, resident;
};

cudaError_t launch_f32(const Call& c, cudaStream_t st);
cudaError_t launch_bf16(const Call& c, cudaStream_t st);

// A call of K1 (conv.cu) with its plan (ops/conv_plan.py::k1_plan): x's
// pixel stride Cs (>= Cin), tile width tw and images imgs of a tile,
// channel group co, blocks per cluster slices, ring stages ns, weights
// resident or streamed.
struct ConvCall {
  const void *x, *w2;
  void* y;
  int B, H, W, Cin, Cs, Cout, K;
  int tw, imgs, co, slices, ns, resident;
};

struct Params {
  CUtensorMap map_x, map_zr;  // the halo of x and of z_rec (kTma)
  const void *x, *w2, *zr, *wr2, *v, *z;
  const float *leak, *thresh;
  void *v_out, *z_out, *y;
  int B, H, W, Cin, Cout, Crec;
  // the plan: a tile is imgs images of th x (1 << tw_shift) pixels,
  // 1 << px_shift of them an image
  int tw_shift, px_shift, th, imgs, tiles_x, tiles_y, tiles, items, px,
      passes, slices;
  int halo_x, halo_zr;    // Halo of each map
  int step_x, step_zr;    // elements per copy of a kCopy halo
  int step_w, step_wr;    // elements per copy of streamed weight rows
  int out4;               // K2 rec: the 4-channel epilogue
  int out2;               // K1: y stored as element pairs
  int pads_zero;          // every step staged by the threads has the same
                          // channels past C, zeroed once in every stage
  // the memory plan
  int ns, resident;
  int halo_bytes, stage_bytes, w_pass_bytes;
  int off_stage, off_work, off_w, off_red;
};

template <class T>
struct Lay {
  static constexpr int ROW = 32 * (int)sizeof(T);  // bytes of a staged row
  static constexpr int SWZ = sizeof(T) == 4 ? 0x70 : 0x30;  // TMA swizzle
};

// The first image, the origin and the channel group of item `item`.
struct Tile {
  int b, y0, x0, co0;
};

template <int CO>
__device__ __forceinline__ Tile tile_of(const Params& p, int item) {
  const int g = item / p.tiles;
  const int t = item - g * p.tiles;
  const int per_image = p.tiles_x * p.tiles_y;
  const int bt = t / per_image;
  const int r = t - bt * per_image;
  const int ty = r / p.tiles_x;
  return {bt * p.imgs, ty * p.th, (r - ty * p.tiles_x) << p.tw_shift,
          g * CO};
}

// Pixel q (0 .. TILE - 1) of a tile: its image, row and column in the
// tile (q = (img * th + row) * tw + col)
struct Pix {
  int img, row, col;
};

__device__ __forceinline__ Pix pix_of(const Params& p, int q) {
  const int r = q & ((1 << p.px_shift) - 1);
  return {q >> p.px_shift, r >> p.tw_shift, r & ((1 << p.tw_shift) - 1)};
}

// the NHWC pixel index of pixel q of tile tl, or -1 outside the map
__device__ __forceinline__ long long pixel_index(const Params& p,
                                                 const Tile& tl, int q) {
  const Pix x = pix_of(p, q);
  const int b = tl.b + x.img, gy = tl.y0 + x.row, gx = tl.x0 + x.col;
  if (b >= p.B || gy >= p.H || gx >= p.W) return -1;
  return ((long long)b * p.H + gy) * p.W + gx;
}

// The halo's source of pass `pass`: x's or z_rec's channels [c0, c0 + 32).
template <class T>
struct Segment {
  const T *src, *w;
  int C, c0, mode, step, step_w;
  const CUtensorMap* map;
};

template <class T>
__device__ __forceinline__ Segment<T> segment(const Params& p, int pass) {
  if (pass >= p.px)
    return {static_cast<const T*>(p.zr), static_cast<const T*>(p.wr2),
            p.Crec, (pass - p.px) * CCH, p.halo_zr, p.step_zr, p.step_wr,
            &p.map_zr};
  return {static_cast<const T*>(p.x), static_cast<const T*>(p.w2), p.Cin,
          pass * CCH, p.halo_x, p.step_x, p.step_w, &p.map_x};
}

// Channels of a staged row that the taps of a pass of cpad channels read:
// float32 k8 steps, bfloat16 k16 steps
template <class T>
__host__ __device__ __forceinline__ int read_channels(int cpad) {
  return sizeof(T) == 4 ? cpad : (cpad + 15) & ~15;
}

// The halo tile of sg's pass for tile tl into dst by the threads' copies,
// as TMA lays it out: pixel-major rows of 32 channels, image after image,
// under the swizzle, zero outside the image, past B and past C; only the
// channels the taps read (a row's others are never read), and of those
// past C none where p.pads_zero says they hold zeros already.
// Consecutive threads take consecutive copies of a pixel, so a warp's
// reads are runs of each pixel's channels; where a pixel's copies divide
// the block, each thread keeps its channels and walks the pixels.
template <int K, class T>
__device__ __forceinline__ void copy_halo(const Params& p, unsigned char* dst,
                                          const Segment<T>& sg,
                                          const Tile& tl) {
  constexpr int P = K / 2;
  const int SW = (1 << p.tw_shift) + K - 1;
  const int SH = p.th + K - 1;
  const int data = min(sg.C - sg.c0, CCH);  // channels of the pass
  const int n = (p.pads_zero ? data
                             : read_channels<T>(pass_pad(sg.C, sg.c0))) /
                sg.step;  // copies a pixel: a multiple of step either way
  const float inv_img = 1.f / (SH * SW), inv_sw = 1.f / SW;
  const bool fixed = NT % n == 0;
  const int j0 = fixed ? (threadIdx.x % n) * sg.step : 0;
  const int total = p.imgs * SH * SW * (fixed ? 1 : n);
  for (int i = fixed ? threadIdx.x / n : threadIdx.x; i < total;
       i += fixed ? NT / n : NT) {
    const int q = fixed ? i : i / n;
    const int j = fixed ? j0 : (i - q * n) * sg.step;
    const int img = div_small(q, inv_img);
    const int rem = q - img * SH * SW;
    const int hy = div_small(rem, inv_sw);
    const int b = tl.b + img;
    const int gy = tl.y0 + hy - P;
    const int gx = tl.x0 + rem - hy * SW - P;
    const bool ok = b < p.B && gy >= 0 && gy < p.H && gx >= 0 &&
                    gx < p.W && j < data;
    const T* g =
        ok ? sg.src + (((size_t)b * p.H + gy) * p.W + gx) * sg.C + sg.c0 + j
           : sg.src;
    copy(reinterpret_cast<T*>(
             dst + s8::swizzle(q * Lay<T>::ROW + j * (int)sizeof(T),
                               Lay<T>::SWZ)),
         g, ok, sg.step);
  }
}

// A pass's weight rows for CO output channels, rows r = tap * 32 +
// input channel: float32 rows of CO values (the B fragments' scalar
// loads), the 8-channel blocks of a row permuted by the row so that a
// warp's loads fall on 32 distinct banks (at CO 16 the two halves swapped
// on every other pair of rows, at CO 32 block n stored at n XOR (r mod
// 4)); bfloat16 rows wstride<CO>() apart, the layout ldmatrix.trans reads
// (conv_tile.cuh::taps_bf16). w_at is the element index of (r, n).
template <int CO, class T>
__host__ __device__ constexpr int w_at(int r, int n) {
  return sizeof(T) == 4
             ? r * CO + (CO == 16   ? n ^ (((r >> 1) & 1) << 3)
                         : CO == 32 ? n ^ ((r & 3) << 3)
                                    : n)
             : r * wstride<CO>() + n;
}

template <int K, int CO, class T>
__host__ __device__ constexpr int w_pass_elems() {
  return K * K * CCH * (sizeof(T) == 4 ? CO : wstride<CO>());
}

// The weight rows of sg's pass for output channels co0 .. co0 + CO into
// dst from w2 [K*K*C, Cout] by cp.async (rows of CO channels are
// contiguous there); zero past C and Cout.
template <int K, int CO, class T>
__device__ __forceinline__ void copy_weights(const Params& p, T* dst,
                                             const Segment<T>& sg, int co0) {
  const int per_row = CO / sg.step_w;
  for (int i = threadIdx.x; i < K * K * CCH * per_row; i += NT) {
    const int r = i / per_row;
    const int o = (i - r * per_row) * sg.step_w;
    const int t = r / CCH;
    const int c = sg.c0 + r - t * CCH;
    const int co = co0 + o;
    const bool ok = c < sg.C && co < p.Cout;
    const T* g = ok ? sg.w + ((size_t)t * sg.C + c) * p.Cout + co : sg.w;
    copy(dst + w_at<CO, T>(r, o), g, ok, sg.step_w);
  }
}

// The block's view of the plan: its cluster's items from it0, its np
// passes from pa0 (all of them where no cluster splits K).
struct Walk {
  int it0, pa0, np;
};

// Issue step `step` of the block's walk into ring stage step % ns: the
// pass's halo tile, and its weight rows unless they are resident; then
// arrive on the stage's barrier. Every thread calls it.
template <int K, int CO, class T>
__device__ __forceinline__ void issue(const Params& p, unsigned char* smem,
                                      uint64_t* full, const Walk& w,
                                      int step) {
  constexpr int P = K / 2;
  const int local = step / w.np;
  const int pass = w.pa0 + step - local * w.np;
  const Tile tl = tile_of<CO>(p, w.it0 + local);
  uint64_t* bar = &full[step % p.ns];
  unsigned char* dst = smem + p.off_stage + (step % p.ns) * p.stage_bytes;
  const Segment<T> sg = segment<T>(p, pass);
  if (sg.mode == kTma) {
    if (threadIdx.x == 0) {
      const int SW = (1 << p.tw_shift) + K - 1;
      s8::mbar_expect(bar, p.imgs * (p.th + K - 1) * SW * Lay<T>::ROW);
      s8::tma_load(dst, sg.map, sg.c0 * (int)sizeof(T), tl.x0 - P,
                   tl.y0 - P, tl.b, bar);
    }
  } else {
    copy_halo<K, T>(p, dst, sg, tl);
  }
  if (!p.resident)
    copy_weights<K, CO, T>(p, reinterpret_cast<T*>(dst + p.halo_bytes), sg,
                           tl.co0);
  s8::mbar_arrive_copies(bar);
}

// the thread's cp.async copies, landed, then the block's
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// 16 bytes of float32 values into their TF32 hi and lo parts
__device__ __forceinline__ void split4(const float4& a, uint4& hi, uint4& lo) {
  split_bits(a.x, hi.x, lo.x);
  split_bits(a.y, hi.y, lo.y);
  split_bits(a.z, hi.z, lo.z);
  split_bits(a.w, hi.w, lo.w);
}

// Channel group co0's weight rows of the block's passes into shared
// memory by cp.async, pass after pass, all copies in flight together; does
// not wait.
template <int K, int CO, class T>
__device__ __forceinline__ void stage_weights(const Params& p,
                                              unsigned char* smem,
                                              const Walk& wk, int co0) {
  constexpr int PE = w_pass_elems<K, CO, T>();
  T* w = reinterpret_cast<T*>(smem + p.off_w);
  for (int k = 0; k < wk.np; ++k)
    copy_weights<K, CO, T>(p, w + k * PE, segment<T>(p, wk.pa0 + k), co0);
}

// Landed float32 resident weights, split in place into the TF32 hi plane
// and a lo plane after it; the caller synchronizes before they are read.
template <int K, int CO>
__device__ __forceinline__ void split_weights(const Params& p,
                                              unsigned char* smem,
                                              const Walk& wk) {
  constexpr int PE = w_pass_elems<K, CO, float>();
  uint4* hi = reinterpret_cast<uint4*>(smem + p.off_w);
  uint4* lo = hi + wk.np * PE / 4;
  for (int i = threadIdx.x; i < wk.np * PE / 4; i += NT) {
    const uint4 raw = hi[i];
    uint4 h, l;
    split4(*reinterpret_cast<const float4*>(&raw), h, l);
    hi[i] = h;
    lo[i] = l;
  }
}

// Channel group co0's weights staged, landed and (float32) split. Every
// thread calls it between steps; it returns with the weights in place.
template <int K, int CO, class T>
__device__ __forceinline__ void load_weights(const Params& p,
                                             unsigned char* smem,
                                             const Walk& wk, int co0) {
  stage_weights<K, CO, T>(p, smem, wk, co0);
  copies_landed();
  if constexpr (sizeof(T) == 4) {
    split_weights<K, CO>(p, smem, wk);
    __syncthreads();
  }
}

// A landed float32 stage, value by value, into the TF32 hi and lo planes
// of the work area, in its own layout: the halo tile, and the weight rows
// where they are streamed.
template <int K, int CO>
__device__ __forceinline__ void split_stage(const Params& p,
                                            const unsigned char* src,
                                            unsigned char* work, int cpad) {
  if (cpad == CCH) {
    for (int i = threadIdx.x; i < p.halo_bytes / 16; i += NT) {
      uint4 hi, lo;
      split4(reinterpret_cast<const float4*>(src)[i], hi, lo);
      reinterpret_cast<uint4*>(work)[i] = hi;
      reinterpret_cast<uint4*>(work + p.halo_bytes)[i] = lo;
    }
  } else {
    // the 16-byte chunks of each halo pixel that the taps read
    const int n = cpad / 4;
    const int px = p.imgs * (p.th + K - 1) * ((1 << p.tw_shift) + K - 1);
    for (int i = threadIdx.x; i < px * n; i += NT) {
      const int q = i / n;
      const int off = s8::swizzle(q * 128 + (i - q * n) * 16, 0x70);
      uint4 hi, lo;
      split4(*reinterpret_cast<const float4*>(src + off), hi, lo);
      *reinterpret_cast<uint4*>(work + off) = hi;
      *reinterpret_cast<uint4*>(work + p.halo_bytes + off) = lo;
    }
  }
  if (p.resident) return;
  const float4* w = reinterpret_cast<const float4*>(src + p.halo_bytes);
  uint4* w_hi = reinterpret_cast<uint4*>(work + 2 * p.halo_bytes);
  uint4* w_lo = reinterpret_cast<uint4*>(work + 2 * p.halo_bytes +
                                         p.w_pass_bytes);
  for (int i = threadIdx.x; i < w_pass_elems<K, CO, float>() / 4; i += NT)
    split4(w[i], w_hi[i], w_lo[i]);
}

// acc += every tap of a float32 pass of cpad channels in 3xTF32. A: one
// ldmatrix.x4 per m16 tile and plane, lane l addressing pixel a_pix[m]
// (row l % 16 of the m16 tile, shifted by the tap) at 16-byte chunk
// kk / 4 + l / 16: 32-bit words read as pairs of 16-bit values, so the
// four matrices are the m16n8k8 TF32 fragment (pixels 0-7 and 8-15 at k
// 0-3, then at k 4-7). B: the fragment's two words per n8 tile and plane,
// (k t, channel g) and (k t + 4, channel g) of lane 4 g + t, from the
// weight rows (w_at). Each k8 step goes into a fresh fragment, lo*hi,
// hi*lo, hi*hi, added to acc in FP32.
template <int K, int CO, bool FULL>
__device__ __forceinline__ void taps_f32(float (&acc)[MT][CO / 8][4],
                                         const unsigned char* a_hi,
                                         const unsigned char* a_lo,
                                         const uint32_t* b_hi,
                                         const uint32_t* b_lo,
                                         const int (&a_pix)[MT], int SW,
                                         int cpad) {
  const int lane = threadIdx.x & 31;
  const int ca = lane >> 4;
  const int t = lane & 3;
  // the row's permutation of the 8-channel blocks (w_at)
  const int s = CO == 16 ? (t >> 1) & 1 : CO == 32 ? t : 0;
#pragma unroll 1
  for (int tap = 0; tap < K * K; ++tap) {
    const int dy = tap / K;
    const int shift = dy * SW + tap - dy * K;
    const int b_row = (tap * CCH + t) * CO + (lane >> 2);
#pragma unroll
    for (int kk = 0; kk < CCH; kk += 8) {
      if (!FULL && kk >= cpad) break;
      const int ch = kk >> 2;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int off =
            s8::swizzle((a_pix[m] + shift) * 128 + (ch + ca) * 16, 0x70);
        ldsm_x4(ah[m], a_hi + off);
        ldsm_x4(al[m], a_lo + off);
      }
      uint32_t bh[CO / 8][2], bl[CO / 8][2];
#pragma unroll
      for (int n = 0; n < CO / 8; ++n) {
        const int i = b_row + kk * CO + 8 * (n ^ s);
        bh[n][0] = b_hi[i];
        bh[n][1] = b_hi[i + 4 * CO];
        bl[n][0] = b_lo[i];
        bl[n][1] = b_lo[i + 4 * CO];
      }
#pragma unroll
      for (int n = 0; n < CO / 8; ++n)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float part[4] = {};
          mma(part, al[m], bh[n]);
          mma(part, ah[m], bl[n]);
          mma(part, ah[m], bh[n]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] += part[r];
        }
    }
  }
}
// acc += every tap of a bfloat16 pass of cpad channels: per k16 step one
// ldmatrix.x4 per m16 tile from the swizzled halo (as taps_f32, chunk kk
// / 8 + l / 16) and one ldmatrix.x4.trans per two n8 tiles from the
// k-major weight rows (conv_tile.cuh::taps_bf16), one m16n8k16 MMA per
// m16 x n8 tile into a fresh fragment added to acc in FP32. A pass of 8
// mod 16 channels ends in a step whose upper 8 channels are zero in the
// halo and the weights.
template <int K, int CO, bool FULL>
__device__ __forceinline__ void taps_bf16(float (&acc)[MT][CO / 8][4],
                                          const unsigned char* s_in,
                                          const bf16* s_w,
                                          const int (&a_pix)[MT], int SW,
                                          int cpad) {
  constexpr int WS = wstride<CO>();
  const int lane = threadIdx.x & 31;
  const int ca = lane >> 4;
  const int row = lane & 15;
  const int col = CO == 8 ? 0 : 8 * (lane >> 4);
#pragma unroll 1
  for (int tap = 0; tap < K * K; ++tap) {
    const int dy = tap / K;
    const int shift = dy * SW + tap - dy * K;
    const bf16* b_k = s_w + (tap * CCH + row) * WS + col;
#pragma unroll
    for (int kk = 0; kk < CCH; kk += 16) {
      if (!FULL && kk >= cpad) break;
      const int ch = kk >> 3;
      uint32_t af[MT][4], bfr[CO / 8][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(af[m], s_in + s8::swizzle((a_pix[m] + shift) * 64 +
                                              (ch + ca) * 16,
                                          0x30));
      const bf16* b = b_k + kk * WS;
      if constexpr (CO == 8) {
        ldsm_x2_t(bfr[0], b);
      } else {
#pragma unroll
        for (int n = 0; n < CO / 8; n += 2) {
          uint32_t q[4];
          ldsm_x4_t(q, b + 8 * n);
          bfr[n][0] = q[0];
          bfr[n][1] = q[1];
          bfr[n + 1][0] = q[2];
          bfr[n + 1][1] = q[3];
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

// 4 consecutive elements of T as one load or store
template <class T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
  __device__ static void get(const type& q, float (&f)[4]) {
    f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
  }
  __device__ static type make(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Quad<bf16> {
  using type = uint2;
  __device__ static void get(const type& q, float (&f)[4]) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
  __device__ static type make(const float (&f)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};

// The 4-channel epilogue's lane view: for m16 tile m and n8 tile n, the
// lane holds pixel 16 m + lane / 4 + 8 (lane % 2) of its warp's 32 and
// channels 8 n + 4 ((lane % 4) / 2) .. + 3 of the group. Leak and
// threshold are read in the epilogue (a few cached bytes), which keeps a
// group of 32's float32 state within the registers without spilling.
template <int CO, class T>
struct State {
  typename Quad<T>::type v[MT][CO / 8], z[MT][CO / 8];
};

// the NHWC index of the lane's first element of (m, n), or -1 outside
// the map or past Cout
template <int CO>
__device__ __forceinline__ long long quad_index(const Params& p,
                                                const Tile& tl, int m,
                                                int n) {
  const int lane = threadIdx.x & 31;
  const int q = 32 * (threadIdx.x >> 5) + 16 * m + (lane >> 2) +
                8 * (lane & 1);
  const int co = tl.co0 + 8 * n + 4 * ((lane & 3) >> 1);
  const long long pix = pixel_index(p, tl, q);
  if (pix < 0 || co >= p.Cout) return -1;
  return pix * p.Cout + co;
}

// the lane's v and z of the item, at its first pass
template <int CO, class T>
__device__ __forceinline__ void load_state(const Params& p, const Tile& tl,
                                           State<CO, T>& s) {
  using Q = typename Quad<T>::type;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < CO / 8; ++n) {
      const long long i = quad_index<CO>(p, tl, m, n);
      if (i < 0) continue;
      s.v[m][n] = *reinterpret_cast<const Q*>(static_cast<const T*>(p.v) + i);
      s.z[m][n] = *reinterpret_cast<const Q*>(static_cast<const T*>(p.z) + i);
    }
}

// The LIF update of one element, as fused_lif.cu's K2 writes it (the JAX
// cells' expression order).
template <bool HARD>
__device__ __forceinline__ void lif(float vv, float zz, float l, float th,
                                    float cur, float& vn, float& zn) {
  vn = HARD ? vv * l * (1.f - zz) + (1.f - l) * cur
            : vv * l + (1.f - l) * cur - zz * th;
  zn = (vn - th > 0.f) ? 1.f : 0.f;
}

// The item's epilogue. acc[m][n][e] is pixel 16 m + lane / 4 + 8 (e / 2)
// of the warp's 32, channel 8 n + 2 (lane % 4) + e % 2 of the group.
template <int CO, bool HARD, class T>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& tl,
                                         const float (&acc)[MT][CO / 8][4],
                                         const State<CO, T>& s) {
  using Q = Quad<T>;
  const int lane = threadIdx.x & 31;
  if (p.out4) {
    const bool odd = lane & 1;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < CO / 8; ++n) {
        // the even lane of a pair keeps pixel g's channels and takes its
        // neighbour's, the odd lane pixel g + 8's
        const float* a = acc[m][n];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        const long long i = quad_index<CO>(p, tl, m, n);
        if (i < 0) continue;
        const float cur[4] = {odd ? r0 : a[0], odd ? r1 : a[1],
                              odd ? a[2] : r0, odd ? a[3] : r1};
        const int co = tl.co0 + 8 * n + 4 * ((lane & 3) >> 1);
        const float4 l = __ldg(reinterpret_cast<const float4*>(p.leak + co));
        const float4 th =
            __ldg(reinterpret_cast<const float4*>(p.thresh + co));
        const float ls[4] = {l.x, l.y, l.z, l.w};
        const float ts[4] = {th.x, th.y, th.z, th.w};
        float vv[4], zz[4], vn[4], zn[4];
        Q::get(s.v[m][n], vv);
        Q::get(s.z[m][n], zz);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lif<HARD>(vv[e], zz[e], ls[e], ts[e], cur[e], vn[e], zn[e]);
        *reinterpret_cast<typename Q::type*>(static_cast<T*>(p.v_out) + i) =
            Q::make(vn);
        *reinterpret_cast<typename Q::type*>(static_cast<T*>(p.z_out) + i) =
            Q::make(zn);
      }
    return;
  }
  const T* v = static_cast<const T*>(p.v);
  const T* z = static_cast<const T*>(p.z);
  T* v_out = static_cast<T*>(p.v_out);
  T* z_out = static_cast<T*>(p.z_out);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long pix = pixel_index(
          p, tl, 32 * (threadIdx.x >> 5) + 16 * m + 8 * h + (lane >> 2));
      if (pix < 0) continue;
#pragma unroll
      for (int n = 0; n < CO / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = tl.co0 + 8 * n + 2 * (lane & 3) + e;
          if (co >= p.Cout) continue;
          const size_t i = pix * p.Cout + co;
          float vn, zn;
          lif<HARD>(widen(v[i]), widen(z[i]), p.leak[co], p.thresh[co],
                    acc[m][n][2 * h + e], vn, zn);
          put(v_out + i, vn);
          put(z_out + i, zn);
        }
    }
}

// K1's epilogue: y from the fragments, acc[m][n][e] being pixel 16 m +
// lane / 4 + 8 (e / 2) of the warp's 32 and channel 8 n + 2 (lane % 4) +
// e % 2 of the group; element pairs where p.out2, else one by one.
template <int CO, class T>
__device__ __forceinline__ void store(const Params& p, const Tile& tl,
                                      const float (&acc)[MT][CO / 8][4]) {
  T* y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long pix = pixel_index(
          p, tl, 32 * (threadIdx.x >> 5) + 16 * m + 8 * h + (lane >> 2));
      if (pix < 0) continue;
#pragma unroll
      for (int n = 0; n < CO / 8; ++n) {
        const int co = tl.co0 + 8 * n + 2 * (lane & 3);
        if (co >= p.Cout) continue;
        const float a0 = acc[m][n][2 * h], a1 = acc[m][n][2 * h + 1];
        T* o = y + pix * p.Cout + co;
        if (p.out2) {
          put2(o, a0, a1);
        } else {
          put(o, a0);
          if (co + 1 < p.Cout) put(o + 1, a1);
        }
      }
    }
}

// The whole kernel: this block's walk over its cluster's items and its
// passes, through the ring; at each item's last pass the cluster's sum
// where the passes are split, then (in its first block) the epilogue: the
// LIF update (K2 rec) or the store of y (K1).
template <int K, int CO, bool HARD, class T, bool LIF>
__device__ __forceinline__ void run(const Params& p) {
  extern __shared__ __align__(ALIGN) unsigned char smem[];
  namespace cgr = cooperative_groups;
  constexpr bool F32 = sizeof(T) == 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = p.slices;
  const int rank = S > 1 ? (int)cgr::this_cluster().block_rank() : 0;
  const int cid = blockIdx.x / S;
  const int ncl = gridDim.x / S;
  Walk wk;
  wk.it0 = (int)((long long)cid * p.items / ncl);
  const int it1 = (int)((long long)(cid + 1) * p.items / ncl);
  wk.pa0 = rank * p.passes / S;
  wk.np = (rank + 1) * p.passes / S - wk.pa0;
  const int nsteps = (it1 - wk.it0) * wk.np;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) s8::mbar_init(&full[s], NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (p.halo_x == kTma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.map_x))
                   : "memory");
    if (LIF && p.Crec > 0 && p.halo_zr == kTma)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&p.map_zr))
                   : "memory");
  }
  __syncthreads();

  const int tw = 1 << p.tw_shift;
  const int SW = tw + K - 1;
  const int SH = p.th + K - 1;
  int a_pix[MT];  // the halo pixel of the lane's A row of each m16 tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const Pix x = pix_of(p, 32 * warp + 16 * m + (lane & 15));
    a_pix[m] = (x.img * SH + x.row) * SW + x.col;
  }
  // the warp's first pixel: its 32 pixels are rows of one image
  const Pix first = pix_of(p, 32 * warp);

  if (p.pads_zero) {
    // the channels past C that the taps read in the stages the walk uses,
    // which no copy writes: the 16-byte chunks of every halo pixel up to
    // the taps' last
    const Segment<T> sg = segment<T>(p, 0);
    const int chunks =
        read_channels<T>(pass_pad(sg.C, sg.c0)) * (int)sizeof(T) / 16;
    const int px = p.imgs * (p.th + K - 1) * ((1 << p.tw_shift) + K - 1);
    for (int s = 0; s < p.ns && s < nsteps; ++s)
      for (int i = tid; i < px * chunks; i += NT) {
        const int q = i / chunks;
        *reinterpret_cast<uint4*>(
            smem + p.off_stage + s * p.stage_bytes +
            s8::swizzle(q * Lay<T>::ROW + (i - q * chunks) * 16,
                        Lay<T>::SWZ)) = make_uint4(0, 0, 0, 0);
      }
    __syncthreads();
  }
  // the first group's resident weights: their copies complete on the first
  // stage's barrier with its halo (float32 splits them once landed)
  int w_co0 = -1;  // the channel group of the resident weights
  bool w_raw = false;
  if (p.resident && nsteps > 0) {
    w_co0 = tile_of<CO>(p, wk.it0).co0;
    stage_weights<K, CO, T>(p, smem, wk, w_co0);
    w_raw = F32;
  }
  for (int s = 0; s < p.ns && s < nsteps; ++s)
    issue<K, CO, T>(p, smem, full, wk, s);

  // where one map's halo is copied by the threads and the other's by TMA,
  // a stage that the threads wrote is written by TMA later: the proxies'
  // writes are ordered by a fence (stages only read in between need none)
  const bool mixed = LIF && p.halo_x != p.halo_zr;
  float acc[MT][CO / 8][4] = {};
  State<CO, T> state;
  for (int step = 0; step < nsteps; ++step) {
    const int local = step / wk.np;
    const int k = step - local * wk.np;
    const Tile tl = tile_of<CO>(p, wk.it0 + local);
    if (p.resident && tl.co0 != w_co0) {
      // the previous step ended in __syncthreads: no one reads the
      // weights or the work area
      load_weights<K, CO, T>(p, smem, wk, tl.co0);
      w_co0 = tl.co0;
    }
    const int stage = step % p.ns;
    s8::mbar_wait(&full[stage], (step / p.ns) & 1);
    unsigned char* s_in = smem + p.off_stage + stage * p.stage_bytes;
    const Segment<T> sg = segment<T>(p, wk.pa0 + k);
    const int cpad = pass_pad(sg.C, sg.c0);
    const bool last = k == wk.np - 1;
    // a warp whose pixels all lie outside the map (below a map shorter
    // than the tile, or in an image past B) multiplies nothing
    const bool busy = tl.b + first.img < p.B && tl.y0 + first.row < p.H;
    const bool load = LIF && k == 0 && p.out4 && rank == 0;
    if constexpr (F32) {
      unsigned char* work = smem + p.off_work;
      if (w_raw) {
        split_weights<K, CO>(p, smem, wk);
        w_raw = false;
      }
      split_stage<K, CO>(p, s_in, work, cpad);
      if (mixed) s8::fence_async_smem();  // TMA writes this stage next
      __syncthreads();
      if (step + p.ns < nsteps)
        issue<K, CO, T>(p, smem, full, wk, step + p.ns);
      if (load) load_state<CO, T>(p, tl, state);
      constexpr int PE = w_pass_elems<K, CO, T>();
      const uint32_t* b_hi =
          p.resident ? reinterpret_cast<const uint32_t*>(smem + p.off_w) +
                           k * PE
                     : reinterpret_cast<const uint32_t*>(work +
                                                         2 * p.halo_bytes);
      const uint32_t* b_lo = p.resident ? b_hi + wk.np * PE
                                        : b_hi + p.w_pass_bytes / 4;
      if (busy && cpad == CCH)
        taps_f32<K, CO, true>(acc, work, work + p.halo_bytes, b_hi, b_lo,
                              a_pix, SW, cpad);
      else if (busy)
        taps_f32<K, CO, false>(acc, work, work + p.halo_bytes, b_hi, b_lo,
                               a_pix, SW, cpad);
    } else {
      if (load) load_state<CO, T>(p, tl, state);
      const bf16* s_w =
          p.resident ? reinterpret_cast<const bf16*>(smem + p.off_w) +
                           k * w_pass_elems<K, CO, T>()
                     : reinterpret_cast<const bf16*>(s_in + p.halo_bytes);
      if (busy && cpad == CCH)
        taps_bf16<K, CO, true>(acc, s_in, s_w, a_pix, SW, cpad);
      else if (busy)
        taps_bf16<K, CO, false>(acc, s_in, s_w, a_pix, SW, cpad);
    }
    if (last) {
      if (S > 1) {
        // the cluster's sum: every block's fragments into its shared
        // memory, the first block adds the others' in rank order
        float* red = reinterpret_cast<float*>(smem + p.off_red) + tid;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < CO / 8; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              red[((m * (CO / 8) + n) * 4 + r) * NT] = acc[m][n][r];
        cgr::cluster_group cl = cgr::this_cluster();
        cl.sync();
        if (rank == 0)
          for (int q = 1; q < S; ++q) {
            const float* other = cl.map_shared_rank(red, q);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int n = 0; n < CO / 8; ++n)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[m][n][r] += other[((m * (CO / 8) + n) * 4 + r) * NT];
          }
        cl.sync();  // the others' fragments are read before they change
      }
      if (rank == 0) {
        if constexpr (LIF)
          epilogue<CO, HARD, T>(p, tl, acc, state);
        else
          store<CO, T>(p, tl, acc);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < CO / 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;
    }
    if (!F32 && mixed) s8::fence_async_smem();  // TMA writes it next
    __syncthreads();  // every thread is done with this step's buffers
    if constexpr (!F32)
      if (step + p.ns < nsteps)
        issue<K, CO, T>(p, smem, full, wk, step + p.ns);
  }
}

// ---- host side: the plan, the memory plan, the TMA maps, the launch ----

// p's tile: imgs images of TILE / (tw * imgs) rows of tw pixels; its
// tile and item counts at channel groups of co
inline void set_tiles(Params& p, int tw, int imgs, int co) {
  p.tw_shift = tw == 8 ? 3 : tw == 16 ? 4 : 5;
  p.imgs = imgs;
  p.th = TILE / (tw * imgs);
  int ppi = p.th * tw, shift = 0;
  while ((1 << shift) < ppi) ++shift;
  p.px_shift = shift;
  p.tiles_x = (p.W + tw - 1) / tw;
  p.tiles_y = (p.H + p.th - 1) / p.th;
  p.tiles = ((p.B + imgs - 1) / imgs) * p.tiles_x * p.tiles_y;
  p.items = p.tiles * ((p.Cout + co - 1) / co);
}

// Lay out the dynamic shared memory of p's tiles with ns ring stages and
// resident weights or not (for the block's passes, at most ceil(passes /
// slices)), and the cluster's sum where slices > 1; returns its bytes.
// ops/conv_plan.py::ring_smem computes the same.
template <int K, int CO, class T>
int layout(Params& p, bool resident, int ns) {
  constexpr bool F32 = sizeof(T) == 4;
  const int sw = (1 << p.tw_shift) + K - 1, sh = p.th + K - 1;
  const int np_max = (p.passes + p.slices - 1) / p.slices;
  p.ns = ns;
  p.resident = resident;
  p.halo_bytes = s8::align_up(p.imgs * sh * sw * Lay<T>::ROW, ALIGN);
  const int w_bytes = w_pass_elems<K, CO, T>() * (int)sizeof(T);
  const int raw_w = s8::align_up(w_bytes, ALIGN);
  p.stage_bytes = p.halo_bytes + (resident ? 0 : raw_w);
  int off = ALIGN;  // the mbarriers
  p.off_stage = off;
  off += ns * p.stage_bytes;
  p.off_work = off;  // float32: the split halo and streamed weight rows
  if (F32) off += 2 * p.halo_bytes + (resident ? 0 : 2 * raw_w);
  p.off_w = off;
  p.w_pass_bytes = resident || F32 ? raw_w : 0;
  if (resident) off += s8::align_up(np_max * w_bytes * (F32 ? 2 : 1), ALIGN);
  p.off_red = off;
  if (p.slices > 1) off += NT * MT * (CO / 8) * 4 * 4;
  return off;
}

// the map of an NHWC tensor of C elements of T a pixel, its pixels Cs
// elements apart, boxes of 32 channels over a tile's halo of imgs images,
// under TMA's swizzle of the row's width; false where the pixel stride is
// not a whole 16-byte row (or the pointer not 16-byte aligned)
template <class T>
bool encode_halo(CUtensorMap* map, const void* base, const Params& p, int C,
                 int Cs, int sw, int sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint32_t box[4] = {(cuuint32_t)Lay<T>::ROW, (cuuint32_t)sw,
                             (cuuint32_t)sh, (cuuint32_t)p.imgs};
  return (Cs * sizeof(T)) % 16 == 0 &&
         s8::encode(map, base, 4, dims, (cuuint64_t)Cs * sizeof(T), box,
                    Lay<T>::ROW);
}

// Launch `kernel` on p (planned, laid out at smem bytes): size the
// persistent grid from the occupancy API, clusters of p.slices blocks.
// One launch.
inline cudaError_t launch_grid(void (*kernel)(Params), Params& p, int smem,
                               cudaStream_t st) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= s8::MAX_DEVICES) return cudaErrorInvalidDevice;
  // the kernels and devices whose attributes are set
  static const void* ready[256];
  static int ready_dev[256], n_ready = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  bool set = false;
  for (int i = 0; i < n_ready && !set; ++i)
    set = ready[i] == key && ready_dev[i] == dev;
  if (!set) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (n_ready < 256) {
      ready[n_ready] = key;
      ready_dev[n_ready++] = dev;
    }
  }
  int cap = 0;
  e = s8::capacity(reinterpret_cast<const void*>(kernel), smem, p.slices,
                   &cap);
  if (e != cudaSuccess) return e;
  const int clusters = p.items < cap ? p.items : cap;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.slices;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * p.slices);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = p.slices > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// K2: two blocks an SM in bfloat16 at groups of 8 and 16; one in float32,
// whose planes take most of an SM's shared memory anyway, and at groups
// of 32, whose LIF state (v and z of 4 channels per n8 tile and m16 tile)
// takes too many registers for two
template <int K, int CO, bool HARD, class T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 && CO < 32 ? 2 : 1)
    fused_conv_lif_ring_kernel(const __grid_constant__ Params p) {
  run<K, CO, HARD, T, true>(p);
}

// Whether a plan's fields are ones the kernels take
inline bool plan_ok(int tw, int imgs, int slices, int ns) {
  return (tw == 8 || tw == 16 || tw == 32) &&
         (imgs == 1 || imgs == 2 || imgs == 4 || imgs == 8) && slices >= 1 &&
         slices <= MAX_SLICES && ns >= 1 && ns <= NS;
}

// K2 on the call's plan at K and CO; cudaErrorInvalidValue where the plan
// is not one the kernel takes or its shared memory does not fit.
template <int K, int CO, class T>
cudaError_t launch_co(const Call& c, cudaStream_t st) {
  if (!plan_ok(c.tw, c.imgs, c.slices, c.ns)) return cudaErrorInvalidValue;
  Params p = {};
  p.x = c.x;
  p.w2 = c.w2;
  p.zr = c.zr;
  p.wr2 = c.wr2;
  p.v = c.v;
  p.z = c.z;
  p.leak = c.leak;
  p.thresh = c.thresh;
  p.v_out = c.v_out;
  p.z_out = c.z_out;
  p.B = c.B;
  p.H = c.H;
  p.W = c.W;
  p.Cin = c.Cin;
  p.Cout = c.Cout;
  p.Crec = c.zr ? c.Crec : 0;
  p.px = (c.Cin + CCH - 1) / CCH;
  p.passes = p.px + (p.Crec + CCH - 1) / CCH;
  p.slices = c.slices;
  if (c.slices > p.passes || c.Cs < c.Cin) return cudaErrorInvalidValue;
  set_tiles(p, c.tw, c.imgs, CO);
  if (p.th * c.tw < 32) return cudaErrorInvalidValue;  // a warp's 32 pixels
  const int smem = layout<K, CO, T>(p, c.resident != 0, c.ns);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int sw = c.tw + K - 1, sh = p.th + K - 1;
  p.halo_x =
      encode_halo<T>(&p.map_x, c.x, p, c.Cin, c.Cs, sw, sh) ? kTma : kCopy;
  if (p.halo_x == kCopy && c.Cs != c.Cin) return cudaErrorInvalidValue;
  p.halo_zr =
      p.Crec == 0 ? p.halo_x
      : encode_halo<T>(&p.map_zr, c.zr, p, p.Crec, p.Crec, sw, sh) ? kTma
                                                                    : kCopy;
  // the threads' copies meet the same channels past C at every step (one
  // segment)
  p.pads_zero = p.Crec == 0 && p.halo_x == kCopy &&
                (p.passes == 1 || c.Cin % CCH == 0);
  p.step_x = copy_step<T>(c.x, c.Cin);
  p.step_w = copy_step<T>(c.w2, c.Cout);
  if (p.Crec > 0) {
    p.step_zr = copy_step<T>(c.zr, p.Crec);
    p.step_wr = copy_step<T>(c.wr2, c.Cout);
  }
  const size_t quad = 4 * sizeof(T);
  p.out4 = c.Cout % 4 == 0 && aligned(c.v, quad) && aligned(c.z, quad) &&
           aligned(c.v_out, quad) && aligned(c.z_out, quad) &&
           aligned(c.leak, 16) && aligned(c.thresh, 16);
  return launch_grid(c.hard ? fused_conv_lif_ring_kernel<K, CO, true, T>
                            : fused_conv_lif_ring_kernel<K, CO, false, T>,
                     p, smem, st);
}

// K2 at K in the plan's channel group (8, 16 or 32)
template <int K, class T>
cudaError_t launch_k(const Call& c, cudaStream_t st) {
  switch (c.co) {
    case 8: return launch_co<K, 8, T>(c, st);
    case 16: return launch_co<K, 16, T>(c, st);
    case 32: return launch_co<K, 32, T>(c, st);
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
cudaError_t launch(const Call& c, cudaStream_t st) {
  switch (c.K) {
    case 1: return launch_k<1, T>(c, st);
    case 3: return launch_k<3, T>(c, st);
    case 5: return launch_k<5, T>(c, st);
    default: return cudaErrorInvalidValue;
  }
}

// K1 on p's tiles of the call's plan at K and CO (conv.cu's kernel);
// cudaErrorInvalidValue where the plan is not one the kernel takes or its
// shared memory does not fit.
template <int K, int CO, class T>
cudaError_t launch_conv(void (*kernel)(Params), const ConvCall& c,
                        cudaStream_t st) {
  if (!plan_ok(c.tw, c.imgs, c.slices, c.ns)) return cudaErrorInvalidValue;
  Params p = {};
  p.x = c.x;
  p.w2 = c.w2;
  p.y = c.y;
  p.B = c.B;
  p.H = c.H;
  p.W = c.W;
  p.Cin = c.Cin;
  p.Cout = c.Cout;
  p.px = (c.Cin + CCH - 1) / CCH;
  p.passes = p.px;
  p.slices = c.slices;
  if (c.slices > p.passes || c.Cs < c.Cin) return cudaErrorInvalidValue;
  set_tiles(p, c.tw, c.imgs, CO);
  if (p.th * c.tw < 32) return cudaErrorInvalidValue;  // a warp's 32 pixels
  const int smem = layout<K, CO, T>(p, c.resident != 0, c.ns);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int sw = c.tw + K - 1, sh = p.th + K - 1;
  p.halo_x =
      encode_halo<T>(&p.map_x, c.x, p, c.Cin, c.Cs, sw, sh) ? kTma : kCopy;
  if (p.halo_x == kCopy && c.Cs != c.Cin) return cudaErrorInvalidValue;
  p.halo_zr = p.halo_x;
  // the threads' copies meet the same channels past C at every step
  p.pads_zero = p.halo_x == kCopy && (p.passes == 1 || c.Cin % CCH == 0);
  p.step_x = copy_step<T>(c.x, c.Cin);
  p.step_w = copy_step<T>(c.w2, c.Cout);
  p.out2 = c.Cout % 2 == 0 && aligned(c.y, 2 * sizeof(T));
  return launch_grid(kernel, p, smem, st);
}

}  // namespace ring
}  // namespace evf
