// The int8 conv mainloop of K1-s8 (conv.cu) and K2-s8 (fused_lif.cu), for
// sm_90a: a persistent implicit GEMM on the int8 tensor cores (mma.sync
// m16n8k32, int32 sums) whose next tile, and K2-s8's LIF state, load by
// TMA during the current tile's MMAs and epilogue. JAX computes its int8
// conv in XLA, no Pallas kernel (models/conv.py:93-141); PyTorch has no
// int8 convolution on CUDA.
//
// What bounds it on the H100: bytes. At LIFFireNet's cells (1 x 180 x 240,
// 32 -> 32, k 3) a K2-s8 call moves 23.5 MB, 22.1 of them the float32
// state v, z in and v', z' out (half in bfloat16), for 0.8 G int8
// operations: 7.0 us at 3.35 TB/s against 0.4 us at 1979 TOPS. At the
// U-Net's deepest cell (512 -> 512 on 12 x 15) the weights are most of
// the bytes and one tile of 180 pixels is all the map, so there the
// blocks' multiplies and their latency decide. So the design keeps bytes
// in flight on every SM, spends no thread's instructions on moving the
// state, and spreads the deep maps' multiplies over more SMs:
//
// - Work. The output is cut into tiles of TILE = 256 pixels of one image,
//   TH x TW with TW 8, 16 or 32 chosen by the map (the fewest tiles), and
//   groups of CO output channels (8 where Cout <= 8, else 32); an item is
//   one tile of one group, group-major. The K dimension is walked in
//   passes of 32 input channels, the input's, then the recurrent
//   input's. The plan is ops/s8_plan.py's; the kernel takes its tile
//   width and slice count and derives the same indices.
// - A persistent grid: as many blocks as the occupancy API says fit (two
//   per SM at the ECD cells, 128 registers a thread), no more than the
//   items, each cluster walking a run of consecutive items (one channel
//   group, or few), so its weights change rarely.
// - Split K where the items are fewer than the SMs (the deep maps): the
//   passes of an item are split over the `slices` blocks (up to 4) of a
//   thread-block cluster, each adds its passes into int32 fragments, and
//   the cluster's first block adds the others' fragments from their shared
//   memory (distributed shared memory) before the epilogue. int32 sums are
//   exact, so any split or order gives the same bits.
// - A ring of up to NS = 4 stages, completed on mbarriers. A step is one
//   pass of one item. Thread 0 issues a step's int8 halo tile as one TMA
//   copy (cp.async.bulk.tensor over the NHWC map; the hardware zero-fills
//   the border) and, at an item's first pass, the item's v and z tiles,
//   each one TMA copy, all completing on the stage's mbarrier with their
//   byte count. Where a map's pixel rows are not whole 16-byte rows (2, 5,
//   130, 258, 514 channels) the threads copy the halo's bytes as 4-byte
//   words with cp.async into a raw area, which arrive on the same barrier
//   (cp.async.mbarrier.arrive), and shift them into place once landed.
//   Step i waits on its stage's phase, so its taps and epilogue run while
//   the next steps are in flight. The ring is as deep as the block's
//   passes and shared memory allow; where a block takes several items, it
//   runs at most one item ahead, so that the next item's v and z have a
//   free state buffer of the two.
// - Weights and per-channel values once per channel group: the block's
//   passes of its group's weight rows stay in shared memory, with the
//   group's scale and (K2) rounded leak, threshold and 1 - leak, reloaded
//   only where the group changes (issued before the ring's first steps);
//   where they do not fit, each stage carries its pass's weight rows.
// - The epilogue. The update reads v and z from the state buffer and
//   writes v' and z' back in place; one thread stores both tiles with TMA
//   (the hardware clips the map's edge). K1-s8 stages y the same way, or
//   at the 2-channel heads as whole tile rows, which the threads copy out
//   as 16-byte stores. Where a map's channels are not whole 16-byte rows
//   or a pointer is not 16-byte aligned, the epilogue reads and writes
//   device memory element by element.
//
// Shared memory is dense and swizzled as TMA writes it: a halo pixel is 32
// channel bytes, its two 16-byte halves swapped on every other group of 4
// pixels (TMA's 32-byte swizzle), and the weight rows (tap, output channel)
// of 32 input-channel bytes, from wq [Cout][K*K][C] (OHWI), likewise, so
// the 8 rows of each ldmatrix matrix fall on 8 distinct bank groups; a
// staged pixel of state is CO channels under the swizzle of its width
// (128, 64, 32 bytes), so the epilogue's fragment accesses do not
// conflict either. ldmatrix moves 16-bit values, so B's k (the input
// channels) must be contiguous in a row.
//
// The multiply stays mma.sync m16n8k32 (not wgmma m64nNk32): at 32
// channels the int8 products of a cell take about 0.4 us of the card's
// 1979 TOPS, so the bytes and their latency decide, and mma.sync keeps the
// fragment layout the epilogue and the halo's ldmatrix addressing are
// written for, at any tile width. At 512 channels the split's few blocks
// are bound by mma.sync's rate and latency instead (PERF.md); wgmma, with
// its operands from shared memory, is the step that would move them.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; the encoder is libcuda's, looked up at run time

#include "conv_tile.cuh"

namespace evf {
namespace s8 {

constexpr int TILE = NT * MT * 16 / 32;  // output pixels per tile: 256
constexpr int NS = 4;                    // stages of the ring, at most
constexpr int PIX = 32;        // bytes of a staged halo pixel or weight row
constexpr int MAX_SLICES = 8;     // blocks of a cluster (portable)
constexpr int MAX_DEVICES = 64;
constexpr int ALIGN = 1024;       // a swizzle pattern's span

// how the epilogue moves the output (and K2's state)
enum Out { kScalar = 0, kPixels = 1, kRows = 2 };

struct Params {
  // TMA maps: the halo of x and of the recurrent input, K2's v, z, v',
  // z' or K1's y (as o0)
  CUtensorMap map_x, map_zr, map_v, map_z, map_o0, map_o1;
  const int8_t *x, *wx, *zr, *wr;  // zr null: no recurrent segment
  const float *scale, *leak, *thresh;
  const void *v, *z;
  void *out0, *out1;  // K1: y; K2: v', z'
  int B, H, W, Cin, Crec, Cout, hard;
  // the plan (ops/s8_plan.py)
  int tw_shift, th, tiles_x, tiles_y, tiles, items, px, passes, slices;
  int halo_x, halo_zr;  // how each map's halo arrives (Halo)
  // the memory plan (s8::launch)
  int ns, out_mode, w_resident, nvz;  // ns: stages of the ring
  int rb;    // staged bytes of a pixel (kPixels) or of a tile row (kRows)
  int swz;   // the staged output's swizzle mask
  int halo_bytes, raw_bytes, stage_bytes, w_pass_bytes, out_bytes;
  int off_consts, off_stage, off_w, off_out, off_red;
};

// ---- device: barriers, copies ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the thread's prior cp.async copies arrive on bar when they land (the
// pending count raised by one now, so the phase waits for them), then
// the thread arrives itself, releasing its prior shared-memory stores
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
      "mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
      : "memory");
}

// the phase also waits for `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the box of `map` at (c0, c1, c2, c3) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// src into the box of `map` at (c0, c1, c2, c3); a bulk group of the
// thread
__device__ __forceinline__ void tma_store4(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, "
      "%3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's bulk groups still read shared
// memory (READ) or are still in flight
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// the generic proxy's shared-memory writes, seen by the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a byte offset in a buffer under TMA's swizzle of mask 0x10 (32 bytes),
// 0x30 (64) or 0x70 (128): its 16-byte chunk XOR the index of its
// 128-byte line
__device__ __forceinline__ int swizzle(int off, int mask) {
  return off ^ ((off >> 3) & mask);
}

// The block's view of the plan: its cluster's items, its passes.
struct Walk {
  int it0, np, pa0, rank;
};

// The tile's origin and channel group of item `item`.
struct Tile {
  int b, y0, x0, co0;
};

template <int CO>
__device__ __forceinline__ Tile tile_of(const Params& p, int item) {
  const int g = item / p.tiles;
  const int t = item - g * p.tiles;
  const int per_image = p.tiles_x * p.tiles_y;
  const int b = t / per_image;
  const int r = t - b * per_image;
  const int ty = r / p.tiles_x;
  return {b, ty * p.th, (r - ty * p.tiles_x) << p.tw_shift, g * CO};
}

// 4 bytes (n of them valid, 0 <= n <= 4, the rest zero) from src, which
// is 4-byte aligned, to dst
__device__ __forceinline__ void cp4_part(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

// How a pass's halo tile arrives: one TMA copy of the box where the map's
// pixel rows are whole 16-byte rows; else as 4-byte words into a raw area
// that expand_halo shifts into place.
enum Halo { kTma = 0, kWords = 1 };

// The halo's source: x or the recurrent input, by pass.
struct Segment {
  const int8_t* src;
  int C, c0, mode;
};

__device__ __forceinline__ Segment segment(const Params& p, int pass) {
  const bool rec = pass >= p.px;
  return rec ? Segment{p.zr, p.Crec, (pass - p.px) * CCH, p.halo_zr}
             : Segment{p.x, p.Cin, pass * CCH, p.halo_x};
}

// The raw area, for maps whose pixel rows are not whole 16-byte rows (2,
// 5, 130, 258, 514 channels): 4-byte cp.async of the aligned words around
// the bytes wanted, the last word cut at the data's end, so nothing past
// it is read. Below 32 channels a halo row's pixels are one run of bytes,
// which its words cover; from 32 channels a halo pixel's 32 channels of
// the pass take 9 words, in a slot of RAW_PX bytes. One thread a unit
// (run word or pixel), its address computed once.
constexpr int RAW_PX = 40;  // bytes a pixel of the raw area: 9 words, slack

__host__ __device__ __forceinline__ int raw_row(int SW, int C) {
  return ((SW * C + 3) & ~3) + 40;  // the run's words, and a pixel's slack
}

// the run of halo row gy's pixels from xa of pass sg: its first byte
__device__ __forceinline__ uintptr_t run_start(const Params& p,
                                               const Segment& sg, int b,
                                               int gy, int xa) {
  return reinterpret_cast<uintptr_t>(sg.src) +
         (((size_t)b * p.H + gy) * p.W + xa) * sg.C;
}

// the first byte of halo pixel (gy, gx)'s channels of pass sg
__device__ __forceinline__ uintptr_t pixel_start(const Params& p,
                                                 const Segment& sg, int b,
                                                 int gy, int gx) {
  return reinterpret_cast<uintptr_t>(
      sg.src + (((size_t)b * p.H + gy) * p.W + gx) * sg.C + sg.c0);
}

// bytes [a, end) of the map into dst as the words from a's 4-byte-aligned
// address, the last cut at end
__device__ __forceinline__ void copy_words(int8_t* dst, uintptr_t a,
                                           uintptr_t end) {
  const uintptr_t w0 = a & ~(uintptr_t)3;
  for (uintptr_t w = w0; w < end; w += 4)
    cp4_part(dst + (w - w0), reinterpret_cast<const void*>(w),
             end - w < 4 ? (int)(end - w) : 4);
}

template <int K>
__device__ __forceinline__ void copy_halo_raw(const Params& p, int8_t* raw,
                                              const Segment& sg,
                                              const Tile& tl) {
  constexpr int P = K / 2;
  const int SW = (1 << p.tw_shift) + K - 1;
  const int SH = p.th + K - 1;
  if (sg.C < CCH) {
    const int xa = max(tl.x0 - P, 0);
    const int xb = min(tl.x0 + (1 << p.tw_shift) + P, p.W);
    const int RR = raw_row(SW, sg.C);
    const int words = RR / 4;
    for (int i = threadIdx.x; i < SH * words; i += NT) {
      const int hy = i / words;
      const int j = i - hy * words;
      const int gy = tl.y0 + hy - P;
      if (gy < 0 || gy >= p.H) continue;
      const uintptr_t a = run_start(p, sg, tl.b, gy, xa);
      const uintptr_t end = a + (size_t)(xb - xa) * sg.C;
      const uintptr_t w = (a & ~(uintptr_t)3) + 4 * j;
      if (w < end)
        cp4_part(raw + hy * RR + 4 * j, reinterpret_cast<const void*>(w),
                 end - w < 4 ? (int)(end - w) : 4);
    }
    return;
  }
  const int n = min(CCH, sg.C - sg.c0);
  for (int px = threadIdx.x; px < SH * SW; px += NT) {
    const int hy = px / SW;
    const int gy = tl.y0 + hy - P;
    const int gx = tl.x0 + px - hy * SW - P;
    if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W) continue;
    const uintptr_t a = pixel_start(p, sg, tl.b, gy, gx);
    copy_words(raw + px * RAW_PX, a, a + n);
  }
}

// The raw area of a landed pass into the halo tile's swizzled pixels,
// zero outside the image and past C: a thread a pixel reads the 9 words
// around its bytes, shifts out 8 and writes them as two 16-byte chunks.
template <int K>
__device__ __forceinline__ void expand_halo(const Params& p, int8_t* dst,
                                            const int8_t* raw,
                                            const Segment& sg,
                                            const Tile& tl) {
  constexpr int P = K / 2;
  const int SW = (1 << p.tw_shift) + K - 1;
  const int SH = p.th + K - 1;
  const int RR = raw_row(SW, sg.C);
  const int xa = max(tl.x0 - P, 0);
  const int n = min(CCH, sg.C - sg.c0);
  for (int px = threadIdx.x; px < SH * SW; px += NT) {
    const int hy = px / SW;
    const int gy = tl.y0 + hy - P;
    const int gx = tl.x0 + px - hy * SW - P;
    uint32_t out[8] = {};
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const int8_t* r;
      int first;  // the byte of r holding the pixel's first channel
      if (sg.C < CCH) {
        r = raw + hy * RR;
        first = (int)(run_start(p, sg, tl.b, gy, xa) & 3) +
                (gx - xa) * sg.C;
      } else {
        r = raw + px * RAW_PX;
        first = (int)(pixel_start(p, sg, tl.b, gy, gx) & 3);
      }
      const uint32_t* wp =
          reinterpret_cast<const uint32_t*>(r + (first & ~3));
      const int shift = (first & 3) * 8;
      uint32_t wv[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) wv[j] = wp[j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int keep = n - 4 * j;  // bytes of this word that are data
        const uint32_t w = __funnelshift_r(wv[j], wv[j + 1], shift);
        out[j] = keep >= 4 ? w : keep <= 0 ? 0u : w & ((1u << (8 * keep)) - 1u);
      }
    }
    *reinterpret_cast<uint4*>(dst + swizzle(px * PIX, 0x10)) =
        make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(dst + swizzle(px * PIX + 16, 0x10)) =
        make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// The weight rows of pass `pass` for output channels co0 .. co0 + CO into
// dst, 32-byte-swizzled: rows (tap, output channel) of 32 input channels,
// from the rows of wq [Cout][K*K][Cw], Cw the input channels padded to 16
// bytes (ops/conv.py::ohwi), as 16-byte cp.async; zero past Cw and Cout.
template <int K, int CO>
__device__ __forceinline__ void copy_weights(const Params& p, int8_t* dst,
                                             int pass, int co0) {
  const bool rec = pass >= p.px;
  const int8_t* src = rec ? p.wr : p.wx;
  const int Cw = ((rec ? p.Crec : p.Cin) + 15) & ~15;
  const int c0 = (rec ? pass - p.px : pass) * CCH;
  for (int i = threadIdx.x; i < K * K * CO * 2; i += NT) {
    const int r = i >> 1;
    const int ci = (i & 1) * 16;
    const int t = r / CO;
    const int co = co0 + r - t * CO;
    const int c = c0 + ci;
    const bool ok = c < Cw && co < p.Cout;
    cp16(dst + swizzle(r * PIX + ci, 0x10),
         ok ? src + ((size_t)co * K * K + t) * Cw + c : src, ok);
  }
}

// Issue step `step` of the walk into ring stage step % ns: the pass's halo
// tile (and its weight rows unless they are resident) and, at an item's
// first pass in a K2-s8 block that runs the epilogue, the item's v and z
// tiles into state buffer (the item's index in the walk) % nvz; then
// arrive on the stage's barrier. Every thread calls it.
template <int K, int CO, class T, bool LIF>
__device__ __forceinline__ void issue(const Params& p, unsigned char* smem,
                                      uint64_t* full, const Walk& w,
                                      int step) {
  constexpr int P = K / 2;
  const int local = step / w.np;
  const int k = step - local * w.np;
  const int pass = w.pa0 + k;
  const Tile tl = tile_of<CO>(p, w.it0 + local);
  uint64_t* bar = &full[step % p.ns];
  int8_t* dst = reinterpret_cast<int8_t*>(smem + p.off_stage +
                                          (step % p.ns) * p.stage_bytes);
  const Segment sg = segment(p, pass);
  const bool state = LIF && p.out_mode == kPixels && w.rank == 0 && k == 0;
  if (threadIdx.x == 0) {
    const int sw = (1 << p.tw_shift) + K - 1;
    const unsigned tx = (sg.mode == kTma ? (p.th + K - 1) * sw * PIX : 0) +
                        (state ? 2 * TILE * CO * (int)sizeof(T) : 0);
    if (tx) mbar_expect(bar, tx);
    if (sg.mode == kTma)
      tma_load(dst, pass >= p.px ? &p.map_zr : &p.map_x, sg.c0, tl.x0 - P,
               tl.y0 - P, tl.b, bar);
    if (state) {
      unsigned char* vs = smem + p.off_out + (local % p.nvz) * p.out_bytes;
      bulk_wait<0, true>();  // an earlier item's stores from it have read
      const int c = tl.co0 * (int)sizeof(T);
      tma_load(vs, &p.map_v, c, tl.x0, tl.y0, tl.b, bar);
      tma_load(vs + p.out_bytes / 2, &p.map_z, c, tl.x0, tl.y0, tl.b, bar);
    }
  }
  if (sg.mode != kTma) copy_halo_raw<K>(p, dst + p.halo_bytes, sg, tl);
  if (!p.w_resident)
    copy_weights<K, CO>(p, dst + p.halo_bytes + p.raw_bytes, pass, tl.co0);
  mbar_arrive_copies(bar);
}

// acc += every tap of a staged pass: per tap one k32 step. A: one
// ldmatrix.x4 per m16 tile, lane l addressing its pixel (l % 16 of the
// m16 tile; a_pix[m] in the halo tile, shifted by the tap) at byte
// 16 (l / 16), so the four matrices are pixels 0-7 and 8-15 at k 0-15,
// then at k 16-31: the m16n8k32 A fragment (4 bytes of k per register).
// B: one ldmatrix.x4 per two n8 tiles, lane l addressing output channel
// l % 8 + 8 (l / 16) at byte 16 ((l / 8) % 2): matrices (n 0-7, k 0-15),
// (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31), the col-major B
// fragments of both tiles. Rows are 32-byte-swizzled. The MMA accumulates
// in int32 in place: integer sums are exact.
template <int K, int CO>
__device__ __forceinline__ void taps(int (&acc)[MT][CO / 8][4],
                                     const int8_t* s_in, const int8_t* s_w,
                                     const int (&a_pix)[MT], int SW) {
  const int lane = threadIdx.x & 31;
  const int ha = lane >> 4;
  const int brow = (lane & 7) + 8 * (lane >> 4);
  const int b_off =
      brow * PIX + ((((lane >> 3) & 1) ^ ((brow >> 2) & 1)) << 4);
#pragma unroll K
  for (int tap = 0; tap < K * K; ++tap) {
    const int dy = tap / K;
    const int shift = dy * SW + tap - dy * K;
    const int8_t* b = s_w + tap * CO * PIX + b_off;
    uint32_t af[MT][4], bfr[CO / 8][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int px = a_pix[m] + shift;
      ldsm_x4(af[m], s_in + px * PIX + ((ha ^ ((px >> 2) & 1)) << 4));
    }
    if constexpr (CO == 8) {
      ldsm_x2(bfr[0], b);
    } else {
#pragma unroll
      for (int n = 0; n < CO / 8; n += 2) {
        uint32_t q[4];
        ldsm_x4(q, b + 8 * n * PIX);
        bfr[n][0] = q[0];
        bfr[n][1] = q[1];
        bfr[n + 1][0] = q[2];
        bfr[n + 1][1] = q[3];
      }
    }
#pragma unroll
    for (int n = 0; n < CO / 8; ++n)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_s8(acc[m][n], af[m], bfr[n]);
  }
}

// The LIF update of one element from its int32 current a and channel cl
// of the group's staged values: every operation rounded on its own in the
// plain form's order (torch evaluates each elementwise op separately): no
// contraction into FMAs, and in bfloat16 each result rounded to bfloat16
// (round_as<T>), so v' and z' are bitwise the plain form's. z' is the
// sign of v' - th, which rounding cannot change.
template <class T>
__device__ __forceinline__ void lif(int a, float vv, float zz, int cl,
                                    const float* cst, bool hard, float& vn,
                                    float& zn) {
  auto r = [](float x) { return round_as<T>(x); };
  const float cur = r(__fmul_rn(__int2float_rn(a), cst[cl]));
  const float l = cst[32 + cl], t = cst[64 + cl];
  const float drive = r(__fmul_rn(cst[96 + cl], cur));
  vn = hard ? r(__fadd_rn(r(__fmul_rn(r(__fmul_rn(vv, l)),
                                      r(__fsub_rn(1.f, zz)))),
                          drive))
            : r(__fsub_rn(r(__fadd_rn(r(__fmul_rn(vv, l)), drive)),
                          r(__fmul_rn(zz, t))));
  zn = (__fsub_rn(vn, t) > 0.f) ? 1.f : 0.f;
}

// The epilogue of one item in the block that holds its whole sums: K1-s8
// y = float(a) * scale (rounded once, then once more to a bfloat16 T), or
// K2-s8's update of (v, z). acc[m][n][e] is output pixel 32 warp + 16 m
// + 8 (e / 2) + lane / 4 of the tile, channel 8 n + 2 (lane % 4) + e % 2
// of the group.
template <int CO, class T, bool LIF>
__device__ __forceinline__ void epilogue(const Params& p,
                                         unsigned char* smem,
                                         const int (&acc)[MT][CO / 8][4],
                                         const Tile& tl, int local) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tw = 1 << p.tw_shift;
  const float* cst = reinterpret_cast<const float*>(smem + p.off_consts);
  const int cg = min(CO, p.Cout - tl.co0);
  if (p.out_mode == kScalar) {
    T* out0 = static_cast<T*>(p.out0);
    T* out1 = static_cast<T*>(p.out1);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 32 * warp + 16 * m + 8 * h + (lane >> 2);
        const int gy = tl.y0 + (q >> p.tw_shift);
        const int gx = tl.x0 + (q & (tw - 1));
        if (gy >= p.H || gx >= p.W) continue;
        const size_t pix = ((size_t)tl.b * p.H + gy) * p.W + gx;
#pragma unroll
        for (int n = 0; n < CO / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * n + 2 * (lane & 3) + e;
            if (cl >= cg) continue;
            const size_t i = pix * p.Cout + tl.co0 + cl;
            const int a = acc[m][n][2 * h + e];
            if constexpr (LIF) {
              float vn, zn;
              lif<T>(a, widen(static_cast<const T*>(p.v)[i]),
                     widen(static_cast<const T*>(p.z)[i]), cl, cst, p.hard,
                     vn, zn);
              put(out0 + i, vn);
              put(out1 + i, zn);
            } else {
              put(out0 + i, __fmul_rn(__int2float_rn(a), cst[cl]));
            }
          }
      }
    return;
  }
  // staged: v and z (K2) or y (K1) in shared memory, out by TMA
  unsigned char* s0 = smem + p.off_out + (local % p.nvz) * p.out_bytes;
  unsigned char* s1 = s0 + p.out_bytes / 2;
  constexpr int SZ = sizeof(T);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 32 * warp + 16 * m + 8 * h + (lane >> 2);
      // kRows: a tile row's pixels are consecutive, Cout channels each
      const int base = p.out_mode == kRows
                           ? (q >> p.tw_shift) * p.rb +
                                 (q & (tw - 1)) * p.Cout * SZ
                           : q * p.rb;
#pragma unroll
      for (int n = 0; n < CO / 8; ++n) {
        const int cl = 8 * n + 2 * (lane & 3);
        if (cl >= cg) continue;
        const int a0 = acc[m][n][2 * h], a1 = acc[m][n][2 * h + 1];
        const int off = swizzle(base + cl * SZ, p.swz);
        T* s = reinterpret_cast<T*>(s0 + off);
        if constexpr (LIF) {
          // kPixels: cg is whole 16-byte chunks, so both channels of the
          // pair are valid and in one chunk
          T* zs = reinterpret_cast<T*>(s1 + off);
          const float2 vv = get2(s), zz = get2(zs);
          float2 vn, zn;
          lif<T>(a0, vv.x, zz.x, cl, cst, p.hard, vn.x, zn.x);
          lif<T>(a1, vv.y, zz.y, cl + 1, cst, p.hard, vn.y, zn.y);
          put2(s, vn.x, vn.y);
          put2(zs, zn.x, zn.y);
        } else {
          put(s, __fmul_rn(__int2float_rn(a0), cst[cl]));
          if (cl + 1 < cg)
            put(reinterpret_cast<T*>(s0 + swizzle(base + (cl + 1) * SZ,
                                                  p.swz)),
                __fmul_rn(__int2float_rn(a1), cst[cl + 1]));
        }
      }
    }
  if (p.out_mode == kRows) {
    // K1's heads: a tile row's pixels are one run of y, copied out by the
    // threads as whole 16-byte chunks
    __syncthreads();
    const int run = p.rb / 16;  // chunks a tile row
    const int valid = min(tw, p.W - tl.x0) * p.Cout * SZ / 16;
    for (int i = threadIdx.x; i < p.th * run; i += NT) {
      const int r = i / run;
      const int c = i - r * run;
      const int gy = tl.y0 + r;
      if (c >= valid || gy >= p.H) continue;
      *reinterpret_cast<uint4*>(
          static_cast<unsigned char*>(p.out0) +
          (((size_t)tl.b * p.H + gy) * p.W + tl.x0) * p.Cout * SZ +
          16 * c) = *reinterpret_cast<const uint4*>(s0 + r * p.rb + 16 * c);
    }
    return;
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store4(&p.map_o0, s0, tl.co0 * SZ, tl.x0, tl.y0, tl.b);
    if constexpr (LIF)
      tma_store4(&p.map_o1, s1, tl.co0 * SZ, tl.x0, tl.y0, tl.b);
    bulk_commit();
    // K1 alternates two staging buffers: the store from the other one
    // has read it before the next item writes it
    if constexpr (!LIF) bulk_wait<1, true>();
  }
}

// Channel group co0's weight rows of the block's passes, where resident
// (cp.async; they arrive on the next barrier the thread arrives on).
template <int K, int CO>
__device__ __forceinline__ void load_weights(const Params& p,
                                             unsigned char* smem,
                                             const Walk& w, int co0) {
  if (!p.w_resident) return;
  int8_t* sw = reinterpret_cast<int8_t*>(smem + p.off_w);
  for (int k = 0; k < w.np; ++k)
    copy_weights<K, CO>(p, sw + k * p.w_pass_bytes, w.pa0 + k, co0);
}

// Channel group co0's values: scale, and for K2 the leak, threshold and
// 1 - leak rounded as the update uses them; then arrive on wbar (with
// the thread's copies so far).
template <int CO, class T, bool LIF>
__device__ __forceinline__ void load_values(const Params& p,
                                            unsigned char* smem,
                                            uint64_t* wbar, int co0) {
  float* cst = reinterpret_cast<float*>(smem + p.off_consts);
  for (int cl = threadIdx.x; cl < CO; cl += NT) {
    const int co = co0 + cl;
    const bool ok = co < p.Cout;
    cst[cl] = ok ? p.scale[co] : 0.f;
    if constexpr (LIF) {
      const float l = ok ? round_as<T>(p.leak[co]) : 0.f;
      cst[32 + cl] = l;
      cst[64 + cl] = ok ? round_as<T>(p.thresh[co]) : 0.f;
      cst[96 + cl] = round_as<T>(__fsub_rn(1.f, l));
    }
  }
  mbar_arrive_copies(wbar);
}

// The whole kernel: this block's walk over its cluster's items and its
// passes, the ring, the cluster's sum where the passes are split, the
// epilogue in the cluster's first block.
template <int K, int CO, class T, bool LIF>
__device__ __forceinline__ void run(const Params& p) {
  extern __shared__ __align__(ALIGN) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* wbar = full + NS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  namespace cgr = cooperative_groups;

  const int S = p.slices;
  Walk w;
  w.rank = S > 1 ? (int)cgr::this_cluster().block_rank() : 0;
  const int cid = blockIdx.x / S;
  const int ncl = gridDim.x / S;
  w.it0 = (int)((long long)cid * p.items / ncl);
  const int it1 = (int)((long long)(cid + 1) * p.items / ncl);
  w.pa0 = w.rank * p.passes / S;
  w.np = (w.rank + 1) * p.passes / S - w.pa0;
  const int nsteps = (it1 - w.it0) * w.np;

  if (tid == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(&full[s], NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tw = 1 << p.tw_shift;
  const int SW = tw + K - 1;
  int a_pix[MT];  // the lane's pixel of each m16 tile in the halo tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = 32 * warp + 16 * m + (lane & 15);
    a_pix[m] = (q >> p.tw_shift) * SW + (q & (tw - 1));
  }

  if (tid == 0) {  // the descriptors of the maps in use, ahead of use
    const CUtensorMap* maps[6] = {&p.map_x, &p.map_zr, &p.map_v,
                                  &p.map_z, &p.map_o0, &p.map_o1};
    const bool used[6] = {p.halo_x == kTma, p.zr && p.halo_zr == kTma,
                          LIF && p.out_mode == kPixels,
                          LIF && p.out_mode == kPixels,
                          p.out_mode == kPixels,
                          LIF && p.out_mode == kPixels};
    for (int i = 0; i < 6; ++i)
      if (used[i])
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(maps[i]))
                     : "memory");
  }

  // the first group's weights, the ring's first steps and the group's
  // values, all in flight together
  unsigned wphase = 0;
  int group = w.it0 / p.tiles;
  load_weights<K, CO>(p, smem, w, group * CO);
  for (int s = 0; s < p.ns && s < nsteps; ++s)
    issue<K, CO, T, LIF>(p, smem, full, w, s);
  load_values<CO, T, LIF>(p, smem, wbar, group * CO);
  mbar_wait(wbar, wphase);
  wphase ^= 1u;

  int acc[MT][CO / 8][4] = {};
  for (int step = 0; step < nsteps; ++step) {
    const int local = step / w.np;
    const int k = step - local * w.np;
    const int item = w.it0 + local;
    if (k == 0 && item / p.tiles != group) {
      group = item / p.tiles;  // the previous step ended in __syncthreads
      load_weights<K, CO>(p, smem, w, group * CO);
      load_values<CO, T, LIF>(p, smem, wbar, group * CO);
      mbar_wait(wbar, wphase);
      wphase ^= 1u;
    }
    const int stage = step % p.ns;
    mbar_wait(&full[stage], (step / p.ns) & 1);
    int8_t* s_in =
        reinterpret_cast<int8_t*>(smem + p.off_stage + stage * p.stage_bytes);
    const Segment sg = segment(p, w.pa0 + k);
    if (sg.mode != kTma) {  // the raw bytes into place
      expand_halo<K>(p, s_in, s_in + p.halo_bytes, sg,
                     tile_of<CO>(p, item));
      fence_async_smem();  // TMA may write this stage next
      __syncthreads();
    }
    const int8_t* s_w =
        p.w_resident
            ? reinterpret_cast<const int8_t*>(smem + p.off_w) +
                  k * p.w_pass_bytes
            : s_in + p.halo_bytes + p.raw_bytes;
    taps<K, CO>(acc, s_in, s_w, a_pix, SW);
    if (k == w.np - 1) {
      if (S > 1) {
        // the cluster's sum: every block's fragments into its shared
        // memory, the first block adds the others' in rank order
        int* red = reinterpret_cast<int*>(smem + p.off_red) + tid;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < CO / 8; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              red[((m * (CO / 8) + n) * 4 + r) * NT] = acc[m][n][r];
        cgr::cluster_group cl = cgr::this_cluster();
        cl.sync();
        if (w.rank == 0)
          for (int q = 1; q < S; ++q) {
            const int* other = cl.map_shared_rank(red, q);
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
      if (w.rank == 0)
        epilogue<CO, T, LIF>(p, smem, acc, tile_of<CO>(p, item), local);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < CO / 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;
    }
    __syncthreads();  // every thread is done with this stage
    if (step + p.ns < nsteps)
      issue<K, CO, T, LIF>(p, smem, full, w, step + p.ns);
  }
  if (tid == 0) bulk_wait<0, true>();  // the stores have read their tiles
}

// ---- host side: the memory plan, the TMA maps and the launch ----

inline int align_up(int n, int a) { return (n + a - 1) / a * a; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled (null where it is missing)
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    cudaGetLastError();
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A map of a byte tensor of `rank` dimensions (innermost first) whose
// rows of dims[0] bytes lie `pitch` bytes apart (pitch >= dims[0]: an
// NHWC map's pixel stride, wider than its channels' bytes where the
// channels are padded; the boxes zero-fill past dims[0]), the outer
// dimensions packed over the rows, with `box`, under the swizzle of
// `swz_bytes` (0: none); false where the encoder refuses it.
inline bool encode(CUtensorMap* map, const void* base, int rank,
                   const cuuint64_t* dims, cuuint64_t pitch,
                   const cuuint32_t* box, int swz_bytes) {
  const EncodeTiled fn = encoder();
  if (!fn || !aligned(base, 16) || pitch < dims[0]) return false;
  cuuint64_t strides[3];
  cuuint64_t s = pitch;
  for (int i = 0; i < rank - 1; ++i) {
    strides[i] = s;
    if (s % 16) return false;
    s *= dims[i + 1];
  }
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swz_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swz_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swz_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
            const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of an NHWC tensor of `cbytes` bytes a pixel, box (bx bytes, tw,
// th, 1)
inline bool encode_nhwc(CUtensorMap* map, const void* base, const Params& p,
                        int cbytes, int bx, int tw, int th, int swz) {
  const cuuint64_t dims[4] = {(cuuint64_t)cbytes, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint32_t box[4] = {(cuuint32_t)bx, (cuuint32_t)tw, (cuuint32_t)th,
                             1};
  return encode(map, base, 4, dims, (cuuint64_t)cbytes, box, swz);
}

// Lay out the dynamic shared memory of p's plan with nvz state buffers
// and resident weights or not; returns its bytes.
template <int K, int CO, class T, bool LIF>
int layout(Params& p, int nvz, bool resident) {
  const int tw = 1 << p.tw_shift;
  const int np_max = (p.passes + p.slices - 1) / p.slices;
  p.nvz = LIF ? nvz : 2;  // K1 alternates two staging buffers
  p.w_resident = resident;
  const int sw = tw + K - 1, sh = p.th + K - 1;
  p.halo_bytes = align_up(sh * sw * PIX, ALIGN);
  // the raw area of the maps whose pixel rows are not 4-byte aligned
  int raw = 0;
  for (int i = 0; i < 2; ++i) {
    const int C = i ? p.Crec : p.Cin;
    const int need = C < CCH ? sh * raw_row(sw, C) : sh * sw * RAW_PX;
    if ((i ? p.halo_zr : p.halo_x) != kTma && (!i || p.zr) && need > raw)
      raw = need;
  }
  p.raw_bytes = align_up(raw, ALIGN);
  p.w_pass_bytes = K * K * CO * PIX;
  p.stage_bytes = p.halo_bytes + p.raw_bytes +
                  (resident ? 0 : align_up(p.w_pass_bytes, ALIGN));
  int off = 128;  // the mbarriers
  p.off_consts = off;
  off = align_up(off + 4 * 32 * 4, ALIGN);
  p.off_stage = off;
  off += p.ns * p.stage_bytes;
  p.off_w = off;
  if (resident) off += align_up(np_max * p.w_pass_bytes, ALIGN);
  p.off_out = off;
  // per buffer: v and z (K2) or y (K1); K1 alternates two
  p.out_bytes = p.out_mode == kScalar
                    ? 0
                    : align_up((LIF ? 2 : 1) * TILE * CO * (int)sizeof(T),
                               ALIGN);
  off += p.nvz * p.out_bytes;
  p.off_red = off;
  if (p.slices > 1) off += NT * MT * (CO / 8) * 4 * 4;
  return off;
}

// A layout that fits, with at most ns ring stages: resident weights with
// the deepest ring that fits, else weights in the ring, else the
// element-wise epilogue; -1 if none fits.
template <int K, int CO, class T, bool LIF>
int fit(Params& p, int nvz, int ns) {
  for (int pass = 0; pass < 2; ++pass) {
    for (bool resident : {true, false})
      for (p.ns = ns; p.ns >= 1; --p.ns) {
        const int bytes = layout<K, CO, T, LIF>(p, nvz, resident);
        if (bytes <= MAX_SMEM) return bytes;
      }
    p.out_mode = kScalar;
  }
  return -1;
}

// Blocks (slices 1) or clusters the card holds at once of kernel at smem
// bytes, cached per device.
inline cudaError_t capacity(const void* kernel, int smem, int slices,
                            int* out) {
  struct Entry {
    const void* kernel;
    int smem, slices, dev, cap;
  };
  static Entry cache[256];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].smem == smem &&
        cache[i].slices == slices && cache[i].dev == dev) {
      *out = cache[i].cap;
      return cudaSuccess;
    }
  int cap = 0;
  if (slices == 1) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cap = per_sm * sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = slices;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(slices * 64);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&cap, kernel, &cfg);
  }
  if (e != cudaSuccess) return e;
  if (cap < 1) return cudaErrorInvalidConfiguration;
  if (used < 256) cache[used++] = {kernel, smem, slices, dev, cap};
  *out = cap;
  return cudaSuccess;
}

// Launch kernel on p at tile width tw and `slices` blocks per cluster
// (ops/s8_plan.py): derive the plan's indices, encode the TMA maps the
// shapes and pointers allow, lay out shared memory, size the persistent
// grid from the occupancy API. One launch.
template <int K, int CO, class T, bool LIF>
cudaError_t launch(void (*kernel)(Params), Params& p, int tw, int slices,
                   cudaStream_t st) {
  if ((tw != 8 && tw != 16 && tw != 32) || slices < 1 ||
      slices > MAX_SLICES)
    return cudaErrorInvalidValue;
  constexpr int SZ = sizeof(T);
  p.tw_shift = tw == 8 ? 3 : tw == 16 ? 4 : 5;
  p.th = TILE / tw;
  p.tiles_x = (p.W + tw - 1) / tw;
  p.tiles_y = (p.H + p.th - 1) / p.th;
  p.tiles = p.B * p.tiles_x * p.tiles_y;
  const int groups = (p.Cout + CO - 1) / CO;
  p.items = p.tiles * groups;
  p.px = (p.Cin + CCH - 1) / CCH;
  p.passes = p.px + (p.zr ? (p.Crec + CCH - 1) / CCH : 0);
  p.slices = slices;
  if (slices > p.passes) return cudaErrorInvalidValue;
  if (!aligned(p.wx, 16) || (p.zr && !aligned(p.wr, 16)))
    return cudaErrorMisalignedAddress;  // ohwi's rows are 16-byte aligned
  // the halo by TMA where a pixel's channels are whole 16-byte rows, else
  // by words
  const int sw = tw + K - 1, sh = p.th + K - 1;
  auto halo = [&](CUtensorMap* map, const int8_t* src, int C) {
    return C % 16 == 0 && encode_nhwc(map, src, p, C, PIX, sw, sh, 32)
               ? (int)kTma
               : (int)kWords;
  };
  p.halo_x = halo(&p.map_x, p.x, p.Cin);
  p.halo_zr = p.zr ? halo(&p.map_zr, p.zr, p.Crec) : (int)kTma;
  // the output (and K2's state) staged and moved by TMA: pixels of CO
  // channels under the swizzle of their width, or (K1, one group, at most
  // 256 bytes a tile row) whole tile rows; else element by element
  p.out_mode = kScalar;
  p.swz = 0;
  const int cb = CO * SZ;  // 128, 64, 32 or 16 bytes
  const int swz = cb >= 32 ? cb : 0;
  if ((p.Cout * SZ) % 16 == 0) {
    bool ok = encode_nhwc(&p.map_o0, p.out0, p, p.Cout * SZ, cb, tw, p.th,
                          swz);
    if (LIF)
      ok = ok && encode_nhwc(&p.map_o1, p.out1, p, p.Cout * SZ, cb, tw,
                             p.th, swz) &&
           encode_nhwc(&p.map_v, p.v, p, p.Cout * SZ, cb, tw, p.th, swz) &&
           encode_nhwc(&p.map_z, p.z, p, p.Cout * SZ, cb, tw, p.th, swz);
    if (ok) {
      p.out_mode = kPixels;
      p.rb = cb;
      p.swz = swz ? (swz / 16 - 1) << 4 : 0;
    }
  }
  if (!LIF && p.out_mode == kScalar && groups == 1 && aligned(p.out0, 16) &&
      (tw * p.Cout * SZ) % 16 == 0 && (p.W * p.Cout * SZ) % 16 == 0 &&
      ((p.W % tw) * p.Cout * SZ) % 16 == 0) {
    p.out_mode = kRows;
    p.rb = tw * p.Cout * SZ;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static bool ready[MAX_DEVICES];  // per instantiation and device
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  // where no cluster takes two items: one state buffer and a ring as
  // deep as the block's passes; else two state buffers, so that the next
  // item's v and z load during this one's epilogue, and the deepest ring
  const int mode = p.out_mode;
  const int np_max = (p.passes + slices - 1) / slices;
  int smem = fit<K, CO, T, LIF>(p, 1, np_max < NS ? np_max : NS);
  if (smem < 0) return cudaErrorInvalidValue;
  int cap = 0;
  e = capacity(reinterpret_cast<const void*>(kernel), smem, slices, &cap);
  if (e != cudaSuccess) return e;
  if (p.items > cap) {
    // a step issued ns steps ahead must find a free state buffer: with
    // two, the ring may run at most one item ahead, ns <= passes + 1
    const int np_min = p.passes / slices;
    const int ns = LIF && mode == kPixels && np_min + 1 < NS ? np_min + 1
                                                              : NS;
    p.out_mode = mode;
    smem = fit<K, CO, T, LIF>(p, 2, ns);
    if (smem < 0) return cudaErrorInvalidValue;
    e = capacity(reinterpret_cast<const void*>(kernel), smem, slices, &cap);
    if (e != cudaSuccess) return e;
  }
  const int clusters = p.items < cap ? p.items : cap;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = slices;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * slices);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = slices > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

}  // namespace s8
}  // namespace evf
