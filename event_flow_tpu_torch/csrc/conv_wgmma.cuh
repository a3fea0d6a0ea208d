// The warpgroup-MMA mainloop of bfloat16 K1 and B2 at the U-Nets' and the
// gates' deep maps (ops/conv_plan.py's wgmma route: k 3, 512 input
// channels or more in whole 64-channel blocks, 64 output channels or more
// in whole 16-byte rows), for sm_90a: Hopper's wgmma.mma_async
// m64nNk16.f32.bf16.bf16 with A from registers and B from shared memory,
// the float32 sum of a whole work unit kept in the tensor core's
// registers and rounded once. Replaces, at those shapes, the same Pallas
// kernels as the float mainloops: event_flow_tpu/ops/conv_pallas.py::
// _conv_fwd (K1: the forward conv and dx) and ::_conv_dw (B2: dw).
//
// What bounds it on the H100. At RecEVFlowNet's gates (8 x 8 x 8, 1024 ->
// 1024, k 3) each of K1 and B2 does 9.66 GFLOP, 9.8 us at the bf16 peak,
// on 512 pixels; at the spiking U-Net's 8 x 8 x 8 512 -> 512 2.4 GFLOP,
// 2.4 us. The mma.sync mainloops (conv_ring.cuh::taps_bf16,
// conv_dw.cu::tile_mma_bf16) ran these at 1.8-4.9x cuDNN's bf16 time:
// mma.sync's rate alone is a fifth of the peak, each m16n8k16 went into a
// fresh fragment added on the CUDA cores, and a block's output group was
// at most 32 channels wide. Here:
//
// - The tensor core accumulates: one f32 accumulator per warpgroup stays
//   in registers over every tap and pass of a unit; no fresh fragments,
//   no adds on the CUDA cores, y or dw rounded to bfloat16 once.
// - A from registers (the RS form): wgmma's A fragment of a warp's 16
//   rows is mma.sync m16n8k16's, so ldmatrix (K1) or ldmatrix.trans (B2)
//   reads it from the swizzled halo tile at each tap's shift; a shift of
//   dy * SW + dx pixel rows is not a multiple of the 8-row swizzle atom,
//   which a descriptor (the SS form) could not address. B2 keeps A in two
//   register buffers, so that the next step loads while the last step's
//   wgmma still reads its buffer (wgmma.wait_group 1); K1's taps retire
//   their MMAs first (see k1_consume).
// - B from shared memory, staged by TMA under the 128-byte swizzle that
//   wgmma's descriptors read: K1's weights K-major (w as [Cout][k][k][Cin],
//   OHWI, boxes of 64 input channels x 128 output channels); B2's g
//   MN-major (pixel rows of 64 output channels, transposed by wgmma's
//   trans-b), so neither is repacked in shared memory.
// - The TMA boxes stay in flight on mbarrier rings (full: the bytes
//   landed; empty: every consumer thread is done), issued by a producer
//   warp (K1) or by thread 0 a few stages ahead (B2, whose three
//   warpgroups need the registers), and the grid is persistent: each block walks a run of consecutive units,
//   the ring running across them, so a unit's loads overlap the previous
//   unit's MMAs and epilogue.
//
// K1 (k1_run): M = a tile of 128 output pixels (imgs images of th x tw,
// as conv_ring.cuh's tiles span images: two 8 x 8 images a tile), two
// consumer warpgroups of 64 rows; N = 128 output channels; K = taps x
// input channels in passes of 64 (one 128-byte swizzled row a pixel). A
// unit is one tile of one channel group over one slice of the passes;
// the slices (ops/conv_plan.py::k1_plan, from the shape without Cout) end
// in float32 partial sums that a second launch adds in slice order and
// rounds once. The halo of a pass has its own ring (2 stages), the
// weight boxes of its taps another.
//
// B2 (dw_run): M = (tap, input channel) rows, 64 channels of one tap a
// warpgroup, three consumer warpgroups (dy 0, 1, 2) of three taps (dx)
// each; N = 64 output channels; K = pixels in tiles of 128 (the pixel
// tiles of b2_plan). A unit (b2_plan's item) is a 64 x 64 channel block
// over a chunk of the pixel tiles; where the items are fewer than the
// SMs the pixels split into chunks whose float32 partials a second launch
// adds in chunk order (no float atomics). A tile that overhangs the map
// masks x at its slots outside it, as conv_dw.cu does, so that a NaN
// reaches only the taps that read it.
//
// What it costs: the sums run in the tensor core's own order, so y and dw
// are not bitwise the mma.sync mainloops' (they stay within one bfloat16
// ulp plus the float32 sums' order of the plain versions); each output's
// sequence of MMAs is fixed by the plan, so they are bitwise repeatable,
// and a K1 of Cout / mp channels (a model-axis shard) runs the whole
// layer's instructions for its channels: the same bits.

#pragma once

#include "conv_s8.cuh"  // mbarriers, TMA copies and maps, swizzle

namespace evf {
namespace wg {

constexpr int TILE = 128;      // pixels a tile (K1's M, B2's K a stage)
constexpr int ROW = 128;       // bytes of a staged pixel: 64 bf16 channels
constexpr int CH = 64;         // input channels a pass or a B2 block
constexpr int K1_BN = 128;     // K1's output channels a unit
constexpr int DW_BN = 64;      // B2's output channels a unit
constexpr int W_STAGE = K1_BN * ROW;   // bytes of a weight box: 16384
constexpr int G_STAGE = TILE * ROW;    // bytes of a g box: 16384
constexpr int BARS = 1024;     // bytes of mbarriers before the stages
constexpr int HS = 2;          // K1's halo stages
constexpr int MAX_STAGES = 12;  // a ring's stages, at most
constexpr int MAX_SLICES = 16;
constexpr int K1_THREADS = 288;  // two consumer warpgroups, a producer warp
constexpr int DW_THREADS = 384;  // three consumer warpgroups
// row strides of B2's output tile in shared memory, in elements: 64
// input channels x 9 taps and 16 bytes, whole 16-byte rows for the bulk
// copies, 4 banks apart; 64 bfloat16 rows or 32 float32 ones
constexpr int OUT_RS16 = CH * 9 + 8;
constexpr int OUT_RS32 = CH * 9 + 4;
constexpr int OUT_BYTES = DW_BN * OUT_RS16 * 2;

// ---- the warpgroup MMA ----

// The descriptor of a 128-byte-swizzled operand at p (its swizzle atoms of
// 8 rows x 128 bytes 1024-byte aligned): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulator's registers neither read nor written across this point
// by other instructions (the asynchronous MMAs own them in between)
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0 .. 63] += a (registers, the m16n8k16 A fragment of each warp's
// 16 rows) x the k16 x n128 tile of B at descriptor b, K-major
__device__ __forceinline__ void mma_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0 .. 31] += a (registers, the m16n8k16 A fragment of each warp's
// 16 rows) x the k16 x n64 tile of B at descriptor b, MN-major
__device__ __forceinline__ void mma_n64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- the rings ----

// one arrival on bar, which also expects `bytes` of bulk copies
__device__ __forceinline__ void arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) of shared src to global dst (both 16-byte
// aligned) by the bulk copy engine, a bulk group of the thread
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The producer's side of a ring of n stages: wait until stage step % n is
// free again (its consumers released fill step - n).
__device__ __forceinline__ void acquire(uint64_t* empty, int step, int n) {
  if (step >= n) s8::mbar_wait(&empty[step % n], (step / n + 1) & 1);
}

// ---- tiles of 128 pixels ----

// A tile is imgs images of th rows of tw pixels; pixel p of a tile is
// (img * th + row) * tw + col, 1 << pix_log pixels an image.
struct Geo {
  int B, H, W;
  int tw, tw_log, th, imgs, pix_log, tiles_x, tiles_y, tiles;
};

struct Origin {
  int b0, y0, x0;
};

__device__ __forceinline__ Origin origin_of(const Geo& g, int t) {
  const int per_img = g.tiles_x * g.tiles_y;
  const int bt = t / per_img;
  const int r = t - bt * per_img;
  const int ty = r / g.tiles_x;
  return {bt * g.imgs, ty * g.th, (r - ty * g.tiles_x) * g.tw};
}

// the halo pixel of tile pixel p, in a halo of sw x sh pixels an image
__device__ __forceinline__ int halo_px(const Geo& g, int p, int sw, int sh) {
  const int img = p >> g.pix_log;
  const int r = p & ((1 << g.pix_log) - 1);
  return (img * sh + (r >> g.tw_log)) * sw + (r & (g.tw - 1));
}

// the NHWC pixel index of tile pixel p, or -1 outside the map
__device__ __forceinline__ long long pixel_index(const Geo& g,
                                                 const Origin& o, int p) {
  const int r = p & ((1 << g.pix_log) - 1);
  const int b = o.b0 + (p >> g.pix_log);
  const int y = o.y0 + (r >> g.tw_log);
  const int x = o.x0 + (r & (g.tw - 1));
  if (b >= g.B || y >= g.H || x >= g.W) return -1;
  return ((long long)b * g.H + y) * g.W + x;
}

// the 16-byte chunk `off` of a halo under TMA's 128-byte swizzle
__device__ __forceinline__ const unsigned char* at(const unsigned char* base,
                                                   int off) {
  return base + s8::swizzle(off, 0x70);
}

// ---- K1 ----

struct K1Params {
  CUtensorMap map_x;  // x: boxes of 64 channels over a tile's halo
  CUtensorMap map_w;  // w OHWI: boxes of 64 input channels of a tap x 128
  void* y;            // bf16 y [B, H, W, Cout] (one slice)
  float* part;        // else float32 partials [slices][B*H*W][Cout]
  Geo g;
  int Cin, Cout, groups, passes, slices, units;
  int hs_bytes;       // bytes of a halo stage
  int ws;             // weight stages
  int off_w;          // byte offset of the weight stages
};

// Unit u: tile t of channel group n over slice q of the passes.
struct Unit {
  int t, n, q;
};

__device__ __forceinline__ Unit unit_of(const K1Params& p, int u) {
  const int t = u % p.g.tiles;
  const int r = u / p.g.tiles;
  return {t, r % p.groups, r / p.groups};
}

// The block's units: a run of consecutive ones.
__device__ __forceinline__ void block_units(int units, int* u0, int* u1) {
  *u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  *u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
}

// The producer: every unit's passes, each pass's halo box into the halo
// ring and its taps' weight boxes into the weight ring.
template <int K>
__device__ __forceinline__ void k1_produce(const K1Params& p,
                                           unsigned char* smem) {
  constexpr int P = K / 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t *full_h = bars, *empty_h = bars + HS;
  uint64_t *full_w = bars + 2 * HS, *empty_w = full_w + MAX_STAGES;
  const unsigned halo_tx =
      p.g.imgs * (p.g.th + K - 1) * (p.g.tw + K - 1) * ROW;
  int u0, u1;
  block_units(p.units, &u0, &u1);
  int hstep = 0, wstep = 0;
  for (int u = u0; u < u1; ++u) {
    const Unit un = unit_of(p, u);
    const Origin o = origin_of(p.g, un.t);
    const int pa0 = un.q * p.passes / p.slices;
    const int pa1 = (un.q + 1) * p.passes / p.slices;
    for (int pass = pa0; pass < pa1; ++pass, ++hstep) {
      const int hs = hstep % HS;
      acquire(empty_h, hstep, HS);
      arrive_expect(&full_h[hs], halo_tx);
      s8::tma_load(smem + BARS + hs * p.hs_bytes, &p.map_x, pass * ROW,
                   o.x0 - P, o.y0 - P, o.b0, &full_h[hs]);
      for (int tap = 0; tap < K * K; ++tap, ++wstep) {
        const int ws = wstep % p.ws;
        acquire(empty_w, wstep, p.ws);
        arrive_expect(&full_w[ws], W_STAGE);
        s8::tma_load(smem + p.off_w + ws * W_STAGE, &p.map_w, pass * ROW,
                     tap, un.n * K1_BN, 0, &full_w[ws]);
      }
    }
  }
}

// y (or the slice's partial) from the accumulator of the warpgroup's 64
// rows: acc[4 j + 2 h + e] is row 16 (warp % 4) + lane / 4 + 8 h of the
// warpgroup, channel 8 j + 2 (lane % 4) + e of the group; element pairs
// (Cout is a multiple of 8).
__device__ __forceinline__ void k1_store(const K1Params& p, const Unit& un,
                                         const Origin& o, int row0,
                                         const float (&acc)[64]) {
  const int lane = threadIdx.x & 31;
  const long long npix = (long long)p.g.B * p.g.H * p.g.W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long pix = pixel_index(p.g, o, row0 + (lane >> 2) + 8 * h);
    if (pix < 0) continue;
#pragma unroll
    for (int j = 0; j < K1_BN / 8; ++j) {
      const int co = un.n * K1_BN + 8 * j + 2 * (lane & 3);
      if (co >= p.Cout) continue;
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      const long long i = pix * p.Cout + co;  // even: Cout is
      if (p.slices == 1)
        put2(static_cast<bf16*>(p.y) + i, a0, a1);
      else
        put2(p.part + un.q * npix * p.Cout + i, a0, a1);
    }
  }
}

// A consumer warpgroup: its 64 rows of every unit, tap after tap of every
// pass, four k16 steps a tap: the tap's A by ldmatrix from the halo at the
// tap's shift, its four MMAs, which retire before the next tap loads A
// (wgmma.wait_group 0: keeping a tap's MMAs in flight while the next tap's
// A loaded made ptxas insert waits and measured 4-10 % slower,
// wgmma_probe.py variants; the two warpgroups' MMAs interleave on the
// tensor cores).
template <int K>
__device__ __forceinline__ void k1_consume(const K1Params& p,
                                           unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t *full_h = bars, *empty_h = bars + HS;
  uint64_t *full_w = bars + 2 * HS, *empty_w = full_w + MAX_STAGES;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3);
  const int sw = p.g.tw + K - 1, sh = p.g.th + K - 1;
  // the byte of the lane's ldmatrix row (pixel row0 + lane % 16, the
  // 16-byte chunk lane / 16 of a k16 step) in the unshifted halo
  const int a_off = halo_px(p.g, row0 + (lane & 15), sw, sh) * ROW +
                    (lane >> 4) * 16;
  int u0, u1;
  block_units(p.units, &u0, &u1);
  int hstep = 0, wstep = 0;
  float acc[64];
  for (int u = u0; u < u1; ++u) {
    const Unit un = unit_of(p, u);
    const int pa0 = un.q * p.passes / p.slices;
    const int pa1 = (un.q + 1) * p.passes / p.slices;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int pass = pa0; pass < pa1; ++pass, ++hstep) {
      const int hs = hstep % HS;
      s8::mbar_wait(&full_h[hs], (hstep / HS) & 1);
      const unsigned char* halo = smem + BARS + hs * p.hs_bytes;
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap, ++wstep) {
        const int shift = ((tap / K) * sw + tap % K) * ROW;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(a[kk], at(halo, a_off + shift + 32 * kk));
        if (tap == K * K - 1) arrive(&empty_h[hs]);  // A is in registers
        const int ws = wstep % p.ws;
        s8::mbar_wait(&full_w[ws], (wstep / p.ws) & 1);
        // the k16 steps 32 bytes apart inside the swizzled rows
        const uint64_t b = desc(smem + p.off_w + ws * W_STAGE, 16, 1024);
        hold(acc);
        fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_n128(acc, a[kk], b + 2 * kk);
        commit();
        wait<0>();
        hold(acc);
        arrive(&empty_w[ws]);
      }
    }
    k1_store(p, un, origin_of(p.g, un.t), row0, acc);
  }
}

template <int K>
__device__ __forceinline__ void k1_run(const K1Params& p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < HS; ++s) {
      s8::mbar_init(&bars[s], 1);
      s8::mbar_init(&bars[HS + s], 256);
    }
    for (int s = 0; s < p.ws; ++s) {
      s8::mbar_init(&bars[2 * HS + s], 1);
      s8::mbar_init(&bars[2 * HS + MAX_STAGES + s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&p.map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&p.map_w))
                 : "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) k1_produce<K>(p, smem);
  } else {
    k1_consume<K>(p, smem);
  }
}

// ---- B2 ----

struct DwParams {
  CUtensorMap map_x;  // x: boxes of 64 channels over a tile's halo
  CUtensorMap map_g;  // g: boxes of 64 output channels over a tile
  void* dst;          // bf16 dw OIHW (one chunk) or float32 [chunks][numel]
  Geo g;
  int Cin, Cout, cblocks, coblocks, per_chunk, chunks, items;
  int halo_bytes, stage_bytes, ns;
  int off_out;        // byte offset of the epilogue's tile
};

// item i: channel block cbi, output block cob over chunk of the pixel
// tiles [t0, t0 + n) (ops/conv_plan.py::B2Plan.item)
struct DwItem {
  int c0, co0, chunk, t0, n;
};

__device__ __forceinline__ DwItem dw_item(const DwParams& p, int i) {
  const int outs = p.cblocks * p.coblocks;
  const int chunk = i / outs;
  const int o = i - chunk * outs;
  const int cbi = o / p.coblocks;
  const int t0 = chunk * p.per_chunk;
  return {cbi * CH, (o - cbi * p.coblocks) * DW_BN, chunk, t0,
          min(p.per_chunk, p.g.tiles - t0)};
}

// Thread 0's side of B2's ring: stage the walk's pixel tiles in order,
// each a halo box of x and a g box into stage `issued` % ns, once every
// consumer thread has released the fill before.
template <int K>
struct DwIssuer {
  int item, tile, issued, end;
  DwItem it;

  __device__ __forceinline__ void next(const DwParams& p, unsigned char* smem,
                                       uint64_t* full, uint64_t* empty) {
    constexpr int P = K / 2;
    if (item >= end) return;
    const int s = issued % p.ns;
    const Origin o = origin_of(p.g, it.t0 + tile);
    unsigned char* dst = smem + BARS + s * p.stage_bytes;
    acquire(empty, issued, p.ns);
    arrive_expect(&full[s],
                  p.g.imgs * (p.g.th + K - 1) * (p.g.tw + K - 1) * ROW +
                      G_STAGE);
    s8::tma_load(dst, &p.map_x, it.c0 * 2, o.x0 - P, o.y0 - P, o.b0,
                 &full[s]);
    s8::tma_load(dst + p.halo_bytes, &p.map_g, it.co0 * 2, o.x0, o.y0, o.b0,
                 &full[s]);
    ++issued;
    if (++tile == it.n) {
      tile = 0;
      if (++item < end) it = dw_item(p, item);
    }
  }
};

// 0xffff in each bf16 half of a register whose pixel slot (p, p + 1) of a
// tile lies inside the map
__device__ __forceinline__ uint32_t keep2(const Geo& g, const Origin& o,
                                          int p) {
  return (pixel_index(g, o, p) >= 0 ? 0xffffu : 0u) |
         (pixel_index(g, o, p + 1) >= 0 ? 0xffff0000u : 0u);
}

// A consumer warpgroup (dy = warpgroup): taps (dy, 0 .. K - 1) of the
// item's 64 input channels, rows 16 (warp % 4) .. + 15 a warp; eight k16
// steps a pixel tile, each step's A of the three taps (ldmatrix.trans
// from the halo) in one of two register buffers. Thread 0 also keeps the
// ring ns - 1 tiles ahead, issuing a tile as the tile before this one is
// released (a producer warp's registers would leave the three warpgroups
// too few for their 96 accumulators).
template <int K, class TO>
__device__ __forceinline__ void dw_consume(const DwParams& p,
                                           unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int dy = tid >> 7;
  const int wi = (tid >> 5) & 3;
  const int sw = p.g.tw + K - 1, sh = p.g.th + K - 1;
  // the lane's ldmatrix row: pixel lane % 8 + 8 (lane / 16) of a step, the
  // 8 channels 16 wi + 8 ((lane / 8) % 2) of the block
  const int a_pix = (lane & 7) + 8 * (lane >> 4);
  const int a_chunk = (2 * wi + ((lane >> 3) & 1)) * 16 + dy * sw * ROW;
  const int t2 = 2 * (lane & 3);
  const long long numel = (long long)p.Cout * p.Cin * K * K;
  int i0, i1;
  block_units(p.items, &i0, &i1);
  DwIssuer<K> ring = {i0, 0, 0, i1, {}};
  if (tid == 0 && i0 < i1) {
    ring.it = dw_item(p, i0);
    for (int s = 0; s < p.ns - 1; ++s) ring.next(p, smem, full, empty);
  }
  int step = 0, pend = -1;
  float acc[K][32];
  uint32_t a[2][K][4];
  for (int i = i0; i < i1; ++i) {
    const DwItem it = dw_item(p, i);
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
    for (int t = 0; t < it.n; ++t, ++step) {
      const int s = step % p.ns;
      s8::mbar_wait(&full[s], (step / p.ns) & 1);
      const unsigned char* x = smem + BARS + s * p.stage_bytes;
      const unsigned char* gt = x + p.halo_bytes;
      const Origin o = origin_of(p.g, it.t0 + t);
      const bool partial = o.b0 + p.g.imgs > p.g.B ||
                           o.y0 + p.g.th > p.g.H || o.x0 + p.g.tw > p.g.W;
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks) {
        uint32_t(&ak)[K][4] = a[ks & 1];
        const int base = halo_px(p.g, 16 * ks + a_pix, sw, sh) * ROW + a_chunk;
#pragma unroll
        for (int j = 0; j < K; ++j) ldsm_x4_t(ak[j], at(x, base + j * ROW));
        if (partial) {
          // the fragment's k slots 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t +
          // 9 (a[2], a[3]) of the step, x zero where they lie outside
          const uint32_t lo = keep2(p.g, o, 16 * ks + t2);
          const uint32_t hi = keep2(p.g, o, 16 * ks + t2 + 8);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            ak[j][0] &= lo;
            ak[j][1] &= lo;
            ak[j][2] &= hi;
            ak[j][3] &= hi;
          }
        }
        const uint64_t b = desc(gt + ks * 16 * ROW, 1024, 1024);
#pragma unroll
        for (int j = 0; j < K; ++j) hold(acc[j]);
        fence();
#pragma unroll
        for (int j = 0; j < K; ++j) mma_n64(acc[j], ak[j], b);
        commit();
        wait<1>();  // the previous step's MMAs are done
#pragma unroll
        for (int j = 0; j < K; ++j) hold(acc[j]);
        if (ks == 0) {
          if (pend >= 0) arrive(&empty[pend]);  // the previous tile's stage
          pend = -1;
          if (tid == 0) ring.next(p, smem, full, empty);
        }
      }
      pend = s;
    }
    wait<0>();
#pragma unroll
    for (int j = 0; j < K; ++j) hold(acc[j]);
    if (pend >= 0) arrive(&empty[pend]);
    pend = -1;
    // acc[j][4 n + 2 h + e] is input channel c0 + 16 wi + lane / 4 + 8 h,
    // output channel co0 + 8 n + 2 (lane % 4) + e, tap (dy, j). The tile
    // goes through shared memory as rows of (ci, tap), one an output
    // channel: a run of dw's OIHW order, which one thread a row then
    // writes by a bulk copy while the warpgroups go on to the next item
    // (from the registers, a warp's 2-byte stores, 9 elements apart, fell
    // on dozens of 32-byte sectors each). bfloat16 rows of all 64 channels
    // at once; float32 partials 32 at a time.
    constexpr bool F32 = sizeof(TO) == 4;
    constexpr int NP = F32 ? 4 : 8;  // n8 tiles a pass
    constexpr int RS = F32 ? OUT_RS32 : OUT_RS16;  // elements a row
    TO* s_out = reinterpret_cast<TO*>(smem + p.off_out);
    const unsigned bytes =
        min(CH, p.Cin - it.c0) * K * K * (unsigned)sizeof(TO);
    TO* out = static_cast<TO*>(p.dst) + it.chunk * numel +
              (long long)it.c0 * K * K;
#pragma unroll
    for (int pass = 0; pass < 8 / NP; ++pass) {
      if (tid < 8 * NP) s8::bulk_wait<0, true>();  // the rows are read
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            TO* d = s_out + (8 * n + t2 + e) * RS +
                    (16 * wi + (lane >> 2) + 8 * h) * (K * K) + dy * K;
#pragma unroll
            for (int j = 0; j < K; ++j)
              put(d + j, acc[j][4 * (n + pass * NP) + 2 * h + e]);
          }
      s8::fence_async_smem();  // the copies read what these threads wrote
      __syncthreads();
      const int co = it.co0 + pass * 8 * NP + tid;
      if (tid < 8 * NP && co < p.Cout) {
        bulk_store(out + (long long)co * p.Cin * K * K, s_out + tid * RS,
                   bytes);
        s8::bulk_commit();
      }
    }
  }
  if (tid < 64) s8::bulk_wait<0, false>();  // the last rows are written
}

template <int K, class TO>
__device__ __forceinline__ void dw_run(const DwParams& p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ns; ++s) {
      s8::mbar_init(&bars[s], 1);
      s8::mbar_init(&bars[MAX_STAGES + s], 128 * K);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&p.map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&p.map_g))
                 : "memory");
  }
  __syncthreads();
  dw_consume<K, TO>(p, smem);
}

// out[e] = the float32 sum of part[0][e], part[1][e], ... in that order,
// rounded once to bfloat16: the slices' (K1) or chunks' (B2) partials;
// four elements a thread (n a multiple of 4, part 16-byte aligned)
__device__ __forceinline__ void sum_parts(const float* __restrict__ part,
                                          bf16* __restrict__ out, int parts,
                                          long long n) {
  for (long long e = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
       e < n; e += 4ll * gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(part + e);
    for (int q = 1; q < parts; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(part + q * n + e);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    put2(out + e, s.x, s.y);
    put2(out + e + 2, s.z, s.w);
  }
}

// ---- host side ----

// p's tiles of imgs images of 128 / (tw imgs) rows of tw pixels; false
// where the plan is not one the kernels take
inline bool set_geo(Geo& g, int B, int H, int W, int tw, int imgs) {
  if ((tw != 8 && tw != 16 && tw != 32) || imgs < 1 || (imgs & (imgs - 1)) ||
      tw * imgs > TILE)
    return false;
  g.B = B, g.H = H, g.W = W;
  g.tw = tw;
  g.tw_log = tw == 8 ? 3 : tw == 16 ? 4 : 5;
  g.imgs = imgs;
  g.th = TILE / (tw * imgs);
  int s = 0;
  while ((1 << s) < g.th * tw) ++s;
  g.pix_log = s;
  g.tiles_x = (W + tw - 1) / tw;
  g.tiles_y = (H + g.th - 1) / g.th;
  g.tiles = ((B + imgs - 1) / imgs) * g.tiles_x * g.tiles_y;
  return true;
}

// bytes of a tile's halo at k (rows of 128 bytes), from a swizzle atom
inline int halo_bytes(const Geo& g, int K) {
  return s8::align_up(g.imgs * (g.th + K - 1) * (g.tw + K - 1) * ROW,
                      1024);
}

// the map of an NHWC bfloat16 tensor of C channels a pixel, its pixels Cs
// apart, boxes of 64 channels over (w, h) pixels of imgs images, under the
// 128-byte swizzle; false where TMA does not take it
inline bool encode_map(CUtensorMap* map, const void* base, const Geo& g,
                       int C, int Cs, int w, int h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C * 2, (cuuint64_t)g.W,
                              (cuuint64_t)g.H, (cuuint64_t)g.B};
  const cuuint32_t box[4] = {(cuuint32_t)ROW, (cuuint32_t)w, (cuuint32_t)h,
                             (cuuint32_t)g.imgs};
  return (Cs * 2) % 16 == 0 &&
         s8::encode(map, base, 4, dims, (cuuint64_t)Cs * 2, box, 128);
}

}  // namespace wg
}  // namespace evf
