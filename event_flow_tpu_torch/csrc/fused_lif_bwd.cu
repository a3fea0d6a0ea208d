// B4: backward of the LIF update, for sm_90a: FP32 maps, or bfloat16
// maps computed in FP32 with bfloat16 g_cur and g_vin written.
//
// Replaces event_flow_tpu/ops/fused_lif_pallas.py::_fused_bwd_elem
// (_bwd_kernel), line by line; on bfloat16 maps it too widens every input
// to float32, keeps leak, thresh and the two per-channel sums float32, and
// rounds g_cur and g_vin once (fused_lif_pallas.py:231-245). With leak l
// and threshold th post-squash,
// the saved v, z, v' and the cotangents g_v, g_z of (v', z'):
//
//   sg    = surrogate(v' - th)
//   vbar  = g_v + g_z*sg             total cotangent on v'
//   tbar  = -g_z*sg                  (soft reset: - vbar*z)
//   (1-l)*cur = v' - v*l*(1-z)       hard   (no conv recompute)
//             = v' - v*l + z*th      soft
//   g_cur = vbar*(1-l)
//   g_vin = vbar*l*(1-z)             hard; vbar*l soft
//   lbar  = vbar*(v*(1-z) - cur)     hard; vbar*(v - cur) soft, with cur
//           recovered by dividing by (1-l) clamped >= 1e-6
//   g_leak[c] = sum lbar, g_thresh[c] = sum tbar over all pixels
//
// What bounds it: five maps read and two written, about 118 MB at the
// training recipe (8 x 128 x 128 x 32, FP32) for some 30 FLOP per element
// and no products, so device memory (about 35 us at 3.35 TB/s; bfloat16
// half the bytes). The design streams the maps in one launch:
//
// - Units of work. A pixel's row of C channels is one segment, or is cut
//   into segments of SEG_BYTES where it holds SPLIT_BYTES or more (the
//   U-Net's 128 to 512 float32 channels, 256 and 512 bfloat16 ones); a
//   segment's pixels are cut into chunks of at most CHUNK_BYTES a map
//   (fewer pixels where that leaves under MIN_CHUNKS chunks), the chunks
//   into at most MAX_SLICES slices of consecutive chunks. A unit is one
//   segment of one slice. All of it depends on the shape alone. A
//   persistent grid, as many blocks as the card holds at once (and no
//   more than the units), walks the units round robin. Segments give the
//   deep, small maps enough units with few partial sums each: at 8 x 8 x
//   8 x 512 in float32 a unit is 32 pixels of 32 channels, 256 units with
//   16 partials per channel, where whole rows gave 256 units of 2 pixels
//   with 256 partials per channel to write and add.
// - Loads in flight. Where every map's address and C * sizeof(T) are
//   multiples of 16 bytes, threads load 16-byte vectors of their segment
//   straight from device memory (ld.global.v4), the five maps of BATCH
//   pixels (two float32, one bfloat16) before their first use. Float32
//   maps whose pixel's row is one segment (a chunk is then one contiguous
//   run of each map) go through a ring instead: thread 0 copies the five
//   maps of each chunk into STAGES shared-memory stages with
//   one-dimensional bulk copies (cp.async.bulk) completing on an mbarrier
//   per stage, STAGES chunks ahead of the block's threads, which read
//   them as 16-byte vectors. Both write g_cur and g_vin as 16-byte vector
//   stores. In the float32 training updates on the H100 the ring took 3 %
//   less time than vector loads on whole rows; in bfloat16 the two were
//   level, so bfloat16 keeps the one path; and on the U-Net's deep maps
//   the segmented vector loads took far less than the ring on whole rows
//   (PERF.md). Other maps (a view at an odd offset, C * sizeof(T) not a
//   multiple of 16) take the scalar path of the same kernel: one element
//   per load. The wrapper checks the alignment and passes the flag.
// - Per-channel sums in a fixed order, in the same launch. A thread owns
//   fixed channels of its unit's segment (W consecutive ones, and every
//   NT-th group of them above NT groups) and adds their leak and
//   threshold terms in registers in a fixed order; at the unit's end the
//   block adds its threads' sums in a fixed tree (warp shuffles where a
//   warp holds several pixels of a channel, then rows of shared memory in
//   order) and writes one partial per slice and channel into the
//   caller's [2C, slices] scratch. After a grid-wide barrier (the kernel
//   is a cooperative launch, its grid no larger than the co-resident
//   blocks), the lanes of a warp add a column's partials in a fixed order
//   and a fixed shuffle tree. No float atomics, no state that outlives
//   the call: the sums are bitwise the same from run to run, and they do
//   not depend on the card's SM count.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;
constexpr int MAX_C = 2048;
constexpr int MAPS = 5;               // v, z, v_out, g_v, g_z
constexpr int CHUNK_BYTES = 8192;     // per map, at most
constexpr int STAGES = 2;             // chunks in the ring
constexpr int MIN_CHUNKS = 256;       // chunks get smaller below this count
constexpr int MAX_SLICES = 256;       // partials per channel
constexpr int SEG_BYTES = 128;        // a segment of a pixel's row
constexpr int SPLIT_BYTES = 512;      // rows from this size are segmented
constexpr int RED = 4096;             // floats of the block's sum rows
constexpr int MAX_DEVICES = 64;
static_assert(CHUNK_BYTES >= MAX_C * 4, "a chunk holds at least a pixel");

enum Surrogate { kArctan = 0, kSuper = 1, kTriangle = 2, kMG = 3 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gauss(float x, float mu, float sigma) {
  const float d = x - mu;
  return expf(-(d * d) / (2.f * sigma * sigma)) /
         (sigma * 2.5066282746310002f);  // sqrt(2 pi)
}

// the surrogate gradient of the Heaviside at d = v' - th
// (fused_lif_pallas.py::_surrogate)
template <int S>
__device__ __forceinline__ float surrogate(float d, float w) {
  if constexpr (S == kArctan) {
    return 1.f / (1.f + w * d * d);
  } else if constexpr (S == kSuper) {
    const float a = 1.f + w * fabsf(d);
    return 1.f / (a * a);
  } else if constexpr (S == kTriangle) {
    return fmaxf(1.f - w * fabsf(d), 0.f);
  } else {
    return 1.15f * gauss(d, 0.f, w) - 0.15f * gauss(d, w, 6.f * w) -
           0.15f * gauss(d, -w, 6.f * w);
  }
}

// W consecutive elements of T as loaded: 16 bytes where W > 1
template <class T, int W>
using Raw = typename std::conditional<W == 1, T, uint4>::type;

template <class T, int W>
__device__ __forceinline__ Raw<T, W> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, W>*>(p);
}

// element w of a raw pack as a float
template <int W>
__device__ __forceinline__ float widen(float a, int) { return a; }
template <int W>
__device__ __forceinline__ float widen(bf16 a, int) {
  return __bfloat162float(a);
}
template <int W>
__device__ __forceinline__ float widen(const uint4& q, int w) {
  const unsigned u = w / (W / 4) == 0   ? q.x
                     : w / (W / 4) == 1 ? q.y
                     : w / (W / 4) == 2 ? q.z
                                        : q.w;
  if constexpr (W == 4) {
    return __uint_as_float(u);
  } else {
    static_assert(W == 8, "16 bytes of float or bfloat16");
    // the low half of a 32-bit word holds the lower address
    return __uint_as_float(w % 2 == 0 ? u << 16 : u & 0xffff0000u);
  }
}

// the W floats of a, each rounded once to T, at p
template <int W>
__device__ __forceinline__ void store_pack(float* p, const float (&a)[W]) {
  if constexpr (W == 1) {
    *p = a[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
}

template <int W>
__device__ __forceinline__ void store_pack(bf16* p, const float (&a)[W]) {
  if constexpr (W == 1) {
    *p = __float2bfloat16_rn(a[0]);
  } else {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive once and expect `bytes` of bulk copies on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
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

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <class T>
struct Params {
  const T* maps[MAPS];  // v, z, v_out, g_v, g_z: [npix, C]
  const float* leak;    // [C]
  const float* thresh;  // [C]
  T* g_cur;             // [npix, C]
  T* g_vin;             // [npix, C]
  float* part;          // [2C, slices] scratch
  float* g_lt;          // [2C]: g_leak, g_thresh
  long long npix;
  long long nchunks;    // chunks of a segment's column of pixels
  int C;
  int segments;         // a pixel's C channels cut into equal segments
  int chunk_pix;
  int slices;
  float width;
};

// How [npix, C] maps of elem-byte elements are cut; it depends on the
// shape alone. A pixel's row of C channels is one segment, or segments
// of SEG_BYTES where the row is at least SPLIT_BYTES; a segment's pixels
// are cut into chunks of chunk_pix, the chunks into slices; a unit of
// work is one segment of one slice, and each unit writes one partial per
// channel of its segment.
struct Geometry {
  int segments;
  int chunk_pix;
  long long nchunks;
  int slices;
};

Geometry geometry(long long npix, int C, int elem) {
  Geometry g;
  const long long row = (long long)C * elem;
  g.segments = row >= SPLIT_BYTES && row % SEG_BYTES == 0
                   ? (int)(row / SEG_BYTES)
                   : 1;
  const long long by_bytes = CHUNK_BYTES / (row / g.segments);
  const long long by_count = (npix * g.segments + MIN_CHUNKS - 1) / MIN_CHUNKS;
  const long long pix = by_count < by_bytes ? by_count : by_bytes;
  g.chunk_pix = (int)(pix < 1 ? 1 : pix);
  g.nchunks = (npix + g.chunk_pix - 1) / g.chunk_pix;
  g.slices = (int)(g.nchunks < MAX_SLICES ? g.nchunks : MAX_SLICES);
  return g;
}

// the first chunk of slice s; slice s holds chunks [first(s), first(s+1))
__device__ __forceinline__ long long slice_first(long long nchunks,
                                                 int slices, int s) {
  return (long long)s * nchunks / slices;
}

// One block walks units blockIdx.x, blockIdx.x + gridDim.x, ... (unit u:
// segment u % segments of slice u / segments); its threads own packs of W
// consecutive channels: with P packs in a segment, thread t takes pack
// t % P of the pixels t / P, t / P + NT / P, ... of a chunk when P <= NT,
// else packs t, t + NT, ... of every pixel. RING_PATH: the five maps
// staged by bulk copies (float32, W > 1, whole rows: one segment).
template <int S, bool HARD, class T, int W, bool RING_PATH>
__global__ void __launch_bounds__(NT) lif_bwd_kernel(const Params<T> p) {
  constexpr int K = (MAX_C / W + NT - 1) / NT;  // pack groups per thread
  // pixels whose loads are all issued before the first use: a bfloat16
  // pack already holds twice the elements of a float32 one
  constexpr int BATCH = sizeof(T) == 4 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ float red[RED];
  __shared__ __align__(8) uint64_t full[STAGES];

  const int t = threadIdx.x;
  const int C = p.C;
  const int CS = C / p.segments;  // channels of a segment
  const int P = CS / W;
  const int lanes = P <= NT ? NT / P : 1;
  const int pack = P <= NT ? t % P : t;
  const int lane = P <= NT ? t / P : 0;
  const bool active = lane < lanes;
  const long long npix = p.npix;
  const int U = p.slices;
  const int units = U * p.segments;

  float sum_l[K][W], sum_t[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int w = 0; w < W; ++w) sum_l[k][w] = sum_t[k][w] = 0.f;

  // thread 0's producer cursor (the ring path has one segment: units are
  // slices), STAGES chunks ahead of the consumers
  int p_unit = blockIdx.x;
  long long p_c = slice_first(p.nchunks, U, p_unit);
  long long p_end = slice_first(p.nchunks, U, p_unit + 1);
  auto issue = [&](int stage) {
    const long long p0 = p_c * p.chunk_pix;
    const long long np = npix - p0 < p.chunk_pix ? npix - p0 : p.chunk_pix;
    const unsigned bytes = (unsigned)(np * C * (long long)sizeof(T));
    mbar_expect(&full[stage], MAPS * bytes);
#pragma unroll
    for (int m = 0; m < MAPS; ++m)
      bulk_load(ring + (stage * MAPS + m) * CHUNK_BYTES,
                p.maps[m] + p0 * C, bytes, &full[stage]);
    if (++p_c == p_end) {
      p_unit += gridDim.x;
      p_c = slice_first(p.nchunks, U, p_unit);
      p_end = slice_first(p.nchunks, U, p_unit + 1);
    }
  };
  if constexpr (RING_PATH) {
    if (t == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0)
      for (int s = 0; s < STAGES && p_unit < units; ++s) issue(s);
  }

  int stage = 0;
  unsigned parity = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int sl = unit / p.segments;
    const int c0 = unit % p.segments * CS;  // the segment's first channel
    // leak and threshold of the first pack group, kept; later groups
    // (more than NT packs a segment) reload theirs per chunk
    float lk0[W], th0[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      lk0[w] = active ? p.leak[c0 + pack * W + w] : 0.f;
      th0[w] = active ? p.thresh[c0 + pack * W + w] : 0.f;
    }
    const long long c_end = slice_first(p.nchunks, U, sl + 1);
    for (long long c = slice_first(p.nchunks, U, sl); c < c_end; ++c) {
      const long long p0 = c * p.chunk_pix;
      const int cp = (int)(npix - p0 < p.chunk_pix ? npix - p0 : p.chunk_pix);
      const T* src[MAPS];
#pragma unroll
      for (int m = 0; m < MAPS; ++m)
        src[m] = RING_PATH ? reinterpret_cast<const T*>(
                                 ring + (stage * MAPS + m) * CHUNK_BYTES)
                           : p.maps[m] + p0 * C + c0;
      T* const cur_out = p.g_cur + p0 * C + c0;
      T* const vin_out = p.g_vin + p0 * C + c0;
      if constexpr (RING_PATH) mbar_wait(&full[stage], parity);

#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int pk = pack + k * NT;  // this group's pack of each pixel
        if (!active || pk >= P) continue;
        float lk[W], th[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          lk[w] = k == 0 ? lk0[w] : __ldg(p.leak + c0 + pk * W + w);
          th[w] = k == 0 ? th0[w] : __ldg(p.thresh + c0 + pk * W + w);
        }
        for (int q0 = lane; q0 < cp; q0 += lanes * BATCH) {
          // every load of the batch before the first use
          Raw<T, W> x[BATCH][MAPS];
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            const int q = q0 + b * lanes;
            if (q < cp)
#pragma unroll
              for (int m = 0; m < MAPS; ++m)
                x[b][m] = load_raw<T, W>(src[m] + (size_t)q * C + pk * W);
          }
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            const int q = q0 + b * lanes;
            if (q >= cp) continue;
            float g_cur[W], g_vin[W];
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const float vv = widen<W>(x[b][0], w);
              const float zz = widen<W>(x[b][1], w);
              const float vo = widen<W>(x[b][2], w);
              const float gz = widen<W>(x[b][4], w);
              const float l = lk[w], thr = th[w];
              const float one_m_l = 1.f - l;
              const float div = fmaxf(one_m_l, 1e-6f);
              const float sg = surrogate<S>(vo - thr, p.width);
              const float vbar = widen<W>(x[b][3], w) + gz * sg;
              float tbar = -gz * sg;
              float lbar;
              if constexpr (HARD) {
                const float cur_scaled = vo - vv * l * (1.f - zz);
                g_vin[w] = vbar * l * (1.f - zz);
                lbar = vbar * (vv * (1.f - zz) - cur_scaled / div);
              } else {
                const float cur_scaled = vo - vv * l + zz * thr;
                g_vin[w] = vbar * l;
                lbar = vbar * (vv - cur_scaled / div);
                tbar = tbar - vbar * zz;
              }
              g_cur[w] = vbar * one_m_l;
              sum_l[k][w] += lbar;
              sum_t[k][w] += tbar;
            }
            const size_t off = (size_t)q * C + pk * W;
            store_pack(cur_out + off, g_cur);
            store_pack(vin_out + off, g_vin);
          }
        }
      }

      if constexpr (RING_PATH) {
        __syncthreads();  // every thread is done with this stage
        if (t == 0 && p_unit < units) issue(stage);
        if (++stage == STAGES) {
          stage = 0;
          parity ^= 1u;
        }
      }
    }

    // the unit's sums: warps holding several pixels of a pack first add
    // their lanes in a fixed butterfly, then rows of red in order
    const bool shuffle = P <= 32 && 32 % P == 0;
    if (shuffle) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        for (int off = 16; off >= P; off >>= 1) {
          sum_l[0][w] += __shfl_xor_sync(0xffffffffu, sum_l[0][w], off);
          sum_t[0][w] += __shfl_xor_sync(0xffffffffu, sum_t[0][w], off);
        }
    }
    const int rows = shuffle ? NT / 32 : lanes;
    const int row = shuffle ? t / 32 : lane;
    if (shuffle ? t % 32 < P : active) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (pack + k * NT < P)
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int ch = (pack + k * NT) * W + w;
            red[row * 2 * CS + ch] = sum_l[k][w];
            red[row * 2 * CS + CS + ch] = sum_t[k][w];
          }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int w = 0; w < W; ++w) sum_l[k][w] = sum_t[k][w] = 0.f;
    __syncthreads();
    for (int j = t; j < 2 * CS; j += NT) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += red[r * 2 * CS + j];
      const int col = j < CS ? c0 + j : C + c0 + j - CS;
      p.part[(size_t)col * U + sl] = s;
    }
    __syncthreads();  // red is read before the next unit writes it
  }

  // every unit's partials written: rl lanes of a warp add a column's, rl
  // the least power of two >= U up to 32, in a fixed order and tree
  cg::this_grid().sync();
  int rl = 1;
  while (rl < U && rl < 32) rl *= 2;
  const int per_warp = 32 / rl;
  const int l32 = t % 32;
  const int warps = gridDim.x * (NT / 32);
  for (int j0 = (blockIdx.x * (NT / 32) + t / 32) * per_warp; j0 < 2 * C;
       j0 += warps * per_warp) {
    const int j = j0 + l32 / rl;
    float s = 0.f;
    if (j < 2 * C)
      for (int r = l32 % rl; r < U; r += rl)
        s += __ldcg(p.part + (size_t)j * U + r);
    for (int off = rl / 2; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (j < 2 * C && l32 % rl == 0) p.g_lt[j] = s;
  }
}

// a cooperative launch of one instantiation on the current device, its
// grid the co-resident blocks (cached per device) or the units
template <int S, bool HARD, class T, int W, bool RING_PATH>
cudaError_t launch(const Params<T>& p, cudaStream_t st) {
  static std::atomic<int> capacity[MAX_DEVICES];
  const void* kernel =
      reinterpret_cast<const void*>(lif_bwd_kernel<S, HARD, T, W, RING_PATH>);
  const int smem = RING_PATH ? STAGES * MAPS * CHUNK_BYTES : 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int cap = capacity[dev].load();
  if (cap == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                          smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap = per_sm * sms;
    capacity[dev].store(cap);
  }
  const int units = p.slices * p.segments;
  const int grid = units < cap ? units : cap;
  void* args[] = {const_cast<Params<T>*>(&p)};
  return cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(NT), args, smem,
                                     st);
}

// the aligned path stages whole float32 rows in the ring, and loads
// segments of rows and bfloat16 rows as vectors
template <int S, bool HARD, class T>
cudaError_t launch_path(bool vec, const Params<T>& p, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (!vec) return launch<S, HARD, T, 1, false>(p, st);
  if constexpr (sizeof(T) == 4) {
    if (p.segments == 1) return launch<S, HARD, T, V, true>(p, st);
  }
  return launch<S, HARD, T, V, false>(p, st);
}

template <int S, class T>
cudaError_t launch_s(bool hard, bool vec, const Params<T>& p,
                     cudaStream_t st) {
  return hard ? launch_path<S, true, T>(vec, p, st)
              : launch_path<S, false, T>(vec, p, st);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <class T>
int fused_lif_bwd(const T* v, const T* z, const T* v_out, const float* leak,
                  const float* thresh, const T* g_v, const T* g_z, T* g_cur,
                  T* g_vin, float* part, float* g_lt, long long npix, int C,
                  int hard_reset, int surrogate, float width, int vec,
                  void* stream) {
  if (C < 1 || C > MAX_C || npix < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((C * sizeof(T)) % 16 != 0 || !aligned16(v) || !aligned16(z) ||
              !aligned16(v_out) || !aligned16(g_v) || !aligned16(g_z) ||
              !aligned16(g_cur) || !aligned16(g_vin)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geometry g = geometry(npix, C, (int)sizeof(T));
  const Params<T> p{{v, z, v_out, g_v, g_z}, leak, thresh, g_cur, g_vin,
                    part, g_lt, npix, g.nchunks, C, g.segments, g.chunk_pix,
                    g.slices, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool hard = hard_reset != 0;
  cudaError_t err;
  switch (surrogate) {
    case kArctan:
      err = launch_s<kArctan, T>(hard, vec != 0, p, st);
      break;
    case kSuper:
      err = launch_s<kSuper, T>(hard, vec != 0, p, st);
      break;
    case kTriangle:
      err = launch_s<kTriangle, T>(hard, vec != 0, p, st);
      break;
    case kMG:
      err = launch_s<kMG, T>(hard, vec != 0, p, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Slices of the per-channel partial sums, so that the caller can allocate
// the [2*C, slices] float32 scratch; elem_bytes is the maps' element size
// (4 float32, 2 bfloat16). 0 unless C is in [1, MAX_C] and npix >= 1.
int evf_fused_lif_bwd_slices(long long npix, int C, int elem_bytes) {
  if (C < 1 || C > MAX_C || npix < 1 || (elem_bytes != 4 && elem_bytes != 2))
    return 0;
  return geometry(npix, C, elem_bytes).slices;
}

// (g_cur, g_vin) [npix, C] and g_lt [2*C] = (g_leak, g_thresh) from the
// saved v, z, v_out and the cotangents g_v, g_z, all [npix, C] float32;
// leak and thresh [C] post-squash. surrogate: 0 arctanspike, 1 superspike,
// 2 trianglespike, 3 mgspike. part is the caller's
// [2*C, evf_fused_lif_bwd_slices(npix, C, 4)] scratch. vec: every map's
// address and C * 4 are multiples of 16 bytes (the vector path; 0 takes
// the scalar one). One cooperative launch on stream; returns its error,
// or the first cudaGetLastError() after it.
int evf_fused_lif_bwd(const float* v, const float* z, const float* v_out,
                      const float* leak, const float* thresh,
                      const float* g_v, const float* g_z, float* g_cur,
                      float* g_vin, float* part, float* g_lt, long long npix,
                      int C, int hard_reset, int surrogate, float width,
                      int vec, void* stream) {
  return fused_lif_bwd<float>(v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                              g_vin, part, g_lt, npix, C, hard_reset,
                              surrogate, width, vec, stream);
}

// The same with the maps v, z, v_out, g_v, g_z, g_cur and g_vin bfloat16
// (vec: C * 2 a multiple of 16); leak, thresh, part and g_lt float32.
int evf_fused_lif_bwd_bf16(const bf16* v, const bf16* z, const bf16* v_out,
                           const float* leak, const float* thresh,
                           const bf16* g_v, const bf16* g_z, bf16* g_cur,
                           bf16* g_vin, float* part, float* g_lt,
                           long long npix, int C, int hard_reset,
                           int surrogate, float width, int vec,
                           void* stream) {
  return fused_lif_bwd<bf16>(v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                             g_vin, part, g_lt, npix, C, hard_reset,
                             surrogate, width, vec, stream);
}

}  // extern "C"
