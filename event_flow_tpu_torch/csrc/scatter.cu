// Batched channelled scatter-add (K3) for sm_90a, bitwise repeatable, in
// one launch.
//
// Replaces event_flow_tpu/ops/scatter_pallas.py::scatter_add_pallas, which
// keeps the whole [size, C] image in TPU VMEM and walks the events in a
// serial loop, so its sums come out the same on every run. Blocks on the
// H100 run in no order, and float atomics would add in a different order
// on every run. So the sum is taken in fixed point, where addition is
// associative and the order does not matter.
//
// Design: the grid is (tiles per row, B). A block owns the cells
// [lo, hi) of one batch row and all C channels of those cells, and keeps
// their int64 sums in shared memory:
//
//   1. scan the row's indices (16-byte loads, L2-resident) and list the
//      events that fall in [lo, hi) in shared memory;
//   2. max |v| over the listed events' values and their number n, reduced
//      in the block: the tile's fixed-point exponent is s = 62 - e with
//      n * max|v| < 2^e, so no cell of the tile can overflow. s depends
//      only on the set of values in the tile, never on their order, and is
//      at least as fine as one exponent taken over the whole call;
//   3. add q = llrint(v * 2^s) of each nonzero value into the shared
//      int64 cells, one event's C channels on C consecutive threads. sm_90
//      has no native 64-bit shared-memory atomic add (the compiler emits a
//      compare-and-swap loop, ATOMS.CAST.SPIN.64, which spins on hot
//      cells), so each cell is a (lo, hi) pair of 32-bit words added with
//      native ATOMS.ADD: lo += low word of q, and hi += high word of q
//      plus the carry out of lo, which the add that wraps lo sees in the
//      old value it returns. The pair, lo first (little-endian), then
//      reads back as the int64 sum, exactly;
//   4. convert each cell once and write it, coalesced. Every output cell
//      is written by the block that owns it: no zero fill, no int64 image
//      in device memory, no second launch.
//
// The rounding step 2^-s is about 2^-61 * n * max|v|, some 1e-14 of the
// tile's largest value, far below float's own rounding; counts and any
// other sum of small integers stay exact. When a tile has more events than
// the shared list holds (CAP, a hot tile), steps 2 and 3 scan the row
// again in chunks of CHUNK events instead; the sums are the same integers.
//
// Non-finite values: a NaN or infinite value makes its tile's max |v|
// non-finite, and then every cell of that tile (and only of that tile) is
// NaN. Indices outside [0, size) fall in no tile and are skipped; zero
// values add nothing.
//
// What bounds it: the training loss scatters 8 x 10 000 events x 16
// channels into 130 x 130 cells: 5.1 MB of values and 0.3 MB of int32
// indices read, 8.65 MB written, 4.2 us at 3.35 TB/s. The tiles are sized
// so that every SM gets a block and each tile fits shared memory, and
// every block reads its row's indices (40 KB, from L2). On the H100, with
// uniform indices and 33 tiles per row, a call there took about 1.7 us to
// start and zero, 3.6 to scan, 2.3 and 3.0 for steps 2 and 3 and 1.8 to
// write: the phases of all blocks run in step, and the scan is the
// largest. A hot tile (many events on few cells) lengthens its block's
// steps 2 and 3, and the call waits for that block (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;  // threads per block; C <= NT
constexpr int WARPS = NT / 32;
constexpr int VISIT = 4;  // listed events per thread whose loads fly at once
constexpr int CHUNK = 4 * NT;  // events per scan step: one int4 a thread
constexpr int UNROLL = 4;      // scan steps whose loads are in flight at once
constexpr int CAP = 4096;  // events the shared list holds (32 KB)
static_assert(CAP >= CHUNK, "a chunk's events must fit the list");
// int64 cells a block may hold, so that two blocks fit on an SM beside
// their lists
constexpr int kAccBytesMax = 72 * 1024;
// tiles per row: at least one block per SM (two: 0.0203 against
// 0.0162-0.0177 ms at the loss shape on the H100, the same elsewhere)
constexpr int kBlocksPerSM = 1;

enum TileKind { kZero = 0, kFinite = 1, kNonFinite = 2 };

struct TileShared {
  int ev[CAP];    // listed events, index within the row
  int cell[CAP];  // their cell, relative to lo
  int count;      // events of the tile found by the current scan
  unsigned int red[WARPS];
  int kind;
  int shift;
};

__device__ __forceinline__ int4 load_idx4(const int* __restrict__ row, int m,
                                          int m_end, bool vec) {
  if (vec && m + 3 < m_end)
    return __ldg(reinterpret_cast<const int4*>(row + m));
  int4 r;
  r.x = m < m_end ? __ldg(row + m) : -1;
  r.y = m + 1 < m_end ? __ldg(row + m + 1) : -1;
  r.z = m + 2 < m_end ? __ldg(row + m + 2) : -1;
  r.w = m + 3 < m_end ? __ldg(row + m + 3) : -1;
  return r;
}

// Lists the events m in [m_begin, m_end) with lo <= row[m] < hi at
// sh.ev / sh.cell from sh.count on (as far as CAP) and adds their number
// to sh.count. Every thread of the block calls it; the list order is
// arbitrary, and nothing that reads it depends on the order.
__device__ __forceinline__ void scan_events(const int* __restrict__ row,
                                            int m_begin, int m_end, int lo,
                                            int hi, bool vec, TileShared& sh) {
  const int lane = threadIdx.x % 32;
  for (int base = m_begin; base < m_end; base += UNROLL * CHUNK) {
    int4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      q[u] = load_idx4(row, base + u * CHUNK + 4 * threadIdx.x, m_end, vec);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = base + u * CHUNK + 4 * threadIdx.x;
      const int c[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      int n = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) n += (c[k] >= lo && c[k] < hi);
      if (!__any_sync(0xffffffffu, n > 0)) continue;
      int incl = n;  // inclusive prefix over the warp
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int at = 0;
      if (lane == 31) at = atomicAdd(&sh.count, incl);
      at = __shfl_sync(0xffffffffu, at, 31) + incl - n;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c[k] >= lo && c[k] < hi) {
          if (at < CAP) {
            sh.ev[at] = m + k;
            sh.cell[at] = c[k] - lo;
          }
          ++at;
        }
      }
    }
  }
}

// For the n listed events: with ADD false the max of |v| as bit patterns
// (non-negative floats order like their patterns; a NaN's lies above
// infinity's), with ADD true the fixed-point adds into acc. An event's C
// channels go to C / V consecutive threads, V channels each (one 16-byte
// load when V is 4): thread t takes channels V (t % (C / V)) + [0, V) of
// the events t / (C / V), + NT / (C / V), ..., VISIT of them at a time,
// their loads issued together, then their atomics. The V adds of a thread
// start at a channel rotated by its event's place in the warp, so that the
// lanes' words fall in different banks.
template <bool ADD, int V>
__device__ __forceinline__ unsigned int visit_events(
    const float* __restrict__ vals_row, int n, int C, double scale,
    const TileShared& sh, unsigned long long* acc) {
  unsigned int m = 0u;
  const int per_event = C / V;  // threads per event
  const int lanes = NT / per_event;  // events side by side
  const int j0 = (int)threadIdx.x / per_event;
  const int c0 = V * ((int)threadIdx.x % per_event);
  const int rot = j0 % V;
  if (j0 >= lanes) return m;
  for (int j = j0; j < n; j += VISIT * lanes) {
    float v[VISIT][V];
    int cell[VISIT];
#pragma unroll
    for (int u = 0; u < VISIT; ++u) {
      const int jj = j + u * lanes;
      cell[u] = jj < n ? sh.cell[jj] : 0;
      const float* src = vals_row + (size_t)(jj < n ? sh.ev[jj] : 0) * C + c0;
      if constexpr (V == 4) {
        const float4 x = jj < n ? __ldg(reinterpret_cast<const float4*>(src))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u][0] = x.x;
        v[u][1] = x.y;
        v[u][2] = x.z;
        v[u][3] = x.w;
      } else {
        v[u][0] = jj < n ? __ldg(src) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < VISIT; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int r = (k + rot) % V;
        float x = v[u][0];  // v[u][r], without indexing registers at run time
#pragma unroll
        for (int i = 1; i < V; ++i) x = r == i ? v[u][i] : x;
        if constexpr (ADD) {
          if (x != 0.f) {
            const unsigned long long q = llrint((double)x * scale);
            unsigned int* w = reinterpret_cast<unsigned int*>(
                acc + (size_t)cell[u] * C + c0 + r);
            const unsigned int q_lo = (unsigned int)q;
            const unsigned int old = atomicAdd(w, q_lo);
            const unsigned int q_hi =
                (unsigned int)(q >> 32) + (old + q_lo < old);  // carry
            if (q_hi != 0u) atomicAdd(w + 1, q_hi);
          }
        } else {
          m = max(m, __float_as_uint(fabsf(x)));
        }
      }
    }
  }
  return m;
}

// Steps 2 and 3 over the tile's events: from the list when it holds all
// of them, else by scanning the row again chunk by chunk.
template <bool ADD>
__device__ __forceinline__ unsigned int visit_tile(
    const int* __restrict__ row, const float* __restrict__ vals_row, int M,
    int C, int lo, int hi, bool vec, bool vec4, int hits, double scale,
    TileShared& sh, unsigned long long* acc) {
  const auto visit = [&](int n) {
    return vec4 ? visit_events<ADD, 4>(vals_row, n, C, scale, sh, acc)
                : visit_events<ADD, 1>(vals_row, n, C, scale, sh, acc);
  };
  if (hits <= CAP) return visit(hits);
  unsigned int m = 0u;
  for (int m0 = 0; m0 < M; m0 += CHUNK) {
    __syncthreads();
    if (threadIdx.x == 0) sh.count = 0;
    __syncthreads();
    scan_events(row, m0, min(m0 + CHUNK, M), lo, hi, vec, sh);
    __syncthreads();
    m = max(m, visit(sh.count));
  }
  return m;
}

__global__ void __launch_bounds__(NT)
    scatter_tile_kernel(const int* __restrict__ idx,
                        const float* __restrict__ vals,
                        float* __restrict__ out, int M, int C, int size,
                        int tile) {
  extern __shared__ unsigned long long acc[];  // [tile, C]
  __shared__ TileShared sh;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * tile;
  const int hi = min(lo + tile, size);
  const int ncell = (hi - lo) * C;
  const int* row = idx + (size_t)b * M;
  const float* vals_row = vals + (size_t)b * M * C;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  // 16-byte value loads from 8 channels on (on the H100, the loss's 16:
  // 0.0221 -> 0.0199 ms); at 4 a thread would take a whole event, whose
  // four adds in a row measured slower (0.0074 -> 0.0077-0.0082 ms)
  const bool vec4 = C % 4 == 0 && C >= 8 &&
                    (reinterpret_cast<uintptr_t>(vals_row) & 15) == 0;

  for (int i = threadIdx.x; i < ncell; i += NT) acc[i] = 0ull;
  if (threadIdx.x == 0) sh.count = 0;
  __syncthreads();

  // 1. list the tile's events; count them all, list as many as fit
  scan_events(row, 0, M, lo, hi, vec, sh);
  __syncthreads();
  const int hits = sh.count;

  // 2. max |v| over the tile's events
  unsigned int amax = visit_tile<false>(row, vals_row, M, C, lo, hi, vec,
                                        vec4, hits, 0.0, sh, acc);
  amax = __reduce_max_sync(0xffffffffu, amax);
  if (threadIdx.x % 32 == 0) sh.red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int bits = 0u;
    for (int w = 0; w < WARPS; ++w) bits = max(bits, sh.red[w]);
    const float a = __uint_as_float(bits);
    sh.kind = bits == 0u ? kZero : (isfinite(a) ? kFinite : kNonFinite);
    int e = 0;
    frexp((double)a * (double)hits, &e);  // hits * max|v| < 2^e
    sh.shift = 62 - e;
  }
  __syncthreads();
  const int kind = sh.kind;
  const int s = sh.shift;

  // 3. the fixed-point adds
  if (kind == kFinite)
    visit_tile<true>(row, vals_row, M, C, lo, hi, vec, vec4, hits,
                     ldexp(1.0, s), sh, acc);
  __syncthreads();

  // 4. every cell of the tile, once
  float* out_tile = out + ((size_t)b * size + lo) * C;
  const double inv = ldexp(1.0, -s);
  const float fill = kind == kZero ? 0.f : __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < ncell; i += NT)
    out_tile[i] = kind == kFinite ? (float)((double)(long long)acc[i] * inv)
                                  : fill;
}

// Cells per tile of the launch for (B, size, C) on the current device: as
// many tiles per row as kBlocksPerSM blocks per SM need, and at least as
// many as keep a tile's int64 cells within kAccBytesMax.
// Depends on the shape and the SM count only. Returns 0 unless
// 1 <= C <= NT.
int tile_cells(int B, int size, int C) {
  if (B < 1 || size < 1 || C < 1 || C > NT) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long max_cells = kAccBytesMax / (8LL * C);
  long long tiles = (size + max_cells - 1) / max_cells;
  const long long wave = ((long long)kBlocksPerSM * sms + B - 1) / B;
  if (wave > tiles) tiles = wave < size ? wave : size;
  return (int)((size + tiles - 1) / tiles);
}

}  // namespace

extern "C" {

// out [B, size, C] = sum of vals [B, M, C] at idx [B, M] (int32), every
// cell written. Returns the cudaGetLastError() after the launch.
int evf_scatter_add(const int* idx, const float* vals, float* out, int B,
                    int M, int C, int size, void* stream) {
  const int tile = tile_cells(B, size, C);
  if (tile < 1 || B > 65535 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)tile * C * sizeof(unsigned long long);
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kAccBytesMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  const dim3 grid((size + tile - 1) / tile, B);
  scatter_tile_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, vals, out, M, C, size, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
