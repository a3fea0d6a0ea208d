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
// The Pallas kernel carries the two per-channel sums in its output block
// across the sequential grid. Here each block owns a chunk of pixels and
// writes its per-channel sums into a [blocks, 2C] scratch, in a fixed
// order; a second launch adds the chunks in a fixed order and a fixed
// tree. No float atomics: the sums are bitwise the same from run to run.
// Up to 256 channels, thread t handles channel t % C for pixels t / C,
// t / C + 256 / C, ..., so the loads of a warp are contiguous, keeps its
// two sums in registers, and the block adds the 256 / C per-thread sums
// of each channel in a fixed order. Above 256 channels (the U-Net's 512-
// channel cells), a block owns WIDE_PIX pixels and thread t handles the
// channels t, t + 256, ... of each of them in turn, one sum per channel
// in registers, so no block reduction is needed. At most MAX_C channels.
//
// What bounds it: it reads five maps and writes two, about 118 MB at the
// training recipe (8 x 128 x 128 x 32), for some 30 FLOP per element, so
// it is bound by device memory (about 35 us at 3.35 TB/s; in bfloat16
// half the bytes, 18 us). The design reads each map once, coalesced, with
// enough blocks in flight to cover the latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;
constexpr int ITERS = 16;    // pixels per thread per block, C <= NT
constexpr int WIDE_PIX = 4;  // pixels per block, C > NT
constexpr int MAX_C = 2048;
constexpr int WIDE_K = MAX_C / NT;  // channels per thread, C > NT

enum Surrogate { kArctan = 0, kSuper = 1, kTriangle = 2, kMG = 3 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float a) { return a; }
__device__ __forceinline__ float widen(bf16 a) { return __bfloat162float(a); }
__device__ __forceinline__ void put(float* p, float a) { *p = a; }
__device__ __forceinline__ void put(bf16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

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

// One element of the backward: writes g_cur and g_vin at e and adds its
// leak and threshold terms to sum_l and sum_t.
template <int S, bool HARD, class T>
__device__ __forceinline__ void lif_bwd_elem(
    size_t e, float l, float th, float one_m_l, float div, float width,
    const T* __restrict__ v, const T* __restrict__ z,
    const T* __restrict__ v_out, const T* __restrict__ g_v,
    const T* __restrict__ g_z, T* __restrict__ g_cur,
    T* __restrict__ g_vin, float& sum_l, float& sum_t) {
  const float vv = widen(v[e]);
  const float zz = widen(z[e]);
  const float vo = widen(v_out[e]);
  const float gz = widen(g_z[e]);
  const float sg = surrogate<S>(vo - th, width);
  const float vbar = widen(g_v[e]) + gz * sg;
  float tbar = -gz * sg;
  float lbar;
  if constexpr (HARD) {
    const float cur_scaled = vo - vv * l * (1.f - zz);
    put(g_vin + e, vbar * l * (1.f - zz));
    lbar = vbar * (vv * (1.f - zz) - cur_scaled / div);
  } else {
    const float cur_scaled = vo - vv * l + zz * th;
    put(g_vin + e, vbar * l);
    lbar = vbar * (vv - cur_scaled / div);
    tbar = tbar - vbar * zz;
  }
  put(g_cur + e, vbar * one_m_l);
  sum_l += lbar;
  sum_t += tbar;
}

// C <= NT
template <int S, bool HARD, class T>
__global__ void __launch_bounds__(NT) lif_bwd_kernel(
    const T* __restrict__ v, const T* __restrict__ z,
    const T* __restrict__ v_out, const float* __restrict__ leak,
    const float* __restrict__ thresh, const T* __restrict__ g_v,
    const T* __restrict__ g_z, T* __restrict__ g_cur,
    T* __restrict__ g_vin, float* __restrict__ part, long long npix,
    int C, float width) {
  __shared__ float red_l[NT];
  __shared__ float red_t[NT];
  const int tid = threadIdx.x;
  const int lanes = NT / C;  // pixels handled side by side
  const int c = tid % C;
  const int lane = tid / C;
  float sum_l = 0.f, sum_t = 0.f;
  if (lane < lanes) {
    const float l = leak[c];
    const float th = thresh[c];
    const float one_m_l = 1.f - l;
    const float div = fmaxf(one_m_l, 1e-6f);
    const long long p0 = (long long)blockIdx.x * lanes * ITERS + lane;
    for (int k = 0; k < ITERS; ++k) {
      const long long p = p0 + (long long)k * lanes;
      if (p >= npix) break;
      lif_bwd_elem<S, HARD, T>((size_t)p * C + c, l, th, one_m_l, div, width, v,
                            z, v_out, g_v, g_z, g_cur, g_vin, sum_l, sum_t);
    }
  }
  red_l[tid] = sum_l;
  red_t[tid] = sum_t;
  __syncthreads();
  if (tid < C) {
    float bl = 0.f, bt = 0.f;
    for (int j = 0; j < lanes; ++j) {
      bl += red_l[j * C + tid];
      bt += red_t[j * C + tid];
    }
    part[(size_t)blockIdx.x * 2 * C + tid] = bl;
    part[(size_t)blockIdx.x * 2 * C + C + tid] = bt;
  }
}

// NT < C <= MAX_C
template <int S, bool HARD, class T>
__global__ void __launch_bounds__(NT) lif_bwd_wide_kernel(
    const T* __restrict__ v, const T* __restrict__ z,
    const T* __restrict__ v_out, const float* __restrict__ leak,
    const float* __restrict__ thresh, const T* __restrict__ g_v,
    const T* __restrict__ g_z, T* __restrict__ g_cur,
    T* __restrict__ g_vin, float* __restrict__ part, long long npix,
    int C, float width) {
  float sum_l[WIDE_K], sum_t[WIDE_K];
#pragma unroll
  for (int k = 0; k < WIDE_K; ++k) sum_l[k] = sum_t[k] = 0.f;
  const long long p0 = (long long)blockIdx.x * WIDE_PIX;
  for (int i = 0; i < WIDE_PIX; ++i) {
    const long long p = p0 + i;
    if (p >= npix) break;
#pragma unroll
    for (int k = 0; k < WIDE_K; ++k) {
      const int c = threadIdx.x + k * NT;
      if (c < C) {
        const float l = leak[c];
        const float one_m_l = 1.f - l;
        lif_bwd_elem<S, HARD, T>((size_t)p * C + c, l, thresh[c], one_m_l,
                              fmaxf(one_m_l, 1e-6f), width, v, z, v_out, g_v,
                              g_z, g_cur, g_vin, sum_l[k], sum_t[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < WIDE_K; ++k) {
    const int c = threadIdx.x + k * NT;
    if (c < C) {
      part[(size_t)blockIdx.x * 2 * C + c] = sum_l[k];
      part[(size_t)blockIdx.x * 2 * C + C + c] = sum_t[k];
    }
  }
}

// out[j] = sum over blocks of part[block, j] for j < 2C (g_leak then
// g_thresh): one block per j; thread i sums blocks i, i + 256, ..., then a
// fixed shared-memory tree.
__global__ void __launch_bounds__(NT)
    block_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int blocks, int n) {
  __shared__ float red[NT];
  const int j = blockIdx.x;
  float sum = 0.f;
  for (int b = threadIdx.x; b < blocks; b += NT) sum += part[(size_t)b * n + j];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int half = NT / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = red[0];
}

template <int S, bool HARD, class T>
void launch(const T* v, const T* z, const T* v_out, const float* leak,
            const float* thresh, const T* g_v, const T* g_z, T* g_cur,
            T* g_vin, float* part, long long npix, int C, float width,
            int blocks, cudaStream_t st) {
  if (C <= NT)
    lif_bwd_kernel<S, HARD, T><<<blocks, NT, 0, st>>>(
        v, z, v_out, leak, thresh, g_v, g_z, g_cur, g_vin, part, npix, C,
        width);
  else
    lif_bwd_wide_kernel<S, HARD, T><<<blocks, NT, 0, st>>>(
        v, z, v_out, leak, thresh, g_v, g_z, g_cur, g_vin, part, npix, C,
        width);
}

template <int S, class T>
void launch_s(bool hard, const T* v, const T* z, const T* v_out,
              const float* leak, const float* thresh, const T* g_v,
              const T* g_z, T* g_cur, T* g_vin, float* part, long long npix,
              int C, float width, int blocks, cudaStream_t st) {
  if (hard)
    launch<S, true, T>(v, z, v_out, leak, thresh, g_v, g_z, g_cur, g_vin,
                       part, npix, C, width, blocks, st);
  else
    launch<S, false, T>(v, z, v_out, leak, thresh, g_v, g_z, g_cur, g_vin,
                        part, npix, C, width, blocks, st);
}

int blocks_for(long long npix, int C) {
  if (C < 1 || C > MAX_C) return 0;
  const long long per_block = C <= NT ? (long long)(NT / C) * ITERS : WIDE_PIX;
  return (int)((npix + per_block - 1) / per_block);
}

template <class T>
int fused_lif_bwd(const T* v, const T* z, const T* v_out, const float* leak,
                  const float* thresh, const T* g_v, const T* g_z, T* g_cur,
                  T* g_vin, float* part, float* g_lt, long long npix, int C,
                  int hard_reset, int surrogate, float width, void* stream) {
  if (C < 1 || C > MAX_C || npix < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool hard = hard_reset != 0;
  const int blocks = blocks_for(npix, C);
  switch (surrogate) {
    case kArctan:
      launch_s<kArctan, T>(hard, v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                           g_vin, part, npix, C, width, blocks, st);
      break;
    case kSuper:
      launch_s<kSuper, T>(hard, v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                          g_vin, part, npix, C, width, blocks, st);
      break;
    case kTriangle:
      launch_s<kTriangle, T>(hard, v, z, v_out, leak, thresh, g_v, g_z,
                             g_cur, g_vin, part, npix, C, width, blocks, st);
      break;
    case kMG:
      launch_s<kMG, T>(hard, v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                       g_vin, part, npix, C, width, blocks, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_sum_kernel<<<2 * C, NT, 0, st>>>(part, g_lt, blocks, 2 * C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of blocks of the first launch, so that the caller can allocate
// the [blocks, 2*C] scratch; 0 unless C is in [1, MAX_C].
int evf_fused_lif_bwd_blocks(long long npix, int C) {
  return blocks_for(npix, C);
}

// (g_cur, g_vin) [npix, C] and g_lt [2*C] = (g_leak, g_thresh) from the
// saved v, z, v_out and the cotangents g_v, g_z, all [npix, C] float32;
// leak and thresh [C] post-squash. surrogate: 0 arctanspike, 1 superspike,
// 2 trianglespike, 3 mgspike. part is the caller's
// [evf_fused_lif_bwd_blocks(npix, C), 2*C] scratch. Returns the first
// cudaGetLastError() after the two launches.
int evf_fused_lif_bwd(const float* v, const float* z, const float* v_out,
                      const float* leak, const float* thresh,
                      const float* g_v, const float* g_z, float* g_cur,
                      float* g_vin, float* part, float* g_lt, long long npix,
                      int C, int hard_reset, int surrogate, float width,
                      void* stream) {
  return fused_lif_bwd<float>(v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                              g_vin, part, g_lt, npix, C, hard_reset,
                              surrogate, width, stream);
}

// The same with the maps v, z, v_out, g_v, g_z, g_cur and g_vin bfloat16;
// leak, thresh, part and g_lt float32.
int evf_fused_lif_bwd_bf16(const bf16* v, const bf16* z, const bf16* v_out,
                           const float* leak, const float* thresh,
                           const bf16* g_v, const bf16* g_z, bf16* g_cur,
                           bf16* g_vin, float* part, float* g_lt,
                           long long npix, int C, int hard_reset,
                           int surrogate, float width, void* stream) {
  return fused_lif_bwd<bf16>(v, z, v_out, leak, thresh, g_v, g_z, g_cur,
                             g_vin, part, g_lt, npix, C, hard_reset,
                             surrogate, width, stream);
}

}  // extern "C"
