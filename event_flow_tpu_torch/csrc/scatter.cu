// Batched channelled scatter-add (K3) for sm_90a, bitwise repeatable.
//
// Replaces event_flow_tpu/ops/scatter_pallas.py::scatter_add_pallas, which
// keeps the whole [size, C] image in TPU VMEM and walks the events in a
// serial loop, so its sums come out the same on every run. Blocks on the
// H100 run in no order, and float atomics would add in a different order
// on every run. So the sum is taken in fixed point, where addition is
// associative and the order does not matter:
//
//   1. amax = max |vals| over the call (atomicMax on the bit patterns of
//      non-negative floats, which order like the floats);
//   2. every value is rounded to a multiple of 2^-s, s = 62 - e with
//      M * amax < 2^e, and added with a 64-bit integer atomicAdd into a
//      zeroed [B, size, C] int64 accumulator: a cell sums at most M
//      values of at most amax, so no sum can overflow;
//   3. each cell is converted back to float once.
//
// The rounding step 2^-s is about 2^-61 * M * amax, some 1e-14 of the
// largest value at the training shapes, far below float's own rounding;
// counts and any other sum of small integers stay exact. Sorting the keys
// and reducing segments in event order would also be repeatable, but
// needs a device-wide sort per call; the fixed-point route keeps one pass
// over the events and the L2-resident atomics of the float version.
// A non-finite value makes amax non-finite, and then every cell of the
// output is NaN (the float sum would have spread it only to its cell).
//
// What bounds it: the training loss scatters 8 x 10 000 events x 16
// channels into 130 x 130 cells, the encoding 80 x 1000 x 4 into 128 x
// 128; all of it is resident in the 50 MB L2, so launch overhead and
// atomic contention on cells that many events hit bound it, not device
// memory. Zero values are skipped: padded and out-of-bounds events carry
// zero weight and clamp onto a few cells. Indices outside [0, size) are
// skipped, so a bad index cannot write out of bounds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr long long kMaxBlocks = 65535;

// The bit patterns of non-negative floats order like the floats, and a
// NaN's (0x7fc00000 after fabsf) lies above infinity's, so the maximum is
// taken on the patterns.
__global__ void __launch_bounds__(NT)
    abs_max_kernel(const float* __restrict__ vals, long long total,
                   unsigned int* __restrict__ amax_bits) {
  unsigned int m = 0u;
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += stride)
    m = max(m, __float_as_uint(fabsf(vals[i])));
  for (int o = 16; o > 0; o /= 2)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) atomicMax(amax_bits, m);
}

// The fixed-point exponent s of this call; false when every value is 0 or
// some value is not finite.
__device__ __forceinline__ bool fixed_scale(const unsigned int* amax_bits,
                                            int M, int* s) {
  const float amax = __uint_as_float(*amax_bits);
  if (amax == 0.f || !isfinite(amax)) return false;
  int e;
  frexp((double)amax * (double)M, &e);  // M * amax < 2^e
  *s = 62 - e;
  return true;
}

__global__ void __launch_bounds__(NT)
    scatter_fixed_kernel(const int* __restrict__ idx,
                         const float* __restrict__ vals,
                         unsigned long long* __restrict__ acc, int M, int C,
                         int size, long long total,
                         const unsigned int* __restrict__ amax_bits) {
  int s;
  if (!fixed_scale(amax_bits, M, &s)) return;
  const double scale = ldexp(1.0, s);
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += stride) {
    const long long bm = i / C;  // flat (batch, event)
    const int c = (int)(i - bm * C);
    const int b = (int)(bm / M);
    const int cell = idx[bm];
    const float v = vals[i];
    if (cell < 0 || cell >= size || v == 0.f) continue;
    const long long q = llrint((double)v * scale);
    if (q != 0)
      atomicAdd(acc + ((long long)b * size + cell) * C + c,
                (unsigned long long)q);
  }
}

__global__ void __launch_bounds__(NT)
    fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                          float* __restrict__ out, long long n, int M,
                          const unsigned int* __restrict__ amax_bits) {
  int s = 0;
  const bool scaled = fixed_scale(amax_bits, M, &s);
  const float fill = isfinite(__uint_as_float(*amax_bits))
                         ? 0.f : __int_as_float(0x7fc00000);
  const double inv = ldexp(1.0, -s);
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    out[i] = scaled ? (float)((double)(long long)acc[i] * inv) : fill;
}

inline unsigned grid_for(long long n) {
  long long blocks = (n + NT - 1) / NT;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" {

// out [B, size, C] = sum of vals [B, M, C] at idx [B, M]. acc is the
// caller's zeroed int64 [B, size, C] scratch and amax its zeroed uint32
// scalar. Returns the first cudaGetLastError() after the three launches.
int evf_scatter_add(const int* idx, const float* vals,
                    unsigned long long* acc, unsigned int* amax, float* out,
                    int B, int M, int C, int size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * M * C;
  const long long n = (long long)B * size * C;
  if (total == 0 || n == 0) return static_cast<int>(cudaSuccess);
  abs_max_kernel<<<grid_for(total), NT, 0, st>>>(vals, total, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_fixed_kernel<<<grid_for(total), NT, 0, st>>>(idx, vals, acc, M, C,
                                                       size, total, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_to_float_kernel<<<grid_for(n), NT, 0, st>>>(acc, out, n, M, amax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
