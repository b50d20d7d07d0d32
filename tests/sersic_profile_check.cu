// The profile's own logarithm and division (csrc/sersic_profile.cuh:
// log_clamped, div_clamped) against logf and __fdiv_rn, on the card.
// Built and called by tests/test_torch_cuda.py (nvcc -I <csrc>, ctypes).

#include <cuda_runtime.h>

#include "sersic_profile.cuh"

namespace {

__device__ bool same(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y) || (x != x && y != y);
}

// Every bit pattern lo..hi (inclusive) as the logarithm's argument.
__global__ void log_check(unsigned lo, unsigned hi, unsigned long long* bad) {
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long b = lo + (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       b <= hi; b += step) {
    const float a = __uint_as_float((unsigned)b);
    if (!same(psfmc::log_clamped(a), logf(a))) atomicAdd(bad, 1ull);
  }
}

__device__ unsigned mix(unsigned long long x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ull;
  return (unsigned)(x ^ (x >> 33));
}

// `pairs` pseudo-random operands: n any non-negative float up to +inf (by
// bit pattern, so every exponent is as likely), d = 3 * sq_off with sq_off
// in [0.125, 1e9] (likewise).  out[0]: finite quotients of n >= 2^-100
// that differ in any bit; out[1]: 1 + n / d differs where the quotient is
// finite; out[2]: an overflowed quotient that came out finite.
__global__ void div_check(unsigned long long pairs, unsigned long long* out) {
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  const unsigned lo = __float_as_uint(0.125f), hi = __float_as_uint(1e9f);
  for (unsigned long long k = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < pairs; k += step) {
    const float n = __uint_as_float(mix(2 * k) % 0x7f800001u);
    const float d = __fmul_rn(3.0f, __uint_as_float(lo + mix(2 * k + 1) % (hi - lo + 1)));
    const float got = psfmc::div_clamped(n, d), want = __fdiv_rn(n, d);
    if (n >= 0x1p-100f && want < __int_as_float(0x7f800000) && !same(got, want))
      atomicAdd(out, 1ull);
    if (want < __int_as_float(0x7f800000)) {
      if (!same(__fadd_rn(1.0f, got), __fadd_rn(1.0f, want))) atomicAdd(out + 1, 1ull);
    } else if (got < __int_as_float(0x7f800000)) {
      atomicAdd(out + 2, 1ull);
    }
  }
}

}  // namespace

// counts: 4 unsigned 64-bit integers on the host: [0] the logarithm's
// mismatches over the bit patterns log_lo..log_hi, [1..3] div_check's.
// Returns the last CUDA error (0: none).
extern "C" int sersic_profile_check(unsigned log_lo, unsigned log_hi,
                                    unsigned long long pairs,
                                    unsigned long long* counts) {
  unsigned long long* dev = nullptr;
  if (cudaMalloc(&dev, 4 * sizeof(*dev)) != cudaSuccess) return (int)cudaGetLastError();
  cudaMemset(dev, 0, 4 * sizeof(*dev));
  log_check<<<1056, 256>>>(log_lo, log_hi, dev);
  div_check<<<1056, 256>>>(pairs, dev + 1);
  cudaMemcpy(counts, dev, 4 * sizeof(*dev), cudaMemcpyDeviceToHost);
  cudaFree(dev);
  return (int)cudaGetLastError();
}
