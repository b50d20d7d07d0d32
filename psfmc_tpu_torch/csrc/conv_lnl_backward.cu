// The conv+likelihood backward: dlnL/draw of the batched convolution +
// masked Gaussian lnL, on both routes of the forward (Hopper, sm_90a).
//
// Backward of conv_lnl.cu, which replaces the JAX package's Pallas TPU
// kernel psfmc_tpu/ops/pallas/lnpost_batched.py::make_batched_conv_lnl.
// The JAX package differentiates the same likelihood by autodiff of its
// XLA path (jax.value_and_grad in psfmc_tpu/optimize.py); the port's
// forward is a hand-written kernel, so its backward is one too.
//
// What it computes, per walker b with conv = raw (*) psf, mvar = raw^2 (*)
// var, r = obs - conv, ivm = 1 / (mvar + obs_var) and the mask good:
//   a = good r ivm,  c = good (r^2 ivm^2 - ivm) / 2   (dlnL/dconv, dlnL/dmvar)
//   dlnL/draw = grad_b [a (x) psf + 2 raw (c (x) var)]
// where (x) is the adjoint of the forward's convolution (with its
// ifftshift): a circular correlation, the conjugate spectrum.  A walker
// whose forward lnL is not finite gets a zero gradient (the forward maps
// it to -inf, through which no gradient passes).
// psfmc_tpu_torch.ops.kernels.conv_lnl.batched_conv_lnl_backward_plain is
// the function in plain PyTorch.
//
// FFT route (conv_lnl_fft_backward_launch; H and W even with no prime
// factor above 5, the walker in one block's shared memory; fft_conv.cuh's
// power-of-two or mixed-radix geometry): one launch, one block of 512
// threads per walker, two FFT pairs of fft_conv.cuh in shared memory.
//  1. the forward pair again: z = raw + i s raw^2, FFT2, the Hermitian
//     split times (Kpsf, g Kvar), IFFT2: conv and s g mvar, unshifted;
//  2. a and c per pixel from the shifted readout, written back to the
//     slot they were read from, which is where the adjoint of the
//     readout's shift puts them; the power of two s' = 2^(e_a - e_c) from
//     the two parts' peaks gives both one scale (the forward's reason:
//     in a float32 complex image the smaller part is only as exact as the
//     larger part's rounding); the variance spectrum keeps the forward's
//     gain g for the same reason;
//  3. the second pair with the conjugate spectra (the wrapper passes
//     -Im K): FFT2, the split times (conj Kpsf, g conj Kvar), IFFT2 gives
//     a (x) psf + i s' g (c (x) var) in natural order;
//  4. the combine with the raw image, read again from global memory.
// psfmc_tpu_torch.ops.kernels.conv_lnl.packed_fft_conv_backward_plain is
// this scheme in plain PyTorch.
//
// matmul-DFT route (conv_lnl_dft_backward_launch; every other shape): the
// forward's products recompute conv and mvar (dft_conv.cuh, 14 launches),
// one elementwise kernel forms a and c in place, the same products with
// the transposed operators, in reverse order, and the conjugate spectra
// give the two adjoints (14 launches), and one elementwise kernel
// combines them: 30 launches through global scratch.
//
// What bounds it on the H100: arithmetic, twice the forward's FFT count
// (two complex FFT pairs per walker on the FFT route: about 4.6 MFLOP per
// walker at 128x128), against the image gradient's 65 KB out and the raw
// image's 65 KB in per walker.  As in the forward, the butterflies'
// instruction issue through shared memory sets the pace with one block
// of 16 warps on an SM.
//
// Numerics: true fp32, no --use_fast_math, no tensor cores; the divisions
// and logf are IEEE-accurate.  No atomics: every launch gives the same
// bits.

#include <cuda_runtime.h>
#include <math.h>

#include "dft_conv.cuh"
#include "fft_conv.cuh"

namespace {

namespace fc = psfmc::fftconv;

constexpr int kThreads = 256;

// The largest value over the block (every thread passes its own); ends in
// a barrier, so that what the threads wrote before is visible to all.
__device__ float block_max(float v, float* maxes) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // maxes may still be read by an earlier call
  if (lane == 0) maxes[warp] = v;
  __syncthreads();
  float m = maxes[0];
  for (int i = 1; i < fc::kWarps; ++i) m = fmaxf(m, maxes[i]);
  return m;
}

// The exponent of a block peak, 0 where the peak is 0 or not finite, and
// whether it was usable.
__device__ __forceinline__ int peak_exponent(float m, bool* usable) {
  *usable = m > 0.0f && isfinite(m);
  return *usable ? ilogbf(m) : 0;
}

template <class Geom>
__device__ void pair(float2* z, const Geom& g, const fc::Spectra& k) {
  g.template lines<false, true>(z);
  g.template lines<false, false>(z);
  g.pairs(z, k);
  __syncthreads();
  g.template lines<true, false>(z);
  g.template lines<true, true>(z);
}

// The walker's backward on one geometry, from the twiddles (and layout)
// already on their way into shared memory.
template <class Geom>
__device__ void backward_block(float2* z, const Geom& g, float* maxes,
                               const float* raw, const fc::Spectra& k,
                               const fc::Spectra& kc, const fc::Data& d,
                               float gb, float* o) {
  const int h = g.h, w = g.w, hw = h * w;

  // 1. the forward pair: conv + i s g mvar
  bool ok;
  int se = peak_exponent(block_max(fc::load_image(z, g, raw), maxes), &ok);
  se = max(-fc::kMaxScaleExp, min(fc::kMaxScaleExp, se));
  const float s = ldexpf(1.0f, -se);
  for (int p = threadIdx.x; p < hw; p += fc::kThreads) {
    float2* q = z + g.at(p);
    const float x = q->x;
    q->y = s * (x * x);
  }
  __syncthreads();
  pair(z, g, k);

  // 2. a and c, each written to the slot its pixel was read from
  const float conv_scale = 1.0f / (float)hw;
  const float gain = __ldg(k.var_gain);
  const float mvar_scale = ldexpf(conv_scale, se) / gain;
  float amax = 0.0f, cmax = 0.0f;
#pragma unroll 4
  for (int p = threadIdx.x; p < hw; p += fc::kThreads) {
    float2* q = z + g.shifted(p);
    const float2 c = *q;
    const float conv = c.x * conv_scale, mvar = c.y * mvar_scale;
    const float ivm = 1.0f / (mvar + __ldg(d.obs_var + p));
    const float r = __ldg(d.obs + p) - conv;
    const bool good = __ldg(d.good + p) > 0.0f;
    const float av = good ? r * ivm : 0.0f;
    const float cv = good ? 0.5f * (r * r * ivm * ivm - ivm) : 0.0f;
    *q = make_float2(av, cv);
    amax = fmaxf(amax, fabsf(av));
    cmax = fmaxf(cmax, fabsf(cv));
  }
  bool ok_a, ok_c;
  const int ea = peak_exponent(block_max(amax, maxes), &ok_a);
  const int ec = peak_exponent(block_max(cmax, maxes), &ok_c);
  int se2 = ok_a && ok_c ? ea - ec : 0;
  se2 = max(-fc::kMaxScaleExp, min(fc::kMaxScaleExp, se2));
  const float s2 = ldexpf(1.0f, se2);
  for (int p = threadIdx.x; p < hw; p += fc::kThreads) z[g.at(p)].y *= s2;
  __syncthreads();

  // 3. the conjugate pair: a (x) psf + i s' g (c (x) var), natural order
  pair(z, g, kc);

  // 4. grad_b [a (x) psf + 2 raw (c (x) var)]
  const float c_scale = ldexpf(conv_scale, -se2) / gain;
#pragma unroll 4
  for (int p = threadIdx.x; p < hw; p += fc::kThreads) {
    const float2 y = z[g.at(p)];
    const float ga = y.x * conv_scale, gc = y.y * c_scale;
    o[p] = gb * (ga + 2.0f * __ldg(raw + p) * gc);
  }
}

template <bool MIXED>
__global__ void __launch_bounds__(fc::kThreads, 1)
conv_lnl_fft_backward_kernel(const float* __restrict__ raws, int h, int w,
                             const float2* __restrict__ twiddle, int tw_log2,
                             const int* __restrict__ layout, fc::Spectra k,
                             fc::Spectra kc, fc::Data d,
                             const float* __restrict__ lnl,
                             const float* __restrict__ grad,
                             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float maxes[fc::kWarps];
  float2* z = reinterpret_cast<float2*>(smem);
  float2* tw = z + h * fc::pitch(w);
  const int hw = h * w;
  const float* raw = raws + (size_t)blockIdx.x * hw;
  float* o = out + (size_t)blockIdx.x * hw;
  if (!isfinite(__ldg(lnl + blockIdx.x))) {  // the same for the whole block
    for (int p = threadIdx.x; p < hw; p += fc::kThreads) o[p] = 0.0f;
    return;
  }
  const float gb = __ldg(grad + blockIdx.x);
  if constexpr (MIXED) {
    backward_block(z, fc::load_mixed(tw, twiddle, layout, h, w), maxes, raw,
                   k, kc, d, gb, o);
  } else {
    fc::load_twiddles(tw, twiddle, tw_log2);
    backward_block(z, fc::Pow2Geom(h, w, tw, tw_log2), maxes, raw, k, kc, d,
                   gb, o);
  }
}

// matmul-DFT route, in place: conv -> a and mvar -> c.
__global__ void weights_kernel(float* __restrict__ conv, float* __restrict__ mvar,
                               const float* __restrict__ obs,
                               const float* __restrict__ obs_var,
                               const float* __restrict__ good, int batch,
                               int hw) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * hw) return;
  const int p = (int)(idx % hw);
  const float ivm = 1.0f / (mvar[idx] + obs_var[p]);
  const float r = obs[p] - conv[idx];
  const bool g = good[p] > 0.0f;
  conv[idx] = g ? r * ivm : 0.0f;
  mvar[idx] = g ? 0.5f * (r * r * ivm * ivm - ivm) : 0.0f;
}

// matmul-DFT route: out = grad_b (ga + 2 raw gc), 0 where lnl_b is not
// finite.
__global__ void combine_kernel(const float* __restrict__ raws,
                               const float* __restrict__ ga,
                               const float* __restrict__ gc,
                               const float* __restrict__ lnl,
                               const float* __restrict__ grad,
                               float* __restrict__ out, int batch, int hw) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * hw) return;
  const int b = (int)(idx / hw);
  out[idx] = isfinite(lnl[b]) ? grad[b] * (ga[idx] + 2.0f * raws[idx] * gc[idx])
                              : 0.0f;
}

}  // namespace

// C interface of the FFT route.  h, w, twiddle, layout and var_gain as
// conv_lnl_fft_launch takes them; psf_ic and var_ic are the negated
// imaginary planes of the two half spectra; lnl (B,) the forward's
// output, grad (B,) its gradient, out (B, H, W).  Launches on `stream` and
// returns the first nonzero cudaError of the attribute call or the
// launch, or 0.
extern "C" int conv_lnl_fft_backward_launch(
    const float* raws, int batch, int h, int w, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_i, const float* var_r, const float* var_i,
    const float* psf_ic, const float* var_ic, const float* obs,
    const float* obs_var, const float* good, const float* lnl,
    const float* grad, float* out, void* stream) {
  if (batch <= 0) return 0;
  const bool pow2 = fc::power_of_two(h) && fc::power_of_two(w);
  if (!pow2 && !(fc::five_smooth_even(h) && fc::five_smooth_even(w)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = pow2 ? fc::image_bytes(h, w) : fc::mixed_image_bytes(h, w);
  auto kernel = pow2 ? &conv_lnl_fft_backward_kernel<false>
                     : &conv_lnl_fft_backward_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  int tw_log2 = 0;
  while ((1 << tw_log2) < (h > w ? h : w)) ++tw_log2;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, reinterpret_cast<const float2*>(twiddle), tw_log2, layout,
      fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain},
      fc::Spectra{psf_r, psf_ic, var_r, var_ic, var_gain},
      fc::Data{obs, obs_var, good}, lnl, grad, out);
  return (int)cudaGetLastError();
}

// C interface of the matmul-DFT route.  The forward's operators (cw, sw,
// lf, li, ica, isa), the adjoint's (ica_t, isa_t, li_t, lf_t, cw_t, sw_t:
// the transposes, in the order the adjoint applies them), the spectra
// with the negated imaginary planes; t1 and t2 scratch of (B, 2, H, W/2+1)
// floats, conv, mvar, ga and gc of (B, H, W).  Launches on `stream` and
// returns the first nonzero cudaGetLastError() of its launches, or 0.
extern "C" int conv_lnl_dft_backward_launch(
    const float* raws, int batch, int h, int w,
    const float* cw, const float* sw, const float* lf, const float* li,
    const float* ica, const float* isa, const float* ica_t, const float* isa_t,
    const float* li_t, const float* lf_t, const float* cw_t, const float* sw_t,
    const float* psf_r, const float* psf_i, const float* var_r,
    const float* var_i, const float* psf_ic, const float* var_ic,
    const float* obs, const float* obs_var, const float* good,
    const float* lnl, const float* grad, float* t1, float* t2, float* conv,
    float* mvar, float* ga, float* gc, float* out, void* stream_ptr) {
  using psfmc::dftconv::convolve;
  if (batch <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int hw = h * w;
  const unsigned blocks = (unsigned)(((long long)batch * hw + kThreads - 1) / kThreads);
  int err;
  if ((err = convolve(raws, 0, batch, h, w, cw, sw, lf, li, ica, isa, psf_r,
                      psf_i, t1, t2, conv, stream)))
    return err;
  if ((err = convolve(raws, 1, batch, h, w, cw, sw, lf, li, ica, isa, var_r,
                      var_i, t1, t2, mvar, stream)))
    return err;
  weights_kernel<<<blocks, kThreads, 0, stream>>>(conv, mvar, obs, obs_var,
                                                  good, batch, hw);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = convolve(conv, 0, batch, h, w, ica_t, isa_t, li_t, lf_t, cw_t,
                      sw_t, psf_r, psf_ic, t1, t2, ga, stream)))
    return err;
  if ((err = convolve(mvar, 0, batch, h, w, ica_t, isa_t, li_t, lf_t, cw_t,
                      sw_t, var_r, var_ic, t1, t2, gc, stream)))
    return err;
  combine_kernel<<<blocks, kThreads, 0, stream>>>(raws, ga, gc, lnl, grad, out,
                                                  batch, hw);
  return (int)cudaGetLastError();
}
