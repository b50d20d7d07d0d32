// The conv+likelihood backward: dlnL/draw of the batched convolution +
// masked Gaussian lnL, on every route of the forward (Hopper, sm_90a).
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
// factor above 7, the walker in one block's shared memory; fft_conv.cuh's
// power-of-two or mixed-radix geometry): one launch, one block of 512
// threads per walker, ONE FFT pair of fft_conv.cuh in shared memory.  The
// forward under autograd (conv_lnl.cu's residual instantiation) has
// already written each pixel's weights (a, c) and the walker's scale
// exponent e = e_a - e_c (the difference of the exponents of the two
// parts' peaks, clamped to +-96; 0 unless both peaks are finite and
// positive); the backward loads them instead of running the forward's
// pair again:
//  1. the weights, 8 bytes a pixel, copied with cp.async straight into the
//     slot each pixel was read from in the forward's shifted readout,
//     which is where the adjoint of that shift puts them, while the
//     twiddles and the layout tables come in; the shared image's row
//     pitch W + 1 is odd, so each copy is one 8-byte float2;
//  2. the pair with the conjugate spectra (the wrapper passes -Im K): the
//     first row pass multiplies each imaginary part by s' = 2^e as it
//     reads it, so that a + i s' c has one scale (the forward's reason: in
//     a float32 complex image the smaller part is only as exact as the
//     larger part's rounding); FFT2, the split times (conj Kpsf, g conj
//     Kvar), IFFT2 gives a (x) psf + i s' g (c (x) var) in natural order;
//  3. the combine with the raw image, read from global memory.
// psfmc_tpu_torch.ops.kernels.conv_lnl.packed_fft_conv_backward_from_
// residuals_plain is this scheme in plain PyTorch.
//
// Padded route (conv_lnl_padded_backward_launch; the shapes of conv_lnl.cu's
// padded route): the same launch on fft_conv.cuh's PaddedGeom.  The adjoint
// of the forward's fold: each weight is copied to the slot s its pixel was
// read from and, along a padded axis where s <= N - 2, also to s + N (up to
// four cp.async copies of a weight), and every other slot of the M_h x M_w
// transform gets zeros; the pair runs at M with the padded kernels'
// conjugate spectra, and the combine reads [0, N) (the adjoint of the zero
// pad).  psfmc_tpu_torch.ops.kernels.conv_lnl.padded_fft_conv_backward_
// from_residuals_plain is this scheme in plain PyTorch.
//
// Cluster route (conv_lnl_cluster_backward_launch; the shapes of
// conv_lnl.cu's cluster route): the padded route's launch on the cluster's
// split of the transform (fft_cluster.cuh's cluster_backward): each rank copies
// the weights into the slots of its own rows, the pair runs across the
// cluster's shared memory, and each rank combines its share of the image's
// rows.
//
// Global route (conv_lnl_global_backward_launch; the shapes of conv_lnl.cu's
// global route): fft_global.cuh's launch_backward, three launches through
// the scratch S: the row passes of the weights at the slots the forward's
// readout read them from (a transform row H + s repeats row s: the
// adjoint of the fold), the column passes with the conjugate spectra and
// the crop, and the inverse row passes with the combine.
//
// matmul-DFT route (conv_lnl_dft_backward_launch; a side of 1): the
// forward's products recompute conv and mvar (dft_conv.cuh, 14 launches),
// one elementwise kernel forms a and c in place, the same products with
// the transposed operators, in reverse order, and the conjugate spectra
// give the two adjoints (14 launches), and one elementwise kernel
// combines them: 30 launches through global scratch.
//
// What bounds it on the H100 (FFT route): arithmetic, the forward's FFT
// count (one complex FFT pair per walker: about 2.3 MFLOP at 128x128),
// against 16 bytes a pixel (the weights' 8 in, the raw image's 4 in, the
// gradient's 4 out: 262 KB a walker at 128x128).  As in the forward, the
// butterflies' instruction issue through shared memory sets the pace
// with one block of 16 warps on an SM.  The weights cost the forward an
// 8-byte store a pixel and 8 bytes a pixel of device memory between the
// two launches (16.4 MB at 125 walkers x 128x128).
//
// Numerics: true fp32, no --use_fast_math, no tensor cores; the divisions
// and logf are IEEE-accurate.  No atomics: every launch gives the same
// bits.
//
// Targets (the hierarchical fit, psfmc_tpu_torch/hierarchy.py): as in the
// forward, walker b belongs to target b / per_target.  Off the matmul-DFT
// route the target's planes are already inside the forward's
// weights, so the backward reads only that target's spectra and variance
// gain (spectra_stride floats apart, 0: shared); on the matmul-DFT route the
// weights kernel reads the target's obs, obs_var and good (data_stride).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dft_conv.cuh"
#include "fft_cluster.cuh"
#include "fft_conv.cuh"
#include "fft_global.cuh"

namespace {

namespace fc = psfmc::fftconv;

constexpr int kThreads = 256;

// The walker's weights from global memory into the slots the forward's
// shifted readout read them from, as 8-byte cp.async copies, committed as
// one group.
template <class Geom>
__device__ void copy_weights(float2* z, const Geom& g, const float2* src) {
  for (int p = threadIdx.x; p < g.h * g.w; p += fc::kThreads)
    __pipeline_memcpy_async(z + g.shifted(p), src + p, sizeof(float2));
  __pipeline_commit();
}

// The padded geometry's copy: slot t of an axis of image side n takes slot
// s = t (t < n) or s = t - n (n <= t <= 2n - 2: the fold's second term) of
// the shifted readout, the weight of pixel (s - n/2) mod n; every other
// slot of the transform gets zeros.  Each slot is written once, by a
// cp.async copy or a store, so no barrier is needed between the two.
template <class Inner>
__device__ void copy_weights(float2* z, const fc::PaddedGeom<Inner>& g,
                             const float2* src) {
  const int h = g.h, w = g.w, mw = g.t.w, ld = g.t.ld;
  const fc::FastDiv by_mw(mw);
  for (int q = threadIdx.x; q < g.t.h * mw; q += fc::kThreads) {
    const int ty = by_mw.div(q), tx = q - ty * mw;
    float2* dst = z + ty * ld + tx;
    if (ty <= 2 * h - 2 && tx <= 2 * w - 2) {
      int y = (ty < h ? ty : ty - h) - h / 2, x = (tx < w ? tx : tx - w) - w / 2;
      if (y < 0) y += h;
      if (x < 0) x += w;
      __pipeline_memcpy_async(dst, src + y * w + x, sizeof(float2));
    } else {
      *dst = make_float2(0.0f, 0.0f);
    }
  }
  __pipeline_commit();
}

// Steps 2 and 3 on the weights in shared memory (visible to every thread).
template <class Geom>
__device__ void backward_block(float2* z, const Geom& g, const float* raw,
                               const fc::Spectra& kc, int se, float gb,
                               float* o) {
  const int hw = g.h * g.w;
  g.template lines<false, true, true>(z, ldexpf(1.0f, se));
  g.template lines<false, false>(z);
  g.pairs(z, kc);
  __syncthreads();
  g.template lines<true, false>(z);
  g.template lines<true, true>(z);

  // grad_b [a (x) psf + 2 raw (c (x) var)], on the padded geometry from
  // the image's corner of the transform
  const float conv_scale = g.inv_size();
  const float c_scale = ldexpf(conv_scale, -se) / __ldg(kc.var_gain);
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
                             const int* __restrict__ layout, fc::Spectra kcs,
                             int per_target, size_t spectra_stride,
                             const float2* __restrict__ weights,
                             const int* __restrict__ scale_exp,
                             const float* __restrict__ lnl,
                             const float* __restrict__ grad,
                             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  float2* tw = z + h * fc::pitch(w);
  const int hw = h * w;
  const float* raw = raws + (size_t)blockIdx.x * hw;
  const float2* wts = weights + (size_t)blockIdx.x * hw;
  float* o = out + (size_t)blockIdx.x * hw;
  if (!isfinite(__ldg(lnl + blockIdx.x))) {  // the same for the whole block
    for (int p = threadIdx.x; p < hw; p += fc::kThreads) o[p] = 0.0f;
    return;
  }
  const float gb = __ldg(grad + blockIdx.x);
  const int se = __ldg(scale_exp + blockIdx.x);
  const fc::Spectra kc =
      fc::target_spectra(kcs, blockIdx.x / per_target, spectra_stride);
  if constexpr (MIXED) {
    copy_weights(z, fc::MixedGeom(h, w, tw, nullptr), wts);  // shifted() reads no table
    const fc::MixedGeom g = fc::load_mixed(tw, twiddle, layout, h, w);
    __pipeline_wait_prior(0);
    __syncthreads();
    backward_block(z, g, raw, kc, se, gb, o);
  } else {
    const fc::Pow2Geom g(h, w, tw, tw_log2);
    copy_weights(z, g, wts);
    fc::load_twiddles(tw, twiddle, tw_log2);
    __pipeline_wait_prior(0);
    __syncthreads();
    backward_block(z, g, raw, kc, se, gb, o);
  }
}

// The padded route: the image (h, w) in the corner of the transform (mh, mw).
template <bool MIXED>
__global__ void __launch_bounds__(fc::kThreads, 1)
conv_lnl_padded_backward_kernel(const float* __restrict__ raws, int h, int w,
                                int mh, int mw, const float2* __restrict__ twiddle,
                                int tw_log2, const int* __restrict__ layout,
                                fc::Spectra kcs, int per_target,
                                size_t spectra_stride,
                                const float2* __restrict__ weights,
                                const int* __restrict__ scale_exp,
                                const float* __restrict__ lnl,
                                const float* __restrict__ grad,
                                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  float2* tw = z + mh * fc::pitch(mw);
  const int hw = h * w;
  const float* raw = raws + (size_t)blockIdx.x * hw;
  const float2* wts = weights + (size_t)blockIdx.x * hw;
  float* o = out + (size_t)blockIdx.x * hw;
  if (!isfinite(__ldg(lnl + blockIdx.x))) {  // the same for the whole block
    for (int p = threadIdx.x; p < hw; p += fc::kThreads) o[p] = 0.0f;
    return;
  }
  const float gb = __ldg(grad + blockIdx.x);
  const int se = __ldg(scale_exp + blockIdx.x);
  const fc::Spectra kc =
      fc::target_spectra(kcs, blockIdx.x / per_target, spectra_stride);
  if constexpr (MIXED) {
    using Geom = fc::PaddedGeom<fc::MixedGeom>;
    copy_weights(z, Geom(h, w, fc::MixedGeom(mh, mw, tw, nullptr)), wts);  // no table read
    const Geom g(h, w, fc::load_mixed(tw, twiddle, layout, mh, mw));
    __pipeline_wait_prior(0);
    __syncthreads();
    backward_block(z, g, raw, kc, se, gb, o);
  } else {
    const fc::PaddedGeom<fc::Pow2Geom> g(h, w, fc::Pow2Geom(mh, mw, tw, tw_log2));
    copy_weights(z, g, wts);
    fc::load_twiddles(tw, twiddle, tw_log2);
    __pipeline_wait_prior(0);
    __syncthreads();
    backward_block(z, g, raw, kc, se, gb, o);
  }
}

// The cluster route: one cluster of `ranks` blocks a walker.
__global__ void __launch_bounds__(fc::kThreads, 1)
conv_lnl_cluster_backward_kernel(const float* __restrict__ raws, int h, int w, int mh,
                                 int mw, int ranks, const float2* __restrict__ twiddle,
                                 const int* __restrict__ layout, fc::Spectra kcs,
                                 int per_target, size_t spectra_stride,
                                 const float2* __restrict__ weights,
                                 const int* __restrict__ scale_exp,
                                 const float* __restrict__ lnl,
                                 const float* __restrict__ grad,
                                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int walker = blockIdx.x / ranks;
  const int hw = h * w;
  const fc::ClusterGeom g = fc::load_cluster(smem, h, w, mh, mw, ranks, twiddle, layout);
  float* o = out + (size_t)walker * hw;
  if (!isfinite(__ldg(lnl + walker))) {  // the same for every rank of the cluster
    for (int p = g.img0 * w + threadIdx.x; p < (g.img0 + g.nimg) * w; p += fc::kThreads)
      o[p] = 0.0f;
    return;
  }
  fc::cluster_backward(g, raws + (size_t)walker * hw, weights + (size_t)walker * hw,
                       fc::target_spectra(kcs, walker / per_target, spectra_stride),
                       __ldg(scale_exp + walker), __ldg(grad + walker), o);
}

// matmul-DFT route, in place: conv -> a and mvar -> c, walker b against
// the planes of target b / per_target (data_stride floats apart, 0: shared).
__global__ void weights_kernel(float* __restrict__ conv, float* __restrict__ mvar,
                               const float* __restrict__ obs,
                               const float* __restrict__ obs_var,
                               const float* __restrict__ good, int batch,
                               int hw, int per_target, size_t data_stride) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * hw) return;
  const int b = (int)(idx / hw);
  const size_t q =
      data_stride * (size_t)(b / per_target) + (size_t)(idx - (long long)b * hw);
  const float ivm = 1.0f / (mvar[idx] + obs_var[q]);
  const float r = obs[q] - conv[idx];
  const bool g = good[q] > 0.0f;
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

// C interface of the FFT route.  h, w, per_target, twiddle, layout and
// var_gain as conv_lnl_fft_launch takes them, and walker b reads the
// spectra and variance gain of target b / per_target, spectra_stride floats
// apart (0: one PSF; the planes are already inside the weights); psf_ic
// and var_ic are the negated
// imaginary planes of the two half spectra; weights (B, H, W, 2) and
// scale_exp (B,) int32 as conv_lnl_fft_residuals_launch wrote them; lnl
// (B,) the forward's output, grad (B,) its gradient, out (B, H, W).
// Launches on `stream` and returns the first nonzero cudaError of the
// attribute call or the launch, or 0.
extern "C" int conv_lnl_fft_backward_launch(
    const float* raws, int batch, int h, int w, int per_target,
    int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_ic, const float* var_r, const float* var_ic,
    const float* weights, const int* scale_exp, const float* lnl,
    const float* grad, float* out, void* stream) {
  if (batch <= 0) return 0;
  if (per_target < 1 || spectra_stride < 0) return (int)cudaErrorInvalidValue;
  const bool pow2 = fc::power_of_two(h) && fc::power_of_two(w);
  if (!pow2 && !(fc::seven_smooth_even(h) && fc::seven_smooth_even(w)))
    return (int)cudaErrorInvalidValue;
  auto kernel = &conv_lnl_fft_backward_kernel<false>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_geometry(&conv_lnl_fft_backward_kernel<false>,
                                     &conv_lnl_fft_backward_kernel<true>, h, w,
                                     &kernel, &smem, &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, reinterpret_cast<const float2*>(twiddle), tw_log2, layout,
      fc::Spectra{psf_r, psf_ic, var_r, var_ic, var_gain}, per_target,
      (size_t)spectra_stride, reinterpret_cast<const float2*>(weights), scale_exp,
      lnl, grad, out);
  return (int)cudaGetLastError();
}

// C interface of the padded route: conv_lnl_fft_backward_launch's arguments
// with the transform's sides (mh, mw) after the image's (spectra_stride
// counting the padded planes' floats), and twiddle,
// layout and the four spectrum planes at the transform's sides
// (conv_lnl.py's PADDED_BACKWARD_CONST_ARGS).  A shape the host would not
// plan is refused with cudaErrorInvalidValue.  Launches on `stream` and
// returns the first nonzero cudaError of the attribute call or the launch,
// or 0.
extern "C" int conv_lnl_padded_backward_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int per_target,
    int spectra_stride, const float* twiddle, const int* layout,
    const float* var_gain, const float* psf_r, const float* psf_ic, const float* var_r,
    const float* var_ic, const float* weights, const int* scale_exp,
    const float* lnl, const float* grad, float* out, void* stream) {
  if (batch <= 0) return 0;
  if (!fc::padded_plan(h, w, mh, mw)) return (int)cudaErrorInvalidValue;
  if (per_target < 1 || spectra_stride < 0) return (int)cudaErrorInvalidValue;
  auto kernel = &conv_lnl_padded_backward_kernel<false>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_geometry(&conv_lnl_padded_backward_kernel<false>,
                                     &conv_lnl_padded_backward_kernel<true>, mh,
                                     mw, &kernel, &smem, &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, mh, mw, reinterpret_cast<const float2*>(twiddle), tw_log2,
      layout, fc::Spectra{psf_r, psf_ic, var_r, var_ic, var_gain}, per_target,
      (size_t)spectra_stride, reinterpret_cast<const float2*>(weights), scale_exp,
      lnl, grad, out);
  return (int)cudaGetLastError();
}

// C interface of the cluster route: conv_lnl_padded_backward_launch's
// arguments with the cluster's size `ranks` after the transform's sides,
// and twiddle and layout the transform's mixed-radix tables
// (conv_lnl_cluster_launch's).  Launches batch x ranks blocks on `stream`
// and returns as conv_lnl_cluster_launch.
extern "C" int conv_lnl_cluster_backward_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int ranks,
    int per_target, int spectra_stride, const float* twiddle, const int* layout,
    const float* var_gain, const float* psf_r, const float* psf_ic, const float* var_r,
    const float* var_ic, const float* weights, const int* scale_exp,
    const float* lnl, const float* grad, float* out, void* stream) {
  if (batch <= 0) return 0;
  if (h < 2 || w < 2 || mh != fc::transform_side(h) || mw != fc::transform_side(w))
    return (int)cudaErrorInvalidValue;
  if (per_target < 1 || spectra_stride < 0) return (int)cudaErrorInvalidValue;
  return fc::launch_cluster(
      &conv_lnl_cluster_backward_kernel, batch, ranks,
      fc::cluster_image_bytes(mh, mw, ranks), (cudaStream_t)stream, raws, h, w, mh, mw,
      ranks, reinterpret_cast<const float2*>(twiddle), layout,
      fc::Spectra{psf_r, psf_ic, var_r, var_ic, var_gain}, per_target,
      (size_t)spectra_stride, reinterpret_cast<const float2*>(weights), scale_exp, lnl,
      grad, out);
}

// C interface of the global route: conv_lnl_cluster_backward_launch's
// arguments with a tile's rows and a column group's bins (rows, cols) in
// place of the cluster's size, then S, (B, H, mw, 2) float32 scratch, before
// out (fft_global.cuh's launch_backward: three launches).  Launches on
// `stream` and returns 0, the first cudaError of the attribute calls or the
// launches, or cudaErrorInvalidValue for a plan the host would not make.
extern "C" int conv_lnl_global_backward_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int rows, int cols,
    int per_target, int spectra_stride, const float* twiddle, const int* layout,
    const float* var_gain, const float* psf_r, const float* psf_ic, const float* var_r,
    const float* var_ic, const float* weights, const int* scale_exp, const float* lnl,
    const float* grad, float* scratch, float* out, void* stream) {
  namespace fg = psfmc::fftglobal;
  if (batch <= 0) return 0;
  const fg::Plan p{h, w, mh, mw, rows, cols};
  if (!fg::plan_ok(p) || per_target < 1 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  return fg::launch_backward(raws, batch, p, reinterpret_cast<const float2*>(twiddle), layout,
                             fc::Spectra{psf_r, psf_ic, var_r, var_ic, var_gain}, per_target,
                             (size_t)spectra_stride, reinterpret_cast<const float2*>(weights),
                             scale_exp, lnl, grad, reinterpret_cast<float2*>(scratch), out,
                             (cudaStream_t)stream);
}

// C interface of the matmul-DFT route.  The forward's operators (cw, sw,
// lf, li, ica, isa), the adjoint's (ica_t, isa_t, li_t, lf_t, cw_t, sw_t:
// the transposes, in the order the adjoint applies them), the spectra
// with the negated imaginary planes (shared); walker b reads obs, obs_var
// and good at target b / per_target, data_stride floats apart (0: one
// observation); t1 and t2 scratch of (B, 2, H, W/2+1)
// floats, conv, mvar, ga and gc of (B, H, W).  Launches on `stream` and
// returns the first nonzero cudaGetLastError() of its launches, or 0.
extern "C" int conv_lnl_dft_backward_launch(
    const float* raws, int batch, int h, int w, int per_target, int data_stride,
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
  if (per_target < 1 || data_stride < 0) return (int)cudaErrorInvalidValue;
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
                                                  good, batch, hw, per_target,
                                                  (size_t)data_stride);
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
