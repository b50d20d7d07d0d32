// Batched PSF convolution + masked Gaussian log-likelihood (Hopper, sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   psfmc_tpu/ops/pallas/lnpost_batched.py::make_batched_conv_lnl
// (kernel body `_make_kernel`, gate `batched_lnl_supported`).
//
// What it computes, per walker b of the batch of raw model images x_b:
//   conv_b = x_b (*) psf        mvar_b = x_b^2 (*) psf_var
//   ivm    = 1 / (mvar_b + obs_var)      resid = obs - conv_b
//   lnl_b  = -1/2 sum_good [resid^2 ivm - log(ivm / 2 pi)]   (-inf if not finite)
// where (*) is the circular convolution with the trailing ifftshift,
// written as the twelve real half-spectrum products of
// psfmc_tpu_torch.ops.fourier.convolve_rdft:
//   S1 = x @ [cw | -sw]                 2 products  (H,W)@(W,W2)
//   S2 = [[ch, sh], [-sh, ch]] @ S1     4 products  (2H,2H)@(2H,W2)
//   S3 = S2 * K                         complex multiply, elementwise
//   S4 = [[ich, -ish], [ish, ich]] @ S3 4 products
//   out = S4r @ ica - S4i @ isa         2 products  (H,W2)@(W2,W)
// with S1..S4 stored per walker as [real rows; imaginary rows].
//
// What bounds the function on the H100: arithmetic, by the count of real
// FFTs: about 0.32 GFLOP for a 125-walker half-ensemble at 128x128, ~5 us
// at the 67 TFLOP/s fp32 (non-tensor-core) peak, against 8 MB of images
// read (~2.5 us).
//
// Five routes, chosen by the wrapper from the shape alone (conv_route in
// psfmc_tpu_torch/ops/kernels/conv_lnl.py):
//
// FFT route (H and W even with no prime factor above 7, the walker fits
// in a block's shared memory; conv_lnl_fft_launch): ONE launch, one block
// per walker.  The block loads the walker's image into shared memory and
// runs fft_conv.cuh on it: both convolutions as one complex FFT pair, then
// the lnL readout; radix-2 stages when both sides are powers of two,
// radix-2, -3, -5 and -7 stages otherwise.  No global scratch; the only write
// is the walker's lnL.  A second instantiation of the same kernel
// (RESID; conv_lnl_fft_residuals_launch, taken only by the forward of
// conv_lnl's autograd Function) also
// writes what its backward (conv_lnl_backward.cu) reads instead of
// recomputing the pair: the two likelihood weights per pixel (a float2,
// 8 bytes a pixel) and the walker's scale exponent; the same lnL bits.
//
// Padded route (a side that is odd or has a prime factor above 7, and the
// transform fits a block: every side up to 81; conv_lnl_padded_launch and
// its residual instantiation): the FFT route's kernel on fft_conv.cuh's
// PaddedGeom.  Each such side N is zero-padded to M, the smallest even
// side with no prime factor above 7 of at least 2N - 1 (74 -> 150, 45 ->
// 90, 37 -> 80); the host pads the PSF kernels the same way (placed at
// [0, N), their M-point half spectra).  The M-point circular convolution
// is then the linear one, and the readout folds it back, y[s] = z[s] +
// z[s + N]: the N-point circular convolution exactly.  The block writes
// the zeros of the pad itself (shared memory is not initialised), the
// passes run at M, the inverse divides by M_h M_w, and everything else
// (the scales, the pair step, the lnL, the residuals) is the FFT route's.
// At 74x74 the transform is 150x150 ([5][5][3 2] per axis, 186,080 B of
// shared memory), 4.1x the image's pixels.
//
// Cluster route (the shapes whose FFT-route or padded transform fits no
// block but fits a cluster of 2, 4 or 8 blocks: 88x88, 94x94, 101x101,
// 160x180, 196x196, 200x200 on 2 blocks, 256x256 on 4;
// conv_lnl_cluster_launch and its residual instantiation): the padded
// route's scheme at the transform padded_shape (the image's own sides where
// the FFT route takes them), held across the blocks' shared memory, one
// cluster a walker (fft_cluster.cuh); the same arguments as the padded
// route, the target axis included, and the cluster's size.
//
// Global route (the transforms no cluster of 8 holds: 512x512, 640x640,
// 235x235 -> 480x480, 251x251 -> 504x504; conv_lnl_global_launch and its
// residual instantiation): the padded route's scheme at the transform, its
// rows in a global-memory scratch the wrapper allocates, five launches
// (fft_global.cuh: peaks, row passes by tiles of rows, column passes and
// the pair step by groups of bins with their partners, the inverse row
// passes and the readout by tiles, the tiles' partial sums reduced in
// order); the same arguments as the cluster route with the tiles in place
// of the cluster's size, then the scratch.
//
// matmul-DFT route (what no other route takes: a side of 1;
// conv_lnl_launch): each convolution
// as the twelve real half-spectrum products above, 20x the FFT count of
// operations at 128x128 (W2 = 65: 2 convolutions x 12 x 2*128*128*65 ~ 51
// MFLOP per walker, ~6.4 GFLOP per half-ensemble, ~0.1 ms at peak for the
// formulation alone).  One strided, batched, shared-memory-tiled fp32 FMA
// GEMM kernel (64x64 output tile, 16-deep k slices, 4x4 outputs per
// thread, walkers on gridDim.z) runs every product; the squared image of
// the variance convolution is formed as A is loaded, and the forward and
// inverse h-direction stages are single products with the 2x2 block real
// operators.  Intermediates live in global scratch that the caller
// allocates; a complex-multiply kernel and a per-walker reduction kernel
// (one block per walker, float64 accumulation) finish the job: 15
// launches.  No TF32 and no tensor cores: fp32 is the contract (TF32's
// 10-bit mantissa collapses the sampler's acceptance, as single-pass bf16
// did on the TPU).
//
// Targets (the batch fit, psfmc_tpu_torch/batchfit.py): one launch may
// carry the walkers of K independent fits, each against its own
// observation.  Walker b reads target t = b / per_target (the walkers of
// a target are contiguous) and that target's observation, variance and
// mask planes, data_stride floats apart (H * W; 0 shares one observation,
// as every single-fit caller does).  Off the matmul-DFT route
// each target may also bring its own PSF: spectra_stride floats between two
// targets' half-spectrum planes and one variance gain per target.  On the
// matmul-DFT route the spectra are GEMM operands and stay shared (the
// wrapper sends a batch with per-target spectra there to the general
// path).  The residual instantiations take the same arguments, and the
// backward kernels (conv_lnl_backward.cu) the target axis too.  A stride
// costs one division per block.
//
// Numerics: no --use_fast_math and no __logf: logf and the division are
// IEEE-accurate.

#include <cuda_runtime.h>
#include <math.h>

#include "dft_conv.cuh"
#include "fft_cluster.cuh"
#include "fft_conv.cuh"
#include "fft_global.cuh"

namespace {

using namespace psfmc::dftconv;

constexpr int kThreads = 256;
constexpr float kInv2Pi = 0.15915494309189535f;

// One block per walker: the masked Gaussian lnL of conv/mvar against its
// target's obs (stride floats per target, 0: one observation).
__global__ void __launch_bounds__(kThreads)
lnl_kernel(const float* __restrict__ conv, const float* __restrict__ mvar,
           const float* __restrict__ obs, const float* __restrict__ obs_var,
           const float* __restrict__ good, float* __restrict__ out, int hw,
           int per_target, size_t stride) {
  __shared__ double partial[kThreads / 32];
  const long long base = (long long)blockIdx.x * hw;
  const size_t target = stride * (size_t)(blockIdx.x / per_target);
  obs += target;
  obs_var += target;
  good += target;
  double s = 0.0;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float ivm = 1.0f / (mvar[base + p] + obs_var[p]);
    const float resid = obs[p] - conv[base + p];
    const bool g = good[p] > 0.0f;
    const float safe_ivm = g ? ivm : 1.0f;
    const float term = resid * resid * ivm - logf(kInv2Pi * safe_ivm);
    if (g) s += (double)(-0.5f * term);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < kThreads / 32; ++i) tot += partial[i];
    const float r = (float)tot;
    out[blockIdx.x] = isfinite(r) ? r : -INFINITY;
  }
}

}  // namespace

// C interface (loaded with ctypes).  All pointers are float32 device
// memory; t1 and t2 are scratch of (B, 2, H, W/2+1) floats each, conv and
// mvar of (B, H, W).  Walker b reads obs, obs_var and good at target b /
// per_target, data_stride floats per target (0: shared); the spectra are
// shared.  Launches on `stream` and returns the first nonzero
// cudaGetLastError() of its launches, or 0 (cudaErrorInvalidValue for
// per_target < 1 or a negative stride).
extern "C" int conv_lnl_launch(
    const float* raws, int batch, int h, int w, int per_target, int data_stride,
    const float* cw, const float* sw, const float* lf, const float* li,
    const float* ica, const float* isa,
    const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* t1, float* t2, float* conv, float* mvar, float* out,
    void* stream_ptr) {
  if (batch <= 0) return 0;
  if (per_target < 1 || data_stride < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err;
  if ((err = convolve(raws, 0, batch, h, w, cw, sw, lf, li, ica, isa, psf_r,
                      psf_i, t1, t2, conv, stream)))
    return err;
  if ((err = convolve(raws, 1, batch, h, w, cw, sw, lf, li, ica, isa, var_r,
                      var_i, t1, t2, mvar, stream)))
    return err;
  lnl_kernel<<<batch, kThreads, 0, stream>>>(conv, mvar, obs, obs_var, good,
                                             out, h * w, per_target,
                                             (size_t)data_stride);
  return (int)cudaGetLastError();
}

namespace {

namespace fc = psfmc::fftconv;

// FFT route: one block per walker, the whole likelihood in one launch, on
// the power-of-two geometry or the mixed-radix one; walker b against the
// spectra and data of target b / per_target.  With RESID (the residual
// instantiation) it also writes weights (B, H, W) float2 and scale_exp (B,).
template <bool MIXED, bool RESID>
__global__ void __launch_bounds__(fc::kThreads, 1)
conv_lnl_fft_kernel(const float* __restrict__ raws, int h, int w,
                    const float2* __restrict__ twiddle, int tw_log2,
                    const int* __restrict__ layout, fc::Spectra ks, fc::Data ds,
                    int per_target, size_t data_stride, size_t spectra_stride,
                    float* __restrict__ out, float2* __restrict__ weights,
                    int* __restrict__ scale_exp) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  float2* tw = z + h * fc::pitch(w);
  const float* raw = raws + (size_t)blockIdx.x * h * w;
  const int t = blockIdx.x / per_target;
  const fc::Spectra k = fc::target_spectra(ks, t, spectra_stride);
  const fc::Data d = fc::target_data(ds, t, data_stride);
  float2* wts = RESID ? weights + (size_t)blockIdx.x * h * w : nullptr;
  int* se = RESID ? scale_exp + blockIdx.x : nullptr;
  PSFMC_STAMP(0);
  if constexpr (MIXED) {
    const fc::MixedGeom g = fc::load_mixed(tw, twiddle, layout, h, w);
    const float mx = fc::load_image(z, g, raw);
    PSFMC_STAMP(1);
    fc::convolve_and_reduce<fc::MixedGeom, RESID>(z, g, mx, k, d, out + blockIdx.x,
                                                  wts, se);
  } else {
    fc::load_twiddles(tw, twiddle, tw_log2);
    const fc::Pow2Geom g(h, w, tw, tw_log2);
    const float mx = fc::load_image(z, g, raw);
    PSFMC_STAMP(1);
    fc::convolve_and_reduce<fc::Pow2Geom, RESID>(z, g, mx, k, d, out + blockIdx.x,
                                                 wts, se);
  }
}

// The padded route: the same on PaddedGeom, the image (h, w) in the corner
// of the transform (mh, mw); walker b against target b / per_target.
template <bool MIXED, bool RESID>
__global__ void __launch_bounds__(fc::kThreads, 1)
conv_lnl_padded_kernel(const float* __restrict__ raws, int h, int w, int mh,
                       int mw, const float2* __restrict__ twiddle, int tw_log2,
                       const int* __restrict__ layout, fc::Spectra ks,
                       fc::Data ds, int per_target, size_t data_stride,
                       size_t spectra_stride, float* __restrict__ out,
                       float2* __restrict__ weights, int* __restrict__ scale_exp) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  float2* tw = z + mh * fc::pitch(mw);
  const float* raw = raws + (size_t)blockIdx.x * h * w;
  const int t = blockIdx.x / per_target;
  const fc::Spectra k = fc::target_spectra(ks, t, spectra_stride);
  const fc::Data d = fc::target_data(ds, t, data_stride);
  float2* wts = RESID ? weights + (size_t)blockIdx.x * h * w : nullptr;
  int* se = RESID ? scale_exp + blockIdx.x : nullptr;
  PSFMC_STAMP(0);
  if constexpr (MIXED) {
    using Geom = fc::PaddedGeom<fc::MixedGeom>;
    const Geom g(h, w, fc::load_mixed(tw, twiddle, layout, mh, mw));
    const float mx = fc::load_image(z, g, raw);
    PSFMC_STAMP(1);
    fc::convolve_and_reduce<Geom, RESID>(z, g, mx, k, d, out + blockIdx.x, wts, se);
  } else {
    using Geom = fc::PaddedGeom<fc::Pow2Geom>;
    fc::load_twiddles(tw, twiddle, tw_log2);
    const Geom g(h, w, fc::Pow2Geom(mh, mw, tw, tw_log2));
    const float mx = fc::load_image(z, g, raw);
    PSFMC_STAMP(1);
    fc::convolve_and_reduce<Geom, RESID>(z, g, mx, k, d, out + blockIdx.x, wts, se);
  }
}

}  // namespace


// C interface of the FFT route.  h and w are both powers of two, or both
// even with no prime factor above 7.  Walker b fits target b / per_target:
// obs, obs_var and good are data_stride floats per target, the four
// spectrum planes spectra_stride floats and var_gain one float per target
// where spectra_stride is not 0 (0 and 0: one observation and one PSF).
// For powers of two, twiddle is the
// (max(h, w) / 2, 2) float32 table of exp(-2 pi i k / max(h, w)) and
// layout is not read; otherwise twiddle holds H's table, then W's (N
// entries of exp(-2 pi i k / N) each, N / 2 for a power of two), and
// layout the int32 tables of fft_conv.cuh's layout (conv_lnl.py's
// fft_layout).  var_gain is one float, the power of two applied to the
// variance spectrum.  Launches on `stream` and returns the first nonzero
// cudaError of the attribute call or the launch, or 0.
extern "C" int conv_lnl_fft_launch(
    const float* raws, int batch, int h, int w, int per_target,
    int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* out, void* stream) {
  if (batch <= 0) return 0;
  if (per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = &conv_lnl_fft_kernel<false, false>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_fft(&conv_lnl_fft_kernel<false, false>,
                            &conv_lnl_fft_kernel<true, false>, h, w, &kernel, &smem,
                            &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, reinterpret_cast<const float2*>(twiddle), tw_log2, layout,
      fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain}, fc::Data{obs, obs_var, good},
      per_target, (size_t)data_stride, (size_t)spectra_stride, out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The FFT route with the residuals for the backward (conv_lnl.py's
// batched_conv_lnl_residuals): conv_lnl_fft_launch's arguments, then
// weights, (B, H, W, 2) float32 (a, c per pixel), and scale_exp, (B,)
// int32.  Launches on `stream` and returns as conv_lnl_fft_launch.
extern "C" int conv_lnl_fft_residuals_launch(
    const float* raws, int batch, int h, int w, int per_target,
    int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* out, float* weights, int* scale_exp, void* stream) {
  if (batch <= 0) return 0;
  if (per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = &conv_lnl_fft_kernel<false, true>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_fft(&conv_lnl_fft_kernel<false, true>,
                            &conv_lnl_fft_kernel<true, true>, h, w, &kernel, &smem,
                            &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, reinterpret_cast<const float2*>(twiddle), tw_log2, layout,
      fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain}, fc::Data{obs, obs_var, good},
      per_target, (size_t)data_stride, (size_t)spectra_stride, out,
      reinterpret_cast<float2*>(weights), scale_exp);
  return (int)cudaGetLastError();
}

// C interface of the padded route: conv_lnl_fft_launch's arguments with the
// transform's sides (mh, mw) after the image's (then per_target and the
// strides, spectra_stride counting the padded planes' floats), and
// twiddle, layout and the
// four spectrum planes at the transform's sides (conv_lnl.py's
// PADDED_CONST_ARGS: the padded kernels' (mh, mw/2+1) half spectra, the FFT
// route's tables at (mh, mw)); var_gain, obs, obs_var and good at the
// image's.  A shape the host would not plan (padded_plan) is refused with
// cudaErrorInvalidValue.  Launches on `stream` and returns the first nonzero
// cudaError of the attribute call or the launch, or 0.
extern "C" int conv_lnl_padded_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int per_target,
    int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good, float* out,
    void* stream) {
  if (batch <= 0) return 0;
  if (!fc::padded_plan(h, w, mh, mw)) return (int)cudaErrorInvalidValue;
  if (per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = &conv_lnl_padded_kernel<false, false>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_geometry(&conv_lnl_padded_kernel<false, false>,
                                     &conv_lnl_padded_kernel<true, false>, mh,
                                     mw, &kernel, &smem, &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, mh, mw, reinterpret_cast<const float2*>(twiddle), tw_log2,
      layout, fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain},
      fc::Data{obs, obs_var, good}, per_target, (size_t)data_stride,
      (size_t)spectra_stride, out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The padded route with the residuals for the backward:
// conv_lnl_padded_launch's arguments, then weights, (B, H, W, 2) float32,
// and scale_exp, (B,) int32, as conv_lnl_fft_residuals_launch writes them.
extern "C" int conv_lnl_padded_residuals_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int per_target,
    int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good, float* out,
    float* weights, int* scale_exp, void* stream) {
  if (batch <= 0) return 0;
  if (!fc::padded_plan(h, w, mh, mw)) return (int)cudaErrorInvalidValue;
  if (per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = &conv_lnl_padded_kernel<false, true>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_geometry(&conv_lnl_padded_kernel<false, true>,
                                     &conv_lnl_padded_kernel<true, true>, mh,
                                     mw, &kernel, &smem, &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      raws, h, w, mh, mw, reinterpret_cast<const float2*>(twiddle), tw_log2,
      layout, fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain},
      fc::Data{obs, obs_var, good}, per_target, (size_t)data_stride,
      (size_t)spectra_stride, out, reinterpret_cast<float2*>(weights), scale_exp);
  return (int)cudaGetLastError();
}

namespace {

// The cluster route: one cluster of `ranks` blocks a walker (fft_cluster.cuh),
// walker b against the spectra and data of target b / per_target.
template <bool RESID>
__global__ void __launch_bounds__(fc::kThreads, 1)
conv_lnl_cluster_kernel(const float* __restrict__ raws, int h, int w, int mh, int mw,
                        int ranks, const float2* __restrict__ twiddle,
                        const int* __restrict__ layout, fc::Spectra ks, fc::Data ds,
                        int per_target, size_t data_stride, size_t spectra_stride,
                        float* __restrict__ out, float2* __restrict__ weights,
                        int* __restrict__ scale_exp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int walker = blockIdx.x / ranks;
  const fc::ClusterGeom g = fc::load_cluster(smem, h, w, mh, mw, ranks, twiddle, layout);
  const int t = walker / per_target;
  fc::cluster_convolve_and_reduce<RESID>(
      g, fc::cluster_load_rows(g, raws + (size_t)walker * h * w),
      fc::target_spectra(ks, t, spectra_stride),
      fc::target_data(ds, t, data_stride), out + walker,
      RESID ? weights + (size_t)walker * h * w : nullptr,
      RESID ? scale_exp + walker : nullptr);
}

template <bool RESID>
int launch_cluster_route(const float* raws, int batch, int h, int w, int mh, int mw,
                         int ranks, int per_target, int data_stride, int spectra_stride,
                         const float* twiddle, const int* layout, const float* var_gain,
                         const float* psf_r, const float* psf_i, const float* var_r,
                         const float* var_i, const float* obs, const float* obs_var,
                         const float* good, float* out, float* weights, int* scale_exp,
                         void* stream) {
  if (batch <= 0) return 0;
  if (h < 2 || w < 2 || mh != fc::transform_side(h) || mw != fc::transform_side(w))
    return (int)cudaErrorInvalidValue;
  if (per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  return fc::launch_cluster(
      &conv_lnl_cluster_kernel<RESID>, batch, ranks,
      fc::cluster_image_bytes(mh, mw, ranks), (cudaStream_t)stream, raws, h, w, mh, mw,
      ranks, reinterpret_cast<const float2*>(twiddle), layout,
      fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain}, fc::Data{obs, obs_var, good},
      per_target, (size_t)data_stride, (size_t)spectra_stride, out,
      reinterpret_cast<float2*>(weights), scale_exp);
}

}  // namespace

// C interface of the cluster route: conv_lnl_padded_launch's arguments with
// the cluster's size `ranks` (2, 4 or 8; conv_lnl.py's cluster_size) after
// the transform's sides (mh, mw: padded_shape, the image's own sides where
// they are even with no prime factor above 7), and twiddle and layout the
// mixed-radix tables of the transform for both sides (conv_lnl.py's
// cluster_tables; a power of two planned as radix-2 passes).  Launches
// batch x ranks blocks on `stream` and returns 0, the cudaError of the
// attribute call or the launch, cudaErrorInvalidValue for a shape the host
// would not plan, or -1 where the launch was refused because no such
// cluster can be scheduled on the card.
extern "C" int conv_lnl_cluster_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int ranks,
    int per_target, int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i, const float* obs, const float* obs_var,
    const float* good, float* out, void* stream) {
  return launch_cluster_route<false>(raws, batch, h, w, mh, mw, ranks, per_target,
                                     data_stride, spectra_stride, twiddle, layout,
                                     var_gain, psf_r, psf_i, var_r, var_i, obs, obs_var,
                                     good, out, nullptr, nullptr, stream);
}

// The cluster route with the residuals for the backward:
// conv_lnl_cluster_launch's arguments, then weights, (B, H, W, 2) float32,
// and scale_exp, (B,) int32, as conv_lnl_fft_residuals_launch writes them.
extern "C" int conv_lnl_cluster_residuals_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int ranks,
    int per_target, int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i, const float* obs, const float* obs_var,
    const float* good, float* out, float* weights, int* scale_exp, void* stream) {
  return launch_cluster_route<true>(raws, batch, h, w, mh, mw, ranks, per_target,
                                    data_stride, spectra_stride, twiddle, layout,
                                    var_gain, psf_r, psf_i, var_r, var_i, obs, obs_var,
                                    good, out, weights, scale_exp, stream);
}

// C interface of the global route (the transforms no cluster of 8 holds;
// fft_global.cuh): conv_lnl_padded_launch's arguments with a tile's rows and
// a column group's bins (rows, cols: conv_lnl.py's global_tiles) after the
// transform's sides, twiddle and layout the transform's mixed-radix tables
// (cluster_tables), then the scratch the wrapper allocates: S (B, H, mw, 2)
// float32, peaks (B, ceil(H / rows)) float32 and partials (B, ceil(H /
// rows)) float64.  Launches five kernels on `stream` and returns 0, the
// first cudaError of the attribute calls or the launches, or
// cudaErrorInvalidValue for a plan the host would not make.
extern "C" int conv_lnl_global_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int rows, int cols,
    int per_target, int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i, const float* obs, const float* obs_var,
    const float* good, float* scratch, float* peaks, double* partials, float* out,
    void* stream) {
  namespace fg = psfmc::fftglobal;
  if (batch <= 0) return 0;
  const fg::Plan p{h, w, mh, mw, rows, cols};
  if (!fg::plan_ok(p) || per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  return fg::launch_forward<false>(
      raws, false, batch, p, reinterpret_cast<const float2*>(twiddle), layout,
      fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain}, fc::Data{obs, obs_var, good},
      per_target, (size_t)data_stride, (size_t)spectra_stride,
      reinterpret_cast<float2*>(scratch), peaks, partials, nullptr, out, nullptr, nullptr,
      (cudaStream_t)stream);
}

// The global route with the residuals for the backward:
// conv_lnl_global_launch's arguments with maxes (B, ceil(H / rows), 2)
// float32 scratch after the partials, then out, weights (B, H, W, 2)
// float32 and scale_exp (B,) int32, as conv_lnl_fft_residuals_launch
// writes them.
extern "C" int conv_lnl_global_residuals_launch(
    const float* raws, int batch, int h, int w, int mh, int mw, int rows, int cols,
    int per_target, int data_stride, int spectra_stride, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i, const float* obs, const float* obs_var,
    const float* good, float* scratch, float* peaks, double* partials, float* maxes,
    float* out, float* weights, int* scale_exp, void* stream) {
  namespace fg = psfmc::fftglobal;
  if (batch <= 0) return 0;
  const fg::Plan p{h, w, mh, mw, rows, cols};
  if (!fg::plan_ok(p) || per_target < 1 || data_stride < 0 || spectra_stride < 0)
    return (int)cudaErrorInvalidValue;
  return fg::launch_forward<true>(
      raws, false, batch, p, reinterpret_cast<const float2*>(twiddle), layout,
      fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain}, fc::Data{obs, obs_var, good},
      per_target, (size_t)data_stride, (size_t)spectra_stride,
      reinterpret_cast<float2*>(scratch), peaks, partials, maxes, out,
      reinterpret_cast<float2*>(weights), scale_exp, (cudaStream_t)stream);
}
