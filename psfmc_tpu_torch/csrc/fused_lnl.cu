// Fused render + PSF convolution + masked Gaussian log-likelihood, one
// walker per block (Hopper, sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   psfmc_tpu/ops/pallas/lnpost_pallas.py::make_fused_lnl_batch
// (kernel body `_make_kernel`, gate `fused_lnl_supported`).
//
// What it computes, per walker b, from the per-walker scalars that the
// wrapper prepares in torch (packed Sersic rows, sky, point-source 1-D
// kernels fky = flux * ky and kx):
//   raw   = sky + sum_s sersic_s + sum_p fky_p (x) kx_p         (H, W)
//   conv  = raw (*) psf            mvar = raw^2 (*) psf_var
//   lnl_b = -1/2 sum_good [(obs - conv)^2 ivm - log(ivm / 2 pi)],
//   ivm   = 1 / (mvar + obs_var)                 (-inf if not finite)
// where (*) is the circular convolution with the trailing ifftshift,
// written as the real half-spectrum products of
// psfmc_tpu_torch.ops.fourier.convolve_rdft (as in conv_lnl.cu):
//   S1 = x @ [cw | -sw]                        (H,W) @ (W,W2), twice
//   S2 = [[ch, sh], [-sh, ch]] @ S1            (2H,2H) @ (2H,W2)
//   S3 = S2 * K                                complex, elementwise
//   S4 = [[ich, -ish], [ish, ich]] @ S3        (2H,2H) @ (2H,W2)
//   out = S4r @ ica - S4i @ isa                (H,W2) @ (W2,W), twice
//
// What bounds the function on the H100: arithmetic, by the count of real
// FFTs plus the render: about 0.45 GFLOP for a 125-walker half-ensemble
// at 128x128, ~7 us at the 67 TFLOP/s fp32 (non-tensor-core) peak.  The
// bytes are the walker's scalars in and one float out, plus the shared
// spectra and data (~0.4 MB, resident in the 50 MB L2).
//
// Two routes, chosen by the wrapper from the shape alone (conv_route in
// psfmc_tpu_torch/ops/kernels/conv_lnl.py), each one block of 512 threads
// per walker, 125 walkers on 125 of the 132 SMs in one wave, the only
// write to global memory the walker's lnL:
//
// FFT route (H and W powers of two, the walker fits in a block;
// fused_lnl_fft_launch): the render goes into the real parts of one
// float2 image in shared memory, and fft_conv.cuh does the rest: both
// convolutions as one complex FFT pair, then the lnL readout.
//
// The render phase of both routes (render_raw) is sersic_profile.cuh's
// SersicSet, the render kernel's code: the walker's and the row's constant
// terms are hoisted, the threads lie over the image in two dimensions so
// that no index is divided per pixel, and the chains of a walker's (one to
// three) Sersics are unrolled side by side.  With one block of 16 warps on
// an SM the phase is bound by the schedulers' rate, some 70 instructions
// per profile evaluation, not by the chain's latency.
//
// matmul-DFT route (every other shape; fused_lnl_launch): the products
// above, 2 convolutions x 2 x (2*128*128*65 + 2*256*256*65 + 2*128*65*128)
// ~ 51 MFLOP per walker at 128x128 (W2 = 65), 20x the FFT count: ~0.1 ms
// at peak for the formulation alone.
//
// Design of the matmul-DFT route.  The walker's whole working set stays
// in dynamic shared memory: three buffers X, Y, Z of (2, H, W2) floats
// (66,560 B each at 128x128, 199,680 B in all, under the 227 KB a block
// may have), used in this order:
//   render raw -> X;
//   variance convolution X^2 -> Y -> Z -> Y, ending with mvar in Z;
//   PSF convolution X -> Y -> X -> Y (raw is dead after its first product);
//   the last PSF product S4r @ ica - S4i @ isa is fused with the lnL
//   reduction against mvar, obs, obs_var and good, summed in float64.
// The only write to global memory is the walker's lnL.  Every product is
// the same block GEMM: a warp owns 8 output rows, a lane 3 or 4 output
// columns (strided by 32), so the row operand is a broadcast load and the
// column operand a conflict-free, coalesced one; accumulation is true
// fp32 FMA.  The operators are read from global memory (L2) as they are
// used.  Not done yet: staging operator tiles in the 32 KB of shared
// memory left over, vectorised loads, a W2 tiling that does not waste a
// third of the last 32-column group, tensor-core 3xTF32 products.
//
// Numerics: no --use_fast_math, no __expf/__logf, no TF32, no tensor
// cores.  The render is sersic_profile.cuh's rounding discipline, so raw
// is bit-identical to the render kernel's; the products are fp32 FMA in
// an order of their own (the plain version uses cuBLAS), the reduction is
// the one of conv_lnl.cu.  The TPU kernel's bf16x3 emulated products are
// not ported: they existed only because Mosaic lacks an fp32 product.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_conv.cuh"
#include "sersic_profile.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;  // 512
constexpr int kTM = 8;                 // output rows a warp owns per pass
constexpr float kInv2Pi = 0.15915494309189535f;

struct Args {
  const float* packed;  // (B, S, 9)
  const float* sky;     // (B,)
  const float* fky;     // (B, P, H)
  const float* kx;      // (B, P, W)
  int num_sersic, num_ps, h, w;
  const float *cw, *sw;    // (W, W2)
  const float *lf, *li;    // (2H, 2H)
  const float *ica, *isa;  // (W2, W)
  const float *psf_r, *psf_i, *var_r, *var_i;  // (H, W2)
  const float *obs, *obs_var, *good;           // (H, W)
  float* out;                                  // (B,)
};

// alpha * A (M x K, row stride lda) @ B (K x N, row stride ldb)
struct Term {
  const float* a;
  int lda;
  const float* b;
  int ldb;
  float alpha;  // +1 or -1: exact
};

struct Store {
  float* c;
  int ldc;
  __device__ __forceinline__ void operator()(int r, int col, float v) {
    c[r * ldc + col] = v;
  }
};

// The masked Gaussian lnL terms of the convolved model, summed in
// float64 per thread (conv_lnl.cu's lnl_kernel, element for element).
struct LnlSum {
  const float* mvar;  // (H, W), shared memory
  const float* obs;
  const float* obs_var;
  const float* good;
  int w;
  double s;
  __device__ __forceinline__ void operator()(int r, int col, float conv) {
    const int p = r * w + col;
    const float ivm = 1.0f / (mvar[p] + obs_var[p]);
    const float resid = obs[p] - conv;
    const bool g = good[p] > 0.0f;
    const float safe_ivm = g ? ivm : 1.0f;
    const float term = resid * resid * ivm - logf(kInv2Pi * safe_ivm);
    if (g) s += (double)(-0.5f * term);
  }
};

// C (M x N) = sum over terms of alpha A @ B, handed to `epi` element by
// element.  Warp w owns rows m0 + 8w .. m0 + 8w + 7 of a pass, lane l the
// columns n0 + l + 32j, j < TN.  Out-of-range rows and columns read a
// clamped (valid) address and are dropped at the epilogue, so the k loop
// has no branches.  The caller synchronises the block around it.
template <int TN, bool SQUARE_A, int NTERMS, class Epilogue>
__device__ __forceinline__ void block_gemm(const Term (&terms)[NTERMS], int m,
                                           int n, int k, Epilogue& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m0 = 0; m0 < m; m0 += kWarps * kTM) {
    const int row0 = m0 + warp * kTM;
    if (row0 >= m) continue;
    int rows[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) rows[i] = min(row0 + i, m - 1);
    for (int n0 = 0; n0 < n; n0 += 32 * TN) {
      int cols[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) cols[j] = min(n0 + lane + 32 * j, n - 1);
      float acc[kTM][TN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
      for (int t = 0; t < NTERMS; ++t) {
        const Term tm = terms[t];
        for (int kk = 0; kk < k; ++kk) {
          float av[kTM], bv[TN];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            float v = tm.a[rows[i] * tm.lda + kk];
            if (SQUARE_A) v = v * v;
            av[i] = tm.alpha * v;
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = tm.b[kk * tm.ldb + cols[j]];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        if (row0 + i >= m) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + lane + 32 * j;
          if (col < n) epi(row0 + i, col, acc[i][j]);
        }
      }
    }
  }
}

// S4 of one convolution: t1 <- LI @ ((LF @ (x[^2] @ [cw | -sw])) * K).
// x is (H, W); t1 and t2 are (2H, W2) as [real rows; imaginary rows].
// t2 may be x's buffer: x is dead after the first stage.
template <bool SQUARE>
__device__ void half_spectrum_conv(const float* x, float* t1, float* t2,
                                   const float* kr, const float* ki,
                                   const Args& a) {
  const int h = a.h, w = a.w, w2 = w / 2 + 1, slab = h * w2;
  {
    const Term re[1] = {{x, w, a.cw, w2, 1.0f}};
    Store st{t1, w2};
    block_gemm<3, SQUARE>(re, h, w2, w, st);
    const Term im[1] = {{x, w, a.sw, w2, -1.0f}};
    Store si{t1 + slab, w2};
    block_gemm<3, SQUARE>(im, h, w2, w, si);
  }
  __syncthreads();
  {
    const Term fwd[1] = {{a.lf, 2 * h, t1, w2, 1.0f}};
    Store st{t2, w2};
    block_gemm<3, false>(fwd, 2 * h, w2, 2 * h, st);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < slab; e += kThreads) {
    const float r = t2[e], i = t2[slab + e], kre = kr[e], kim = ki[e];
    t2[e] = r * kre - i * kim;
    t2[slab + e] = r * kim + i * kre;
  }
  __syncthreads();
  {
    const Term inv[1] = {{a.li, 2 * h, t2, w2, 1.0f}};
    Store st{t1, w2};
    block_gemm<3, false>(inv, 2 * h, w2, 2 * h, st);
  }
  __syncthreads();
}

// raw = sky + Sersics (SersicSet: the render kernel's bits) + point
// sources, the latter summed among themselves first, as the plain version
// adds its point-source image; each pixel is handed to put(y, x, value).
// The block's threads lie over the image as `lanes` (a power of two, at
// most a warp) along x and THREADS / lanes rows, so no index is divided; a
// thread renders N pixels of a row side by side, `lanes` apart, so that a
// warp reads kx and writes the image at consecutive addresses.
template <int S, int N, int THREADS, class Put>
__device__ __forceinline__ void render_walker(const float* rows, int s_n,
                                              float sky, const float* fky,
                                              const float* kx, int p_n, int h,
                                              int w, Put& put) {
  const int runs = (w + N - 1) / N;
  const int lanes_log2 = runs <= 1 ? 0 : min(5, 32 - __clz(runs - 1));
  const int tx = threadIdx.x & ((1 << lanes_log2) - 1);
  const int ty = threadIdx.x >> lanes_log2;
  psfmc::SersicSet<S, false> sersics;
  sersics.load(rows, s_n);
  for (int yi = ty; yi < h; yi += THREADS >> lanes_log2) {
    sersics.set_row((float)yi);
    for (int x0 = tx; x0 < w; x0 += N << lanes_log2) {
      float xg[N], acc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) xg[i] = (float)(x0 + (i << lanes_log2));
      sersics.render(sky, xg, acc);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int xi = x0 + (i << lanes_log2);
        if (xi >= w) continue;
        if (p_n > 0) {
          float ps = 0.0f;
          for (int q = 0; q < p_n; ++q)
            ps = __fadd_rn(ps, __fmul_rn(fky[q * h + yi], kx[q * w + xi]));
          acc[i] = __fadd_rn(acc[i], ps);
        }
        put(yi, xi, acc[i]);
      }
    }
  }
}

// The same with the Sersic count a compile-time constant where it is 1, 2
// or 3.  Their chains are then unrolled together and a thread takes
// kFixedRun = 1 pixel at a time: with the four warps a scheduler has here,
// more pixels side by side were measured slower (chip_smoke.py --profile
// builds this file with -DPSFMC_FUSED_RUN=2 and =4 as well and prints the
// phase's cycles for each; eight pixels spill registers).  Any other count
// walks its Sersics in a loop and takes four pixels at a time.
#ifndef PSFMC_FUSED_RUN
#define PSFMC_FUSED_RUN 1
#endif
constexpr int kFixedRun = PSFMC_FUSED_RUN;

template <int THREADS, class Put>
__device__ __forceinline__ void render_raw(const float* rows, int s_n, float sky,
                                           const float* fky, const float* kx,
                                           int p_n, int h, int w, Put& put) {
  switch (s_n) {
    case 1: render_walker<1, kFixedRun, THREADS>(rows, s_n, sky, fky, kx, p_n, h, w, put); break;
    case 2: render_walker<2, kFixedRun, THREADS>(rows, s_n, sky, fky, kx, p_n, h, w, put); break;
    case 3: render_walker<3, kFixedRun, THREADS>(rows, s_n, sky, fky, kx, p_n, h, w, put); break;
    default: render_walker<0, 4, THREADS>(rows, s_n, sky, fky, kx, p_n, h, w, put); break;
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_lnl_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ double partial[kWarps];
  const int h = a.h, w = a.w, w2 = w / 2 + 1, slab = h * w2;
  const int s_n = a.num_sersic, p_n = a.num_ps;
  const int b = blockIdx.x;
  float* X = smem;
  float* Y = X + 2 * slab;
  float* Z = Y + 2 * slab;
  float* rows = Z + 2 * slab;           // S x 9 packed Sersic rows
  float* fky = rows + s_n * psfmc::kParamsPerSersic;  // P x H
  float* kx = fky + p_n * h;            // P x W

  const int row_len = s_n * psfmc::kParamsPerSersic;
  for (int t = threadIdx.x; t < row_len; t += kThreads)
    rows[t] = a.packed[(size_t)b * row_len + t];
  for (int t = threadIdx.x; t < p_n * h; t += kThreads)
    fky[t] = a.fky[(size_t)b * p_n * h + t];
  for (int t = threadIdx.x; t < p_n * w; t += kThreads)
    kx[t] = a.kx[(size_t)b * p_n * w + t];
  const float sky = a.sky[b];
  __syncthreads();

  auto put = [X, w](int yi, int xi, float v) { X[yi * w + xi] = v; };
  render_raw<kThreads>(rows, s_n, sky, fky, kx, p_n, h, w, put);
  __syncthreads();

  // variance convolution: S4 in Y, then mvar = S4r @ ica - S4i @ isa -> Z
  half_spectrum_conv<true>(X, Y, Z, a.var_r, a.var_i, a);
  {
    const Term out[2] = {{Y, w2, a.ica, w, 1.0f}, {Y + slab, w2, a.isa, w, -1.0f}};
    Store st{Z, w};
    block_gemm<4, false>(out, h, w, w2, st);
  }
  __syncthreads();

  // PSF convolution: S4 in Y (X is reused as scratch), then the last
  // product straight into the lnL terms
  half_spectrum_conv<false>(X, Y, X, a.psf_r, a.psf_i, a);
  LnlSum lnl{Z, a.obs, a.obs_var, a.good, w, 0.0};
  {
    const Term out[2] = {{Y, w2, a.ica, w, 1.0f}, {Y + slab, w2, a.isa, w, -1.0f}};
    block_gemm<4, false>(out, h, w, w2, lnl);
  }

  double s = lnl.s;
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < kWarps; ++i) tot += partial[i];
    const float r = (float)tot;
    a.out[b] = isfinite(r) ? r : -INFINITY;
  }
}

size_t smem_bytes(int h, int w, int num_sersic, int num_ps) {
  const size_t slab = (size_t)h * (w / 2 + 1);
  return sizeof(float) * (3 * 2 * slab + (size_t)num_sersic * psfmc::kParamsPerSersic +
                          (size_t)num_ps * (h + w));
}

}  // namespace

// C interface (loaded with ctypes).  All pointers are float32 device
// memory.  Launches on `stream` and returns the first nonzero cudaError of
// the attribute call or the launch, or 0.
extern "C" int fused_lnl_launch(
    const float* packed, const float* sky, const float* fky, const float* kx,
    int batch, int num_sersic, int num_ps, int h, int w,
    const float* cw, const float* sw, const float* lf, const float* li,
    const float* ica, const float* isa,
    const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* out, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = smem_bytes(h, w, num_sersic, num_ps);
  cudaError_t err = cudaFuncSetAttribute(
      fused_lnl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  Args a{packed, sky, fky, kx, num_sersic, num_ps, h, w,
         cw, sw, lf, li, ica, isa, psf_r, psf_i, var_r, var_i,
         obs, obs_var, good, out};
  fused_lnl_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

namespace {

namespace fc = psfmc::fftconv;

struct FftArgs {
  const float* packed;  // (B, S, 9)
  const float* sky;     // (B,)
  const float* fky;     // (B, P, H)
  const float* kx;      // (B, P, W)
  int num_sersic, num_ps, h, w;
  const float2* twiddle;  // (max(H, W) / 2,)
  int tw_log2;
  fc::Spectra k;
  fc::Data d;
  float* out;  // (B,)
};

// FFT route: render into the real parts of the float2 image, then
// fft_conv.cuh.  The render is the matmul-DFT route's (render_raw); a
// warp's 4-byte stores of consecutive real parts land on the 16 even banks,
// two lanes each, which is the least such stores can do.
__global__ void __launch_bounds__(fc::kThreads, 1) fused_lnl_fft_kernel(FftArgs a) {
  extern __shared__ __align__(16) unsigned char smem_fft[];
  const int h = a.h, w = a.w, ld = fc::pitch(w);
  const int s_n = a.num_sersic, p_n = a.num_ps;
  const int b = blockIdx.x;
  float2* z = reinterpret_cast<float2*>(smem_fft);
  float2* tw = z + h * ld;
  float* rows = reinterpret_cast<float*>(tw + (1 << a.tw_log2) / 2);  // S x 9
  float* fky = rows + s_n * psfmc::kParamsPerSersic;                  // P x H
  float* kx = fky + p_n * h;                                          // P x W

  PSFMC_STAMP(0);
  fc::load_twiddles(tw, a.twiddle, a.tw_log2);
  const int row_len = s_n * psfmc::kParamsPerSersic;
  for (int t = threadIdx.x; t < row_len; t += fc::kThreads)
    rows[t] = a.packed[(size_t)b * row_len + t];
  for (int t = threadIdx.x; t < p_n * h; t += fc::kThreads)
    fky[t] = a.fky[(size_t)b * p_n * h + t];
  for (int t = threadIdx.x; t < p_n * w; t += fc::kThreads)
    kx[t] = a.kx[(size_t)b * p_n * w + t];
  const float sky = a.sky[b];
  __syncthreads();

  float mx = 0.0f;
  auto put = [z, ld, &mx](int yi, int xi, float v) {
    z[yi * ld + xi].x = v;
    mx = fmaxf(mx, fabsf(v));
  };
  render_raw<fc::kThreads>(rows, s_n, sky, fky, kx, p_n, h, w, put);
  PSFMC_STAMP(1);
  fc::convolve_and_reduce(z, h, w, tw, a.tw_log2, mx, a.k, a.d, a.out + b);
}

}  // namespace

// C interface of the FFT route.  h and w are powers of two; twiddle is
// the (max(h, w) / 2, 2) float32 table of exp(-2 pi i k / max(h, w)),
// var_gain one float, the power of two applied to the variance spectrum.
// Launches on `stream` and returns the first nonzero cudaError of the
// attribute call or the launch, or 0.
extern "C" int fused_lnl_fft_launch(
    const float* packed, const float* sky, const float* fky, const float* kx,
    int batch, int num_sersic, int num_ps, int h, int w, const float* twiddle,
    const float* var_gain, const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* out, void* stream) {
  if (batch <= 0) return 0;
  if (!fc::power_of_two(h) || !fc::power_of_two(w))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      fc::image_bytes(h, w) +
      sizeof(float) * ((size_t)num_sersic * psfmc::kParamsPerSersic +
                       (size_t)num_ps * (h + w));
  cudaError_t err = cudaFuncSetAttribute(
      fused_lnl_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  int tw_log2 = 0;
  while ((1 << tw_log2) < (h > w ? h : w)) ++tw_log2;
  FftArgs a{packed, sky, fky, kx, num_sersic, num_ps, h, w,
            reinterpret_cast<const float2*>(twiddle), tw_log2,
            fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain},
            fc::Data{obs, obs_var, good}, out};
  fused_lnl_fft_kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
