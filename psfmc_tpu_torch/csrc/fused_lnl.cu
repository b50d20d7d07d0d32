// Fused render + PSF convolution + masked Gaussian log-likelihood, one
// walker per block or per cluster of blocks (Hopper, sm_90a).
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
// where (*) is the circular convolution with the trailing ifftshift; on the
// matmul-DFT route written as the real half-spectrum products of
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
// The routes of conv_lnl.cu, chosen by the wrapper from the shape alone
// (conv_route in psfmc_tpu_torch/ops/kernels/conv_lnl.py; fused_route is
// the same rule), each 512 threads a block, the only write to global
// memory the walker's lnL but on the global route.  On the first three
// the render goes into the real parts of the walker's complex image in
// shared memory and the rest is conv_lnl's, unchanged:
// fft_conv.cuh's convolve_and_reduce (both
// convolutions as one complex FFT pair, then the lnL readout) or
// fft_cluster.cuh's cluster_convolve_and_reduce:
//
// FFT route (H and W even with no prime factor above 7, the walker fits a
// block; fused_lnl_fft_launch): one block a walker, radix-2 stages for
// powers of two (Pow2Geom), radix 2, 3, 5 and 7 otherwise (MixedGeom,
// whose image is in natural order until the forward passes run, so the
// render writes pixel (y, x) at row y, column x of the pitch W + 1).
//
// Padded route (a side that is odd or has a prime factor above 7, the
// transform padded_shape fits a block; fused_lnl_padded_launch): the same
// on PaddedGeom; the block writes zeros into both parts of every slot of
// the transform outside the image (shared memory is not initialised).
//
// Cluster route (the transform fits no block but a cluster of C = 2, 4 or
// 8; fused_lnl_cluster_launch): one cluster a walker.  Each rank zeroes
// the slots of its rows of the transform outside the image, a cluster
// barrier (every block has started), then renders the image rows its
// readout owns, [r Hc, r Hc + Hc) with Hc = ceil(H / C), into whichever
// rank holds each row: the ranks share the render evenly even where the
// image lies in rank 0's rows (94x94 in a 192x192 transform).
//
// Global route (the transforms no cluster of 8 holds: 512x512, 640x640,
// 251x251 -> 504x504; fused_lnl_global_launch): a render pass, a block a
// tile of the row passes' rows (fft_global.cuh's rows), writes the raw
// rows to a scratch the wrapper allocates and each tile's peak; then
// conv_lnl's global launches 2-5 from them.  The render runs once: a
// render inside the row pass would need the walker's peak first, so a
// second render or a pass of its own.
//
// matmul-DFT route (what no other route holds: a side of 1;
// fused_lnl_launch): the products above, 2 convolutions x 2 x
// (2*128*128*65 + 2*256*256*65 + 2*128*65*128) ~ 51 MFLOP per walker at
// 128x128 (W2 = 65), 20x the FFT count.
//
// The render phase of every route (render_raw) is sersic_profile.cuh's
// SersicSet, the render kernel's code: the walker's and the row's constant
// terms are hoisted, the threads lie over the image in two dimensions so
// that no index is divided per pixel, and the chains of a walker's (one to
// three) Sersics are unrolled side by side.  With one block of 16 warps on
// an SM the phase is bound by the schedulers' rate, some 70 instructions
// per profile evaluation, not by the chain's latency.  On the FFT, padded
// and cluster routes the walker's scalars (packed Sersic rows, fky, kx)
// are read through the read-only cache, so that the kernel's shared memory
// is conv_lnl's and the two share their route rule; the matmul-DFT route
// copies them into shared memory beside its buffers.
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

#include "fft_cluster.cuh"
#include "fft_conv.cuh"
#include "fft_global.cuh"
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

// A float of the walker's scalars: through the read-only cache from global
// memory (GLOBAL) or from shared memory.
template <bool GLOBAL>
__device__ __forceinline__ float scalar(const float* p) {
  if constexpr (GLOBAL) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// raw = sky + Sersics (SersicSet: the render kernel's bits) + point
// sources, the latter summed among themselves first, as the plain version
// adds its point-source image, on the image rows [y0, y1); each pixel is
// handed to put(y, x, value).  The block's threads lie over the rows as
// `lanes` (a power of two, at most a warp) along x and THREADS / lanes
// rows, so no index is divided; a thread renders N pixels of a row side by
// side, `lanes` apart, so that a warp reads kx and writes the image at
// consecutive addresses.  rows, fky and kx are in global memory (GLOBAL)
// or in shared memory.
template <int S, int N, int THREADS, bool GLOBAL, class Put>
__device__ __forceinline__ void render_walker(const float* rows, int s_n,
                                              float sky, const float* fky,
                                              const float* kx, int p_n, int h,
                                              int w, int y0, int y1, Put& put) {
  const int runs = (w + N - 1) / N;
  const int lanes_log2 = runs <= 1 ? 0 : min(5, 32 - __clz(runs - 1));
  const int tx = threadIdx.x & ((1 << lanes_log2) - 1);
  const int ty = threadIdx.x >> lanes_log2;
  psfmc::SersicSet<S, GLOBAL> sersics;
  sersics.load(rows, s_n);
  for (int yi = y0 + ty; yi < y1; yi += THREADS >> lanes_log2) {
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
            ps = __fadd_rn(ps, __fmul_rn(scalar<GLOBAL>(fky + q * h + yi),
                                         scalar<GLOBAL>(kx + q * w + xi)));
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

template <int THREADS, bool GLOBAL, class Put>
__device__ __forceinline__ void render_raw(const float* rows, int s_n, float sky,
                                           const float* fky, const float* kx,
                                           int p_n, int h, int w, int y0, int y1,
                                           Put& put) {
  switch (s_n) {
    case 1: render_walker<1, kFixedRun, THREADS, GLOBAL>(rows, s_n, sky, fky, kx, p_n, h, w, y0, y1, put); break;
    case 2: render_walker<2, kFixedRun, THREADS, GLOBAL>(rows, s_n, sky, fky, kx, p_n, h, w, y0, y1, put); break;
    case 3: render_walker<3, kFixedRun, THREADS, GLOBAL>(rows, s_n, sky, fky, kx, p_n, h, w, y0, y1, put); break;
    default: render_walker<0, 4, THREADS, GLOBAL>(rows, s_n, sky, fky, kx, p_n, h, w, y0, y1, put); break;
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
  render_raw<kThreads, false>(rows, s_n, sky, fky, kx, p_n, h, w, 0, h, put);
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

// The FFT, padded and cluster routes' arguments: the walkers' scalars, the
// image (h, w) and its transform (mh, mw: the image's own sides on the FFT
// route), the cluster's size (1 off the cluster route), and conv_lnl's
// tables, spectra and data at those sides.
struct FusedArgs {
  const float* packed;  // (B, S, 9)
  const float* sky;     // (B,)
  const float* fky;     // (B, P, H)
  const float* kx;      // (B, P, W)
  int num_sersic, num_ps, h, w, mh, mw, ranks;
  const float2* twiddle;
  int tw_log2;
  const int* layout;
  fc::Spectra k;
  fc::Data d;
  float* out;  // (B,)
};

// Walker b's image rows [y0, y1) rendered into the real parts of the slots
// slot(y, x) points at, its scalars read through the read-only cache;
// returns the largest |raw| this thread wrote.
template <class Slot>
__device__ __forceinline__ float render_rows(const FusedArgs& a, int b, int y0, int y1,
                                             Slot slot) {
  const int s_n = a.num_sersic, p_n = a.num_ps;
  float mx = 0.0f;
  auto put = [&slot, &mx](int yi, int xi, float v) {
    slot(yi, xi)->x = v;
    mx = fmaxf(mx, fabsf(v));
  };
  render_raw<fc::kThreads, true>(a.packed + (size_t)b * s_n * psfmc::kParamsPerSersic,
                                 s_n, __ldg(a.sky + b), a.fky + (size_t)b * p_n * a.h,
                                 a.kx + (size_t)b * p_n * a.w, p_n, a.h, a.w, y0, y1,
                                 put);
  return mx;
}

// One block a walker on the geometry g, whose image rows lie ld float2
// apart from z: the render (a warp's 4-byte stores of consecutive real
// parts land on the 16 even banks, two lanes each, the least such stores
// can do), then conv_lnl's convolutions and readout.
template <class Geom>
__device__ __forceinline__ void render_and_reduce(float2* z, const Geom& g, int ld,
                                                  const FusedArgs& a) {
  const int b = blockIdx.x;
  const float mx = render_rows(a, b, 0, a.h, [z, ld](int y, int x) { return z + y * ld + x; });
  PSFMC_STAMP(1);
  fc::convolve_and_reduce(z, g, mx, a.k, a.d, a.out + b);
}

// FFT route: the image's own sides, radix 2 (Pow2Geom) or mixed radix.
template <bool MIXED>
__global__ void __launch_bounds__(fc::kThreads, 1) fused_lnl_fft_kernel(FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_fft[];
  float2* z = reinterpret_cast<float2*>(smem_fft);
  float2* tw = z + a.h * fc::pitch(a.w);
  PSFMC_STAMP(0);
  if constexpr (MIXED) {
    const fc::MixedGeom g = fc::load_mixed(tw, a.twiddle, a.layout, a.h, a.w);
    render_and_reduce(z, g, g.ld, a);
  } else {
    fc::load_twiddles(tw, a.twiddle, a.tw_log2);
    const fc::Pow2Geom g(a.h, a.w, tw, a.tw_log2);
    render_and_reduce(z, g, g.ld, a);
  }
}

// Zeros into both parts of every slot of the transform outside the image
// (load_image(PaddedGeom)'s), which the render does not write.
template <class Inner>
__device__ __forceinline__ void zero_pad(float2* z, const fc::PaddedGeom<Inner>& g) {
  const int mw = g.t.w;
  const fc::FastDiv by_mw(mw);
  for (int q = threadIdx.x; q < g.t.h * mw; q += fc::kThreads) {
    const int y = by_mw.div(q), x = q - y * mw;
    if (y >= g.h || x >= g.w) z[y * g.t.ld + x] = make_float2(0.0f, 0.0f);
  }
}

// Padded route: the image (h, w) in the corner of the transform (mh, mw).
template <bool MIXED>
__global__ void __launch_bounds__(fc::kThreads, 1) fused_lnl_padded_kernel(FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_fft[];
  float2* z = reinterpret_cast<float2*>(smem_fft);
  float2* tw = z + a.mh * fc::pitch(a.mw);
  PSFMC_STAMP(0);
  if constexpr (MIXED) {
    using Geom = fc::PaddedGeom<fc::MixedGeom>;
    const Geom g(a.h, a.w, fc::load_mixed(tw, a.twiddle, a.layout, a.mh, a.mw));
    zero_pad(z, g);
    render_and_reduce(z, g, g.t.ld, a);
  } else {
    using Geom = fc::PaddedGeom<fc::Pow2Geom>;
    fc::load_twiddles(tw, a.twiddle, a.tw_log2);
    const Geom g(a.h, a.w, fc::Pow2Geom(a.mh, a.mw, tw, a.tw_log2));
    zero_pad(z, g);
    render_and_reduce(z, g, g.t.ld, a);
  }
}

// Cluster route: one cluster of a.ranks blocks a walker (fft_cluster.cuh).
// Each rank zeroes its rows' slots outside the image; after a cluster
// barrier (every block has started, so a peer's shared memory may be
// written) it renders the image rows its readout owns into whichever rank
// holds each; cluster_convolve_and_reduce's first cluster barrier makes
// those stores visible before the pack.
__global__ void __launch_bounds__(fc::kThreads, 1) fused_lnl_cluster_kernel(FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_fft[];
  const int walker = blockIdx.x / a.ranks;
  const fc::ClusterGeom g =
      fc::load_cluster(smem_fft, a.h, a.w, a.mh, a.mw, a.ranks, a.twiddle, a.layout);
  const fc::FastDiv by_mw(g.mw);
  for (int q = threadIdx.x; q < g.nrows * g.mw; q += fc::kThreads) {
    const int ly = by_mw.div(q), x = q - ly * g.mw;
    if (g.row0 + ly >= g.h || x >= g.w) g.z[ly * g.ld + x] = make_float2(0.0f, 0.0f);
  }
  fc::cg::this_cluster().sync();
  const float mx = render_rows(a, walker, g.img0, g.img0 + g.nimg,
                               [&g](int y, int x) { return g.at(y, x); });
  fc::cluster_convolve_and_reduce<false>(g, mx, a.k, a.d, a.out + walker, nullptr,
                                         nullptr);
}

// Global route, its render pass: the block of tile t renders walker b's
// image rows [t R, t R + R) (R = rows, the row passes' tile) into the raw
// scratch raws (B, H, W), which the global route's row passes read, and the
// tile's largest |raw| into peaks (B, ceil(H / R)), from which every block
// of the walker takes the squared image's scale.  The render is
// sersic_profile.cuh's, as on the other routes (the same bits as the render
// kernel's).
__global__ void __launch_bounds__(fc::kThreads)
fused_lnl_global_render_kernel(FusedArgs a, psfmc::fftglobal::Plan p, float* __restrict__ raws,
                               float* __restrict__ peaks) {
  const int b = blockIdx.x, t = blockIdx.y, w = a.w;
  const int y0 = t * p.rows, y1 = min(y0 + p.rows, a.h);
  float* raw = raws + (size_t)b * a.h * w;
  float mx = 0.0f;
  auto put = [raw, w, &mx](int yi, int xi, float v) {
    raw[yi * w + xi] = v;
    mx = fmaxf(mx, fabsf(v));
  };
  const int s_n = a.num_sersic, p_n = a.num_ps;
  render_raw<fc::kThreads, true>(a.packed + (size_t)b * s_n * psfmc::kParamsPerSersic, s_n,
                                 __ldg(a.sky + b), a.fky + (size_t)b * p_n * a.h,
                                 a.kx + (size_t)b * p_n * w, p_n, a.h, w, y0, y1, put);
  mx = psfmc::fftglobal::block_max(mx);
  if (threadIdx.x == 0) peaks[(size_t)b * p.row_tiles() + t] = mx;
}

FusedArgs fused_args(const float* packed, const float* sky, const float* fky,
                     const float* kx, int num_sersic, int num_ps, int h, int w, int mh,
                     int mw, int ranks, const float* twiddle, const int* layout,
                     int tw_log2, const float* var_gain, const float* psf_r,
                     const float* psf_i, const float* var_r, const float* var_i,
                     const float* obs, const float* obs_var, const float* good,
                     float* out) {
  return FusedArgs{packed, sky, fky, kx, num_sersic, num_ps, h, w, mh, mw, ranks,
                   reinterpret_cast<const float2*>(twiddle), tw_log2, layout,
                   fc::Spectra{psf_r, psf_i, var_r, var_i, var_gain},
                   fc::Data{obs, obs_var, good}, out};
}

}  // namespace

// C interface of the FFT route: h and w both powers of two, or both even
// with no prime factor above 7; twiddle, layout, var_gain and the four
// spectrum planes as conv_lnl_fft_launch takes them (conv_lnl.py's
// CONV_FFT_CONST_ARGS: fft_tables(shape), the layout not read for powers of
// two), one observation and one PSF.  Launches batch blocks on `stream` and
// returns the first nonzero cudaError of the shape check, the attribute
// call or the launch, or 0.
extern "C" int fused_lnl_fft_launch(
    const float* packed, const float* sky, const float* fky, const float* kx,
    int batch, int num_sersic, int num_ps, int h, int w, const float* twiddle,
    const int* layout, const float* var_gain, const float* psf_r,
    const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* out, void* stream) {
  if (batch <= 0) return 0;
  auto kernel = &fused_lnl_fft_kernel<false>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_fft(&fused_lnl_fft_kernel<false>, &fused_lnl_fft_kernel<true>,
                                h, w, &kernel, &smem, &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      fused_args(packed, sky, fky, kx, num_sersic, num_ps, h, w, h, w, 1, twiddle, layout,
                 tw_log2, var_gain, psf_r, psf_i, var_r, var_i, obs, obs_var, good, out));
  return (int)cudaGetLastError();
}

// C interface of the padded route: fused_lnl_fft_launch's arguments with the
// transform's sides (mh, mw) after the image's, and the tables and spectra
// at the transform's sides (conv_lnl.py's PADDED_CONST_ARGS).  A shape the
// host would not plan (padded_plan) is refused with cudaErrorInvalidValue.
extern "C" int fused_lnl_padded_launch(
    const float* packed, const float* sky, const float* fky, const float* kx,
    int batch, int num_sersic, int num_ps, int h, int w, int mh, int mw,
    const float* twiddle, const int* layout, const float* var_gain,
    const float* psf_r, const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good, float* out,
    void* stream) {
  if (batch <= 0) return 0;
  if (!fc::padded_plan(h, w, mh, mw)) return (int)cudaErrorInvalidValue;
  auto kernel = &fused_lnl_padded_kernel<false>;
  size_t smem;
  int tw_log2;
  if (int err = fc::prepare_geometry(&fused_lnl_padded_kernel<false>,
                                     &fused_lnl_padded_kernel<true>, mh, mw, &kernel,
                                     &smem, &tw_log2))
    return err;
  kernel<<<batch, fc::kThreads, smem, (cudaStream_t)stream>>>(
      fused_args(packed, sky, fky, kx, num_sersic, num_ps, h, w, mh, mw, 1, twiddle,
                 layout, tw_log2, var_gain, psf_r, psf_i, var_r, var_i, obs, obs_var,
                 good, out));
  return (int)cudaGetLastError();
}

// C interface of the cluster route: fused_lnl_padded_launch's arguments with
// the cluster's size `ranks` (2, 4 or 8; conv_lnl.py's cluster_size) after
// the transform's sides (padded_shape), twiddle and layout the mixed-radix
// tables of the transform (cluster_tables).  Launches batch x ranks blocks
// on `stream` and returns 0, the cudaError of the attribute call or the
// launch, cudaErrorInvalidValue for a shape the host would not plan, or -1
// where the launch was refused because no such cluster can be scheduled on
// the card.
extern "C" int fused_lnl_cluster_launch(
    const float* packed, const float* sky, const float* fky, const float* kx,
    int batch, int num_sersic, int num_ps, int h, int w, int mh, int mw, int ranks,
    const float* twiddle, const int* layout, const float* var_gain,
    const float* psf_r, const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good, float* out,
    void* stream) {
  if (batch <= 0) return 0;
  if (h < 2 || w < 2 || mh != fc::transform_side(h) || mw != fc::transform_side(w))
    return (int)cudaErrorInvalidValue;
  return fc::launch_cluster(
      &fused_lnl_cluster_kernel, batch, ranks, fc::cluster_image_bytes(mh, mw, ranks),
      (cudaStream_t)stream,
      fused_args(packed, sky, fky, kx, num_sersic, num_ps, h, w, mh, mw, ranks, twiddle,
                 layout, 0, var_gain, psf_r, psf_i, var_r, var_i, obs, obs_var, good,
                 out));
}

// C interface of the global route (the transforms no cluster of 8 holds):
// fused_lnl_padded_launch's arguments with a tile's rows and a column
// group's bins (rows, cols: conv_lnl.py's global_tiles) after the
// transform's sides, twiddle and layout the transform's mixed-radix tables
// (cluster_tables), then the scratch the wrapper allocates: raws (B, H, W)
// float32, S (B, H, mw, 2) float32, peaks (B, ceil(H / rows)) float32 and
// partials (B, ceil(H / rows)) float64.  The render pass, then conv_lnl's
// global launches 2-5 (fft_global.cuh).  Returns 0, the first cudaError of
// the attribute calls or the launches, or cudaErrorInvalidValue for a plan
// the host would not make.
extern "C" int fused_lnl_global_launch(
    const float* packed, const float* sky, const float* fky, const float* kx,
    int batch, int num_sersic, int num_ps, int h, int w, int mh, int mw, int rows, int cols,
    const float* twiddle, const int* layout, const float* var_gain,
    const float* psf_r, const float* psf_i, const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good, float* raws, float* scratch,
    float* peaks, double* partials, float* out, void* stream) {
  namespace fg = psfmc::fftglobal;
  if (batch <= 0) return 0;
  const fg::Plan p{h, w, mh, mw, rows, cols};
  if (!fg::plan_ok(p)) return (int)cudaErrorInvalidValue;
  const FusedArgs a = fused_args(packed, sky, fky, kx, num_sersic, num_ps, h, w, mh, mw, 1,
                                 twiddle, layout, 0, var_gain, psf_r, psf_i, var_r, var_i,
                                 obs, obs_var, good, out);
  fused_lnl_global_render_kernel<<<dim3((unsigned)batch, (unsigned)p.row_tiles()), fc::kThreads,
                                   0, (cudaStream_t)stream>>>(a, p, raws, peaks);
  if (int err = (int)cudaGetLastError()) return err;
  return fg::launch_forward<false>(raws, true, batch, p, a.twiddle, layout, a.k, a.d, 1, 0, 0,
                                   reinterpret_cast<float2*>(scratch), peaks, partials, nullptr,
                                   out, nullptr, nullptr, (cudaStream_t)stream);
}
