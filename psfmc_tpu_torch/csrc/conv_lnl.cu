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
// What bounds it on the H100: arithmetic.  At 128x128 (W2 = 65) the
// products are 2 convolutions x 12 x 2*128*128*65 ~ 51 MFLOP per walker,
// ~6.4 GFLOP for a 125-walker half-ensemble, ~0.1 ms at the 67 TFLOP/s
// fp32 (non-tensor-core) peak, against 8 MB of images read (~2.5 us).
//
// Design (first version: simple and right): one strided, batched,
// shared-memory-tiled fp32 FMA GEMM kernel (64x64 output tile, 16-deep
// k slices, 4x4 outputs per thread, walkers on gridDim.z) runs every
// product; the squared image of the variance convolution is formed as A
// is loaded, and the forward and inverse h-direction stages are single
// products with the 2x2 block real operators.  Intermediates live in
// global scratch that the caller allocates; a complex-multiply kernel and
// a per-walker reduction kernel (one block per walker, float64
// accumulation) finish the job.  No TF32 and no tensor cores: fp32 is the
// contract (TF32's 10-bit mantissa collapses the sampler's acceptance,
// as single-pass bf16 did on the TPU).  Not done yet: keeping a walker's
// intermediates on chip, tensor-core 3xTF32 products, a W2 tile that
// does not waste half of the last 64-column tile.
//
// Numerics: no --use_fast_math and no __logf: logf and the division are
// IEEE-accurate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kThreads = 256;
constexpr float kInv2Pi = 0.15915494309189535f;

struct Gemm {
  const float* a;
  long long a_batch;
  int lda;
  const float* b;
  long long b_batch;
  int ldb;
  float* c;
  long long c_batch;
  int ldc;
  int m, n, k;
  float alpha;
  int accumulate;  // C += alpha A B instead of C = alpha A B
  int square_a;    // use A*A (elementwise) in place of A
};

// C[z] (m x n) = alpha * A[z] (m x k) @ B[z] (k x n), all row-major with
// the given leading dimensions; z = blockIdx.z, batch strides may be 0.
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(Gemm g) {
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN];
  const long long z = blockIdx.z;
  const float* A = g.a + z * g.a_batch;
  const float* B = g.b + z * g.b_batch;
  float* C = g.c + z * g.c_batch;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < g.k; k0 += BK) {
    for (int l = tid; l < BM * BK; l += kGemmThreads) {
      const int mm = l / BK, kk = l % BK;
      const int gi = m0 + mm, gk = k0 + kk;
      float v = 0.0f;
      if (gi < g.m && gk < g.k) {
        v = A[(long long)gi * g.lda + gk];
        if (g.square_a) v = v * v;
      }
      as[kk][mm] = v;
    }
    for (int l = tid; l < BK * BN; l += kGemmThreads) {
      const int kk = l / BN, nn = l % BN;
      const int gk = k0 + kk, gj = n0 + nn;
      bs[kk][nn] = (gk < g.k && gj < g.n) ? B[(long long)gk * g.ldb + gj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = m0 + ty + i * (BM / TM);
    if (gi >= g.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = n0 + tx + j * (BN / TN);
      if (gj >= g.n) continue;
      float* dst = C + (long long)gi * g.ldc + gj;
      const float r = g.alpha * acc[i][j];
      *dst = g.accumulate ? *dst + r : r;
    }
  }
}

// In place: t[z] = [re; im] (2, hw2) times the half spectrum kr + i ki.
__global__ void cmul_kernel(float* t, const float* __restrict__ kr,
                            const float* __restrict__ ki, int batch, int hw2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * hw2) return;
  const long long z = idx / hw2;
  const int e = (int)(idx % hw2);
  float* re = t + z * 2 * hw2 + e;
  float* im = re + hw2;
  const float r = *re, i = *im, a = kr[e], c = ki[e];
  *re = r * a - i * c;
  *im = r * c + i * a;
}

// One block per walker: the masked Gaussian lnL of conv/mvar against obs.
__global__ void __launch_bounds__(kThreads)
lnl_kernel(const float* __restrict__ conv, const float* __restrict__ mvar,
           const float* __restrict__ obs, const float* __restrict__ obs_var,
           const float* __restrict__ good, float* __restrict__ out, int hw) {
  __shared__ double partial[kThreads / 32];
  const long long base = (long long)blockIdx.x * hw;
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

int run_gemm(Gemm g, int batch, cudaStream_t stream) {
  dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, batch);
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// One circular convolution of every walker's image (squared if
// `square`) with the half spectrum (kr, ki); result into dst (B, H, W).
int convolve(const float* x, int square, int batch, int h, int w,
             const float* cw, const float* sw, const float* lf,
             const float* li, const float* ica, const float* isa,
             const float* kr, const float* ki, float* t1, float* t2,
             float* dst, cudaStream_t stream) {
  const int w2 = w / 2 + 1;
  const long long hw = (long long)h * w;
  const long long slab = (long long)h * w2;  // one real or imaginary plane
  int err;
  // S1 = x @ cw  and  -x @ sw  -> t1 = [re; im]
  Gemm g{x, hw, w, cw, 0, w2, t1, 2 * slab, w2, h, w2, w, 1.0f, 0, square};
  if ((err = run_gemm(g, batch, stream))) return err;
  g.b = sw;
  g.c = t1 + slab;
  g.alpha = -1.0f;
  if ((err = run_gemm(g, batch, stream))) return err;
  // S2 = [[ch, sh], [-sh, ch]] @ S1 -> t2
  Gemm f{lf, 0, 2 * h, t1, 2 * slab, w2, t2, 2 * slab, w2, 2 * h, w2, 2 * h,
         1.0f, 0, 0};
  if ((err = run_gemm(f, batch, stream))) return err;
  // S3 = S2 * K, in place
  const long long n = (long long)batch * slab;
  cmul_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      t2, kr, ki, batch, (int)slab);
  if ((err = (int)cudaGetLastError())) return err;
  // S4 = [[ich, -ish], [ish, ich]] @ S3 -> t1
  f.a = li;
  f.b = t2;
  f.c = t1;
  if ((err = run_gemm(f, batch, stream))) return err;
  // out = S4r @ ica - S4i @ isa
  Gemm o{t1, 2 * slab, w2, ica, 0, w, dst, hw, w, h, w, w2, 1.0f, 0, 0};
  if ((err = run_gemm(o, batch, stream))) return err;
  o.a = t1 + slab;
  o.b = isa;
  o.alpha = -1.0f;
  o.accumulate = 1;
  return run_gemm(o, batch, stream);
}

}  // namespace

// C interface (loaded with ctypes).  All pointers are float32 device
// memory; t1 and t2 are scratch of (B, 2, H, W/2+1) floats each, conv and
// mvar of (B, H, W).  Launches on `stream` and returns the first nonzero
// cudaGetLastError() of its launches, or 0.
extern "C" int conv_lnl_launch(
    const float* raws, int batch, int h, int w,
    const float* cw, const float* sw, const float* lf, const float* li,
    const float* ica, const float* isa,
    const float* psf_r, const float* psf_i,
    const float* var_r, const float* var_i,
    const float* obs, const float* obs_var, const float* good,
    float* t1, float* t2, float* conv, float* mvar, float* out,
    void* stream_ptr) {
  if (batch <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err;
  if ((err = convolve(raws, 0, batch, h, w, cw, sw, lf, li, ica, isa, psf_r,
                      psf_i, t1, t2, conv, stream)))
    return err;
  if ((err = convolve(raws, 1, batch, h, w, cw, sw, lf, li, ica, isa, var_r,
                      var_i, t1, t2, mvar, stream)))
    return err;
  lnl_kernel<<<batch, kThreads, 0, stream>>>(conv, mvar, obs, obs_var, good,
                                             out, h * w);
  return (int)cudaGetLastError();
}
