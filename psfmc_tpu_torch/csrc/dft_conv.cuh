// The matmul-DFT convolution of a batch of images: the twelve real
// half-spectrum products of psfmc_tpu_torch.ops.fourier.convolve_rdft as
// fp32 FMA GEMMs through global scratch.  Shared by conv_lnl.cu (the
// forward of its matmul-DFT route) and conv_lnl_backward.cu (the same
// products with the transposed operators and the conjugate spectrum: the
// adjoint).  conv_lnl.cu describes the products and what bounds them.
#pragma once

#include <cuda_runtime.h>

namespace psfmc {
namespace dftconv {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kCmulThreads = 256;

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

inline int run_gemm(Gemm g, int batch, cudaStream_t stream) {
  dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, batch);
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// One circular convolution of every walker's image (squared if
// `square`) with the half spectrum (kr, ki); result into dst (B, H, W).
inline int convolve(const float* x, int square, int batch, int h, int w,
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
  cmul_kernel<<<(unsigned)((n + kCmulThreads - 1) / kCmulThreads), kCmulThreads, 0, stream>>>(
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

}  // namespace dftconv
}  // namespace psfmc
