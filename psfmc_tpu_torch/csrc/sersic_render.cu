// Sky + Sersic raw-model render for a batch of walkers (Hopper, sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   psfmc_tpu/ops/pallas/sersic_pallas.py::render_sersics_pallas_one
//     (one walker per program, vmapped to a (B,) grid) and
//   psfmc_tpu/ops/pallas/sersic_pallas.py::render_sersics_pallas_tiled
//     (T walkers per program).
// Both become this one kernel: `walkers_per_block` is 1 for the first and
// T for the second.
//
// What it computes: out[b, j, i] = sky[b] + sum_s sersic_profile_core(
//   i - x_bs, j - y_bs, m00, m01, m10, m11, kappa, rp, sbeff), with the
// packed rows params[b, s, :] = [x, y, m00, m01, m10, m11, kappa, rp,
// sbeff] built by psfmc_tpu_torch.ops.sersic.sersic_scalar_params.
//
// What bounds it on the H100: the image write is 64 KB per 128x128
// walker (8 MB for a 125-walker half-ensemble, ~2.4 us at 3.35 TB/s);
// the arithmetic is two expf and one logf plus ~20 fp32 operations per
// pixel per Sersic, about the same time again at the fp32 peak.  So it
// is near the balance point and neither bound is far away.
//
// Design: one thread per pixel, a 2-D grid over (pixel blocks, walker
// blocks).  The S x 9 parameter rows and the sky of the block's walkers
// are staged once in shared memory; each thread then loops over its
// walkers, keeps the accumulator in a register and writes each output
// pixel exactly once, coalesced along the row.  Pixel coordinates are
// made from the thread index, never read.
//
// Numerics: no --use_fast_math, and no __expf/__logf: expf and logf are
// the accurate library versions (within 2 ulp).  The profile is
// evaluated as explicitly rounded single operations (__fmul_rn,
// __fadd_rn, __fdiv_rn) in the order of the plain PyTorch version,
// so the compiler cannot contract them into FMAs and the kernel agrees
// with the plain version up to the library transcendentals.  The two
// clamps (square radius >= 1e-30, square offset >= 0.125) are the JAX
// package's documented divergences from the reference.

#include <cuda_runtime.h>

namespace {

constexpr int kParams = 9;
constexpr int kThreads = 256;

// max(x, lo) that keeps a NaN, like torch.clamp and jnp.maximum (fmaxf
// would replace it by lo).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float profile(float dx, float dy, const float* q) {
  // q = [x, y, m00, m01, m10, m11, kappa, rp, sbeff]
  const float u = __fadd_rn(__fmul_rn(q[2], dx), __fmul_rn(q[3], dy));
  const float v = __fadd_rn(__fmul_rn(q[4], dx), __fmul_rn(q[5], dy));
  const float sq_r = clamp_min(__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)), 1e-30f);
  const float kappa = q[6];
  const float rp = q[7];
  const float p = expf(__fmul_rn(logf(sq_r), rp));
  const float sb = expf(__fmul_rn(-kappa, __fsub_rn(p, 1.0f)));
  const float sq_off = clamp_min(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 0.125f);
  const float krp_p = __fmul_rn(__fmul_rn(kappa, rp), p);
  const float corr = __fadd_rn(
      1.0f, __fdiv_rn(__fmul_rn(krp_p, krp_p), __fmul_rn(3.0f, sq_off)));
  return __fmul_rn(__fmul_rn(q[8], sb), corr);
}

__global__ void __launch_bounds__(kThreads)
sersic_render_kernel(const float* __restrict__ params,  // (B, S, 9)
                     const float* __restrict__ sky,     // (B,)
                     float* __restrict__ out,           // (B, H, W)
                     int batch, int num_sersic, int h, int w,
                     int walkers_per_block) {
  extern __shared__ float smem[];  // walkers_per_block * (S*9 + 1)
  const int row_len = num_sersic * kParams;
  const int b0 = blockIdx.y * walkers_per_block;
  const int nb = min(walkers_per_block, batch - b0);
  for (int t = threadIdx.x; t < nb * row_len; t += blockDim.x) {
    smem[t] = params[(size_t)b0 * row_len + t];
  }
  float* s_sky = smem + walkers_per_block * row_len;
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    s_sky[t] = sky[b0 + t];
  }
  __syncthreads();

  const int npix = h * w;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const float xg = (float)(pix % w);
  const float yg = (float)(pix / w);
  for (int t = 0; t < nb; ++t) {
    const float* rows = smem + t * row_len;
    float acc = s_sky[t];
    for (int s = 0; s < num_sersic; ++s) {
      const float* q = rows + s * kParams;
      acc = __fadd_rn(acc, profile(__fsub_rn(xg, q[0]), __fsub_rn(yg, q[1]), q));
    }
    out[(size_t)(b0 + t) * npix + pix] = acc;
  }
}

}  // namespace

// C interface (loaded with ctypes).  Launches on `stream` and returns
// cudaGetLastError() of the launch; 0 means the launch was accepted.
extern "C" int sersic_render_launch(const float* params, const float* sky,
                                    float* out, int batch, int num_sersic,
                                    int h, int w, int walkers_per_block,
                                    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || walkers_per_block <= 0) return 0;
  const int npix = h * w;
  dim3 grid((npix + kThreads - 1) / kThreads,
            (batch + walkers_per_block - 1) / walkers_per_block);
  const size_t smem =
      sizeof(float) * (size_t)walkers_per_block * (num_sersic * kParams + 1);
  sersic_render_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      params, sky, out, batch, num_sersic, h, w, walkers_per_block);
  return (int)cudaGetLastError();
}
