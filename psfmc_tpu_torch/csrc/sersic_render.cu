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
// Numerics: the profile is sersic_profile.cuh's, shared with the fused
// likelihood kernel: explicitly rounded single operations in the plain
// PyTorch version's order, the accurate expf/logf, the NaN-keeping clamp.

#include <cuda_runtime.h>

#include "sersic_profile.cuh"

namespace {

constexpr int kParams = psfmc::kParamsPerSersic;
constexpr int kThreads = 256;

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
    out[(size_t)(b0 + t) * npix + pix] =
        psfmc::sky_plus_sersics(s_sky[t], smem + t * row_len, num_sersic, xg, yg);
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
