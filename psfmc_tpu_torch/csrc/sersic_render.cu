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
// What bounds it on the H100: the profile's arithmetic (sersic_profile.cuh
// has the count).  For a 125-walker half-ensemble of two Sersics at
// 128x128 the image write is 8.2 MB (2.4 us at 3.35 TB/s); the 4.1 M
// profile evaluations need 12.3 M special-function results (3.0 us at 16
// per clock per SM and 1.96 GHz), and their 70 instructions each need
// about 9 us of the SMs' scheduler slots.  That rate bounds the kernel,
// which is short: about 17,000 cycles of work per SM, so that the start
// of a block and the tail of the grid are a visible share of it.
//
// Design.  A thread renders runs of four consecutive pixels of one row and
// writes each as one 128-bit store.  The block is 3-D: threadIdx.x runs
// along the row in steps of four pixels, threadIdx.y over the rows of a
// strip, threadIdx.z over the block's walkers, and a block walks the
// image's strips gridDim.y apart, so no thread divides an index.  The 19
// floats of a walker (two Sersics and the sky) come through the read-only
// path into registers, once per walker (the address is warp-uniform where
// a row fills a warp): no shared memory, no barrier.  A block takes its
// `walkers_per_block` walkers in turn, blockDim.z of them at a time (were
// it one at a time, 25 walkers a block would leave 155 threads on an SM).
// The wrapper chooses the block's shape and the number of strips a block
// walks from the image's shape
// (psfmc_tpu_torch.ops.kernels.sersic_render.launch_geometry); this file
// only checks them.  Many short blocks (128 threads, every strip its own
// block) were measured faster than fewer blocks that walk several strips:
// the tail of a short grid weighs more than the start of a block.  The
// 128-bit store needs a width that is a multiple of four and a 16-byte
// aligned image; every other image is written pixel by pixel, the last run
// of a row cut short.
//
// Numerics: sersic_profile.cuh's, shared with the fused likelihood kernel:
// explicitly rounded single operations in the plain PyTorch version's
// order, the accurate expf, logf's and the division's bits, the
// NaN-keeping clamp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sersic_profile.cuh"

namespace {

constexpr int kParams = psfmc::kParamsPerSersic;
constexpr int kMaxThreads = 256;
constexpr int kRun = 4;  // pixels of one 128-bit store

// S: the number of Sersics (0: any, see SersicSet).
template <int S>
__global__ void __launch_bounds__(kMaxThreads)
sersic_render_kernel(const float* __restrict__ params,  // (B, S, 9)
                     const float* __restrict__ sky,     // (B,)
                     float* __restrict__ out,           // (B, H, W)
                     int batch, int num_sersic, int h, int w,
                     int walkers_per_block, bool wide_stores) {
  const int b0 = blockIdx.x * walkers_per_block;
  const int nb = min(walkers_per_block, batch - b0);
  const int row_len = num_sersic * kParams;
  psfmc::SersicSet<S, true> sersics;
  for (int t = threadIdx.z; t < nb; t += blockDim.z) {
    const int b = b0 + t;
    sersics.load(params + (size_t)b * row_len, num_sersic);
    const float sky_b = __ldg(sky + b);
    float* img = out + (size_t)b * h * w;
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < h;
         y += gridDim.y * blockDim.y) {
      sersics.set_row((float)y);
      float* row = img + y * w;
      for (int x = kRun * threadIdx.x; x < w; x += kRun * blockDim.x) {
        float xg[kRun], acc[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j) xg[j] = (float)(x + j);
        sersics.render(sky_b, xg, acc);
        if (wide_stores) {
          *reinterpret_cast<float4*>(row + x) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kRun; ++j)
            if (x + j < w) row[x + j] = acc[j];
        }
      }
    }
  }
}

}  // namespace

// C interface (loaded with ctypes).  The block is block_x x block_y x
// block_z threads (at most 256): block_x along a row, four pixels each,
// block_y rows, block_z walkers; a block walks the image's strips of
// block_y rows `strips` apart.  Launches on `stream` and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a geometry
// this file does not take); 0 means the launch was accepted.
extern "C" int sersic_render_launch(const float* params, const float* sky,
                                    float* out, int batch, int num_sersic,
                                    int h, int w, int walkers_per_block,
                                    int block_x, int block_y, int block_z,
                                    int strips, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (walkers_per_block <= 0 || num_sersic < 0 || block_x <= 0 ||
      block_y <= 0 || block_z <= 0 || block_z > 64 ||
      block_x * block_y * block_z > kMaxThreads || strips <= 0 ||
      strips > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + walkers_per_block - 1) / walkers_per_block, strips);
  const dim3 block(block_x, block_y, block_z);
  const bool wide = w % kRun == 0 && ((uintptr_t)out & 15) == 0;
#define PSFMC_RENDER(S)                                                   \
  sersic_render_kernel<S><<<grid, block, 0, (cudaStream_t)stream>>>(      \
      params, sky, out, batch, num_sersic, h, w, walkers_per_block, wide)
  switch (num_sersic) {
    case 1: PSFMC_RENDER(1); break;
    case 2: PSFMC_RENDER(2); break;
    case 3: PSFMC_RENDER(3); break;
    default: PSFMC_RENDER(0); break;
  }
#undef PSFMC_RENDER
  return (int)cudaGetLastError();
}
