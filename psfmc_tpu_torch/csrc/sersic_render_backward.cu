// The render's backward: the vector-Jacobian product of sky + Sersics for
// a batch of walkers (Hopper, sm_90a).
//
// Backward of the render kernel (sersic_render.cu), which replaces the
// JAX package's Pallas TPU kernels
//   psfmc_tpu/ops/pallas/sersic_pallas.py::render_sersics_pallas_one and
//   psfmc_tpu/ops/pallas/sersic_pallas.py::render_sersics_pallas_tiled.
// The JAX package differentiates its render by autodiff of the same
// profile (jax.value_and_grad in psfmc_tpu/optimize.py); the port's
// forward is a hand-written kernel, so its backward is one too.  Both
// render wrappers share it.
//
// What it computes, for the image gradient G (B, H, W):
//   g_sky[b]       = sum_p G[b, p]
//   g_rows[b, s, k] = sum_p G[b, p] dI_s(p) / dq_k
// for the nine packed scalars q = [x, y, m00, m01, m10, m11, kappa, rp,
// sbeff] of Sersic s, through psfmc_tpu_torch.ops.sersic.
// sersic_profile_core as written: with dx = i - x, dy = j - y, u = m00 dx
// + m01 dy, v = m10 dx + m11 dy, p = exp(log(max(u^2 + v^2, 1e-30)) rp),
// sb = exp(-kappa (p - 1)) and corr = 1 + (kappa rp p)^2 / (3 max(dx^2 +
// dy^2, 0.125)), I = sbeff sb corr.  Both clamps have zero slope below
// their floor and at a NaN, as torch.clamp's gradient has them
// (psfmc_tpu_torch.ops.kernels.sersic_render.render_sersics_backward_plain
// is the same function in plain PyTorch; render_sersics_backward_order_plain
// is this kernel's order of summation).
//
// What bounds it on the H100: the profile's arithmetic again.  Per pixel
// and Sersic it evaluates the forward (a logf, two expf) and the
// product's vector-Jacobian terms, with two IEEE reciprocals (of
// 3 max(off, 0.125) and of max(sq, 1e-30)) and multiplies in place of
// divisions: four special-function results (two ex2, two rcp; logf is a
// polynomial of FMAs) against about 85 fp32 operations.  The
// special-function unit, 16 results per clock per SM, bounds it
// (chip_smoke.py counts the results); the image gradient is read once
// (8.2 MB for 125 walkers at 128x128, 2.4 us at 3.35 TB/s).
//
// Design.  One launch.  Walker b's pixels are split into `strips`
// contiguous ranges of `per_strip` pixels (a multiple of the block's 256
// threads), one block each, and the walker's blocks form one thread-block
// cluster (at most 8, the portable cluster size).  The wrapper chooses
// the strips so that one wave fills the 132 SMs at two blocks each
// (psfmc_tpu_torch.ops.kernels.sersic_render.backward_strips: 2 at 125
// walkers, 4 at 64 walkers, at 128x128).  Thread t of a block takes the
// pixels first + t + 256 i; it carries the pixel's row and column as
// floats, stepped by the constant (256 div W, 256 mod W) with one wrap,
// so no pixel costs an integer division or a conversion.  Pixels are the
// outer loop and the Sersics the inner one: G is read once per pixel,
// and dx, dy and the offset once per pixel and Sersic centre.  The kernel
// is a template on the Sersic count (0 to 4) and holds 9 S + 1 float32
// accumulators; more Sersics take the one-Sersic instantiation in passes,
// one Sersic each.
//
// Sums, deterministic and without atomics.  A thread adds its pixels'
// terms in float32 registers over chunks of at most 32 of its pixels (one
// chunk at the MAP path's shapes: 32 pixels a thread at 125 walkers, 16 at
// 64); G's own sum (the sky's gradient, where positive and negative pixels
// cancel to a small total) with Kahan's compensation, three more adds a
// pixel; each chunk widens to float64 once, in a fixed warp-shuffle tree,
// and lane 0 adds it to its warp's float64 slot in chunk order.  The
// warps' slots are summed in order into the block's float64 sums in
// shared memory; after a cluster barrier the cluster's first block reads
// every block's sums through distributed shared memory, in strip order,
// and writes float32.  No global scratch, no second launch, and every
// launch gives the same bits, so a captured and an eager Adam step agree
// bit for bit.
//
// Numerics: float32 per pixel with the library's accurate expf, logf and
// reciprocal (no --use_fast_math); float32 over at most 32 terms, float64
// above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kParams = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // a thread's pixels summed in float32
constexpr int kMaxStrips = 8;  // the portable cluster size
constexpr int kMaxFixed = 4;   // Sersic counts with their own instantiation

// One Sersic's scalars and the terms no pixel changes.
struct Sersic {
  float x, y, m00, m01, m10, m11, kappa, rp, sbeff, krp;
};

// Adds pixel (xf, yf)'s terms of Sersic q, image gradient G, to a[0..8].
__device__ __forceinline__ void add_terms(float* a, const Sersic& q, float G,
                                          float xf, float yf) {
  const float dx = xf - q.x, dy = yf - q.y;
  const float u = q.m00 * dx + q.m01 * dy;
  const float v = q.m10 * dx + q.m11 * dy;
  const float sq = u * u + v * v;
  const float sq_r = sq < 1e-30f ? 1e-30f : sq;  // keeps a NaN
  const float log_sq = logf(sq_r);
  const float pw = expf(log_sq * q.rp);
  const float sb = expf(-q.kappa * (pw - 1.0f));
  const float off = dx * dx + dy * dy;
  const float inv3 = 1.0f / (3.0f * (off < 0.125f ? 0.125f : off));
  const float krp_p = q.krp * pw;
  const float kpp2 = krp_p * krp_p;
  const float corr = 1.0f + kpp2 * inv3;
  const float gs = G * q.sbeff;
  const float t = gs * sb * inv3;  // d/d corr over 3 off
  const float g_krp_p = 2.0f * krp_p * t;
  const float g_off = off >= 0.125f ? -3.0f * kpp2 * t * inv3 : 0.0f;
  const float g_arg = gs * corr * sb;  // d/d[-kappa (p - 1)]
  const float g_p = g_krp_p * q.krp - g_arg * q.kappa;
  const float g_lp = g_p * pw;  // d/d[log(sq) rp]
  const float inv_sq = 1.0f / sq_r;
  const float g_sq = sq >= 1e-30f ? g_lp * q.rp * inv_sq : 0.0f;
  const float g_u = 2.0f * u * g_sq, g_v = 2.0f * v * g_sq;
  const float g_dx = g_u * q.m00 + g_v * q.m10 + 2.0f * dx * g_off;
  const float g_dy = g_u * q.m01 + g_v * q.m11 + 2.0f * dy * g_off;
  const float g_krp = g_krp_p * pw;
  a[0] -= g_dx;
  a[1] -= g_dy;
  a[2] += g_u * dx;
  a[3] += g_u * dy;
  a[4] += g_v * dx;
  a[5] += g_v * dy;
  a[6] += g_krp * q.rp - g_arg * (pw - 1.0f);
  a[7] += g_krp * q.kappa + g_lp * log_sq;
  a[8] += G * sb * corr;
}

// NS Sersics a pass (NS == num_sersic for 0..4; the one-Sersic
// instantiation also walks more Sersics, one a pass).  Grid: batch x
// strips blocks, clusters of `strips` consecutive blocks, one walker each.
template <int NS>
__global__ void __launch_bounds__(kThreads)
render_backward_kernel(const float* __restrict__ params,  // (B, S, 9)
                       const float* __restrict__ grad,    // (B, H, W)
                       float* __restrict__ g_params,      // (B, S, 9)
                       float* __restrict__ g_sky,         // (B,)
                       int num_sersic, int h, int w, int per_strip) {
  constexpr int kAcc = NS * kParams + 1;  // the products and G itself
  extern __shared__ double part[];        // the block's 9 S + 1 sums
  __shared__ double red[kWarps][kAcc];
  cg::cluster_group cluster = cg::this_cluster();
  const int strip = (int)cluster.block_rank();
  const int strips = (int)cluster.num_blocks();
  const int b = blockIdx.x / strips;
  const int hw = h * w, k_out = num_sersic * kParams + 1;
  const int p0 = strip * per_strip, p1 = min(hw, p0 + per_strip);
  const int iters = p1 > p0 ? (p1 - p0 + kThreads - 1) / kThreads : 0;
  const float* g_img = grad + (size_t)b * hw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the thread's first pixel as (row, column), and the step between its pixels
  const int first = p0 + threadIdx.x;
  const int row0 = first / w, step_rows = kThreads / w;
  const float x_first = (float)(first - row0 * w), y_first = (float)row0;
  const float step_x = (float)(kThreads - step_rows * w), step_y = (float)step_rows;
  const float wf = (float)w;

  const int passes = NS == 0 ? 1 : num_sersic / NS;
  for (int pass = 0; pass < passes; ++pass) {
    const int s0 = pass * NS;
    Sersic q[NS > 0 ? NS : 1];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float* r = params + ((size_t)b * num_sersic + s0 + j) * kParams;
      q[j] = Sersic{__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3),
                    __ldg(r + 4), __ldg(r + 5), __ldg(r + 6), __ldg(r + 7),
                    __ldg(r + 8), __ldg(r + 6) * __ldg(r + 7)};
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) red[warp][k] = 0.0;
    }
    int p = first;
    float xf = x_first, yf = y_first;
    // chunks of at most kChunk of the thread's pixels; the count is the
    // block's, so that every lane of a warp reaches each shuffle
    for (int c0 = 0; c0 < iters; c0 += kChunk) {
      float acc[kAcc];  // G's sum is the last, compensated by g_comp
      float g_comp = 0.0f;
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
      const int c1 = min(iters, c0 + kChunk);
      for (int i = c0; i < c1; ++i) {
        if (p < p1) {
          const float G = __ldg(g_img + p);
          const float y = G - g_comp;  // Kahan: G's sum cancels
          const float t = acc[kAcc - 1] + y;
          g_comp = (t - acc[kAcc - 1]) - y;
          acc[kAcc - 1] = t;
#pragma unroll
          for (int j = 0; j < NS; ++j) add_terms(acc + j * kParams, q[j], G, xf, yf);
        }
        p += kThreads;
        xf += step_x;
        yf += step_y;
        if (xf >= wf) {
          xf -= wf;
          yf += 1.0f;
        }
      }
      // the chunk widens to float64 here, once: a fixed warp tree
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        double v = k < kAcc - 1 ? (double)acc[k] : (double)acc[k] - (double)g_comp;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp][k] += v;
      }
    }
    __syncthreads();
    if (threadIdx.x < kAcc) {  // the warps in order
      const int k = threadIdx.x;
      double tot = 0.0;
      for (int i = 0; i < kWarps; ++i) tot += red[i][k];
      if (k < NS * kParams)
        part[s0 * kParams + k] = tot;
      else if (pass == 0)
        part[k_out - 1] = tot;  // G's sum: the sky's gradient
    }
    __syncthreads();
  }

  // the walker's strips in order, by the cluster's first block
  cluster.sync();
  if (strip == 0) {
    for (int k = threadIdx.x; k < k_out; k += kThreads) {
      double tot = 0.0;
      for (int r = 0; r < strips; ++r) tot += cluster.map_shared_rank(part, r)[k];
      if (k < k_out - 1)
        g_params[(size_t)b * (k_out - 1) + k] = (float)tot;
      else
        g_sky[b] = (float)tot;
    }
  }
  cluster.sync();  // every block's sums stay readable until they are read
}

}  // namespace

// C interface (loaded with ctypes).  params (B, S, 9) and grad (B, H, W)
// float32 inputs, g_params (B, S, 9) and g_sky (B,) float32 outputs, all
// device memory; `strips` blocks of `per_strip` pixels per walker (a
// multiple of 256; strips * per_strip covers H W and every strip holds a
// pixel), 1 <= strips <= 8.  Launches the kernel on `stream` and returns
// the first nonzero cudaError of the launch, or 0.
extern "C" int sersic_render_backward_launch(const float* params,
                                             const float* grad,
                                             float* g_params, float* g_sky,
                                             int batch, int num_sersic, int h,
                                             int w, int strips, int per_strip,
                                             void* stream) {
  if (batch <= 0) return 0;
  const long long hw = (long long)h * w;
  const size_t smem = sizeof(double) * ((size_t)num_sersic * kParams + 1);
  if (num_sersic < 0 || h <= 0 || w <= 0 || strips <= 0 || strips > kMaxStrips ||
      per_strip <= 0 || per_strip % kThreads || (long long)strips * per_strip < hw ||
      (long long)(strips - 1) * per_strip >= hw || hw > (1LL << 24) ||
      (long long)batch * strips > 0x7fffffffLL || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * strips));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)strips;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (num_sersic) {
    case 0: err = cudaLaunchKernelEx(&cfg, render_backward_kernel<0>, params, grad,
                                     g_params, g_sky, num_sersic, h, w, per_strip);
      break;
    case 2: err = cudaLaunchKernelEx(&cfg, render_backward_kernel<2>, params, grad,
                                     g_params, g_sky, num_sersic, h, w, per_strip);
      break;
    case 3: err = cudaLaunchKernelEx(&cfg, render_backward_kernel<3>, params, grad,
                                     g_params, g_sky, num_sersic, h, w, per_strip);
      break;
    case kMaxFixed: err = cudaLaunchKernelEx(&cfg, render_backward_kernel<kMaxFixed>,
                                             params, grad, g_params, g_sky,
                                             num_sersic, h, w, per_strip);
      break;
    default:  // 1, and more than 4 in passes of one
      err = cudaLaunchKernelEx(&cfg, render_backward_kernel<1>, params, grad,
                               g_params, g_sky, num_sersic, h, w, per_strip);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
