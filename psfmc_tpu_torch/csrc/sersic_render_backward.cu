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
// is the same function in plain PyTorch).
//
// What bounds it on the H100: the profile's arithmetic again.  Per pixel
// and Sersic it evaluates the forward (a logf, two expf, a division) and
// the product's 44 more single operations with three more divisions, six
// special-function results in all, plus ten float64 accumulations; the
// image gradient is read once per Sersic (8.2 MB for 125 walkers at
// 128x128, 2.4 us at 3.35 TB/s).  The special-function results bound it
// (chip_smoke.py counts them); float64 adds run at half the float32 rate
// of the H100's non-tensor units.
//
// Design.  Grid (B, strips): block (b, k) takes walker b's rows of strip
// k, the strips chosen by the wrapper so that the grid holds about two
// blocks per SM (psfmc_tpu_torch.ops.kernels.sersic_render
// .backward_strips).  The block walks its Sersics in turn; for each, its
// 256 threads walk the strip's pixels, each summing the nine products (and
// G itself, with the first Sersic) in float64 registers; a fixed tree
// (warp shuffles, then the warps in order through shared memory) reduces
// them into the block's float64 partials, (B, strips, 9 S + 1) in global
// scratch.  A second kernel sums each walker's strips in order and writes
// float32.  No atomics: every launch gives the same bits, so a captured
// and an eager Adam step agree bit for bit.
//
// Numerics: float32 per pixel with the library's accurate expf and logf
// (no --use_fast_math), float64 sums.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kParams = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = kParams + 1;  // the nine products and G itself

__global__ void __launch_bounds__(kThreads)
render_backward_kernel(const float* __restrict__ params,  // (B, S, 9)
                       const float* __restrict__ grad,    // (B, H, W)
                       double* __restrict__ partial,      // (B, strips, 9S+1)
                       int num_sersic, int h, int w) {
  __shared__ double red[kWarps][kAcc];
  const int b = blockIdx.x, strip = blockIdx.y, strips = gridDim.y;
  const int rows = (h + strips - 1) / strips;
  const int y0 = strip * rows, y1 = min(h, y0 + rows);
  const int p0 = y0 * w, p1 = y1 > y0 ? y1 * w : p0;
  const float* g_img = grad + (size_t)b * h * w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_out = num_sersic * kParams + 1;
  double* out = partial + ((size_t)b * strips + strip) * k_out;

  for (int s = 0; s < max(num_sersic, 1); ++s) {
    const bool has = s < num_sersic;
    float q[kParams];
#pragma unroll
    for (int k = 0; k < kParams; ++k)
      q[k] = has ? __ldg(params + ((size_t)b * num_sersic + s) * kParams + k) : 0.0f;
    const float x0 = q[0], yc = q[1], m00 = q[2], m01 = q[3], m10 = q[4],
                m11 = q[5], kappa = q[6], rp = q[7], sbeff = q[8];
    const float krp = kappa * rp;
    double acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0;
    for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
      const int yi = p / w, xi = p - yi * w;
      const float G = __ldg(g_img + p);
      acc[kParams] += (double)G;
      if (!has) continue;
      const float dx = (float)xi - x0, dy = (float)yi - yc;
      const float u = m00 * dx + m01 * dy;
      const float v = m10 * dx + m11 * dy;
      const float sq = u * u + v * v;
      const float sq_r = sq < 1e-30f ? 1e-30f : sq;  // keeps a NaN
      const float log_sq = logf(sq_r);
      const float pw = expf(log_sq * rp);
      const float sb = expf(-kappa * (pw - 1.0f));
      const float off = dx * dx + dy * dy;
      const float three_off = 3.0f * (off < 0.125f ? 0.125f : off);
      const float krp_p = krp * pw;
      const float corr = 1.0f + krp_p * krp_p / three_off;
      const float g_sb = G * sbeff * corr;
      const float g_corr = G * sbeff * sb;
      const float g_krp_p = g_corr * 2.0f * krp_p / three_off;
      const float g_off = off >= 0.125f
          ? -g_corr * krp_p * krp_p * 3.0f / (three_off * three_off) : 0.0f;
      const float g_arg = g_sb * sb;
      const float g_p = g_krp_p * krp - g_arg * kappa;
      const float g_lp = g_p * pw;
      const float g_sq = sq >= 1e-30f ? g_lp * rp / sq_r : 0.0f;
      const float g_u = 2.0f * u * g_sq, g_v = 2.0f * v * g_sq;
      const float g_dx = g_u * m00 + g_v * m10 + 2.0f * dx * g_off;
      const float g_dy = g_u * m01 + g_v * m11 + 2.0f * dy * g_off;
      const float g_krp = g_krp_p * pw;
      acc[0] -= (double)g_dx;
      acc[1] -= (double)g_dy;
      acc[2] += (double)(g_u * dx);
      acc[3] += (double)(g_u * dy);
      acc[4] += (double)(g_v * dx);
      acc[5] += (double)(g_v * dy);
      acc[6] += (double)(g_krp * rp) - (double)(g_arg * (pw - 1.0f));
      acc[7] += (double)(g_krp * kappa) + (double)(g_lp * log_sq);
      acc[8] += (double)(G * sb * corr);
    }
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      double v = acc[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < kAcc) {
      const int k = threadIdx.x;
      double tot = 0.0;
      for (int i = 0; i < kWarps; ++i) tot += red[i][k];
      if (k < kParams) {
        if (has) out[s * kParams + k] = tot;
      } else if (s == 0) {
        out[k_out - 1] = tot;  // G's sum: the sky's gradient
      }
    }
    __syncthreads();
  }
}

// (b, k) -> the sum over walker b's strips, in order, as float32.
__global__ void strip_sum_kernel(const double* __restrict__ partial,
                                 float* __restrict__ g_params,
                                 float* __restrict__ g_sky, int batch,
                                 int num_sersic, int strips) {
  const int k_out = num_sersic * kParams + 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * k_out) return;
  const int b = (int)(idx / k_out), k = (int)(idx % k_out);
  const double* src = partial + (size_t)b * strips * k_out + k;
  double tot = 0.0;
  for (int i = 0; i < strips; ++i) tot += src[(size_t)i * k_out];
  if (k < k_out - 1)
    g_params[(size_t)b * (k_out - 1) + k] = (float)tot;
  else
    g_sky[b] = (float)tot;
}

}  // namespace

// C interface (loaded with ctypes).  params (B, S, 9) and grad (B, H, W)
// float32, partial (B, strips, 9 S + 1) float64 scratch, g_params (B, S,
// 9) and g_sky (B,) float32 outputs, all device memory.  Launches the two
// kernels on `stream` and returns the first nonzero cudaGetLastError(),
// or 0.
extern "C" int sersic_render_backward_launch(const float* params,
                                             const float* grad,
                                             double* partial, float* g_params,
                                             float* g_sky, int batch,
                                             int num_sersic, int h, int w,
                                             int strips, void* stream) {
  if (batch <= 0) return 0;
  if (num_sersic < 0 || h <= 0 || w <= 0 || strips <= 0 || strips > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  render_backward_kernel<<<dim3(batch, strips), kThreads, 0, st>>>(
      params, grad, partial, num_sersic, h, w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)batch * (num_sersic * kParams + 1);
  strip_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partial, g_params, g_sky, batch, num_sersic, strips);
  return (int)cudaGetLastError();
}
