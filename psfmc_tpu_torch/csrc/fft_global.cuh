// conv_lnl's global route: fft_conv.cuh's complex FFT pair of one walker
// with the transform in a global-memory scratch, for the transforms that fit
// no block and no cluster of 8 (conv_lnl.py's global_tiles: 512x512, 640x640,
// 235x235 -> 480x480, 251x251 -> 504x504, every side from 226 up that is not
// even and 7-smooth).  Shared by conv_lnl.cu (the forward and its residual
// instantiation), conv_lnl_backward.cu and fused_lnl.cu (its global route).
//
// What it computes is the padded route's scheme (fft_conv.cuh's PaddedGeom;
// psfmc_tpu_torch.ops.kernels.conv_lnl.padded_fft_conv_plain, at a
// transform that pads no side packed_fft_conv_plain) at the transform M_h x
// M_w = padded_shape(H, W), both sides on the mixed-radix tables of the
// cluster route (cluster_tables).  Only where the transform lives changes:
// a walker is split over blocks by tiles of rows and by groups of columns,
// one launch a direction, the intermediate in a scratch S of (B, H, M_w)
// float2 in global memory, kept in natural order (S[b][y][kx]: image row or
// transform row y, bin kx along W).  Only H rows are kept: along a padded H
// axis the forward's rows H .. M_h - 1 are zeros and its fold needs no row
// above H once the column pass has folded them; the backward's rows H .. 2H
// - 2 repeat rows 0 .. H - 2 (the adjoint of the fold).  Launches, on the
// caller's stream (a captured step takes them all into its graph):
//   1. peak_kernel (conv_lnl; the fused kernel's render pass writes the raw
//      rows and their peaks instead): each tile's largest |raw|;
//   2. rows_forward_kernel, a block a tile of T rows of one walker (T =
//      rows, 16 at 512 columns): the walker's scale from its tiles' peaks,
//      the tile padded and packed, x + i s x^2, in shared memory at the pitch
//      M_w + 1; the row passes (mixed_lines); the tile written to S in
//      natural order (the layout's bin -> position table read in shared
//      memory, the stores coalesced);
//   3. columns_kernel, a block a group of C adjacent bins kx <= M_w / 2 of
//      one walker (C = cols) and their Hermitian partners M_w - kx, also
//      adjacent: the 2C columns of every row of S into shared memory (two
//      runs of C float2 a row: coalesced; the transform's rows from H up are
//      zeros, or the backward's repeat), the column passes, the pair step
//      against the PSF and PSF-variance spectra (each pair (k, -k) inside
//      the block, the same ownership as mixed_pair_step), the inverse column
//      passes, and rows 0 .. H - 1 written back: along a padded H axis the
//      forward folds row s + H onto row s (s <= H - 2), the backward crops;
//   4. readout_kernel, a block a tile of T image rows: each reads the row
//      of S its shifted readout needs, the inverse row passes, the fold
//      along a padded W axis and the lnL terms of its pixels, summed in
//      float64 per thread, then the warps in order, into the tile's partial
//      sum; the residual instantiation also writes each pixel's weights
//      (a, c) and the tile's peaks of |a| and |c|;
//   5. reduce_kernel: each walker's partial sums in tile order (no float
//      atomics), -inf where the result is not finite; the residual
//      instantiation's scale exponent from the weights' peaks.
// The backward (launch_backward) runs 2 from the weights at the slots the
// readout read them from (the adjoint of its shift and fold), 3 with the
// conjugate spectra and the crop, and rows_backward_kernel, the inverse row
// passes and the combine with the raw image.  Nothing depends on which blocks
// share a walker or on the batch: a walker's lnL has the same bits in any
// batch and any launch.
//
// What bounds it: the bytes of S.  At 512x512 and 125 walkers S is 262 MB,
// five times the 50 MB L2, and the forward moves it four times (written by
// 2, read and written by 3, read by 4) beside two reads of the raw images
// (1 and 2): about 1.3 GB, 0.39 ms at 3.35 TB/s, against about 0.09 ms of
// the function's own fp32 operations.  The column pass reads 2C float2 of
// every row (C = 8: two runs of 64 bytes); the row passes read and write
// whole rows.
//
// Numerics: the FFT route's (fp32, no --use_fast_math, the same scales and
// non-finite handling); the lnL is reduced in a fixed order, no atomics.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fft_conv.cuh"

namespace psfmc {
namespace fftglobal {

namespace fc = psfmc::fftconv;

constexpr int kThreads = fc::kThreads;  // 512, as mixed_lines strides
constexpr int kWarps = fc::kWarps;
constexpr int kMaxTile = 16;        // rows a tile, bins a column group, at most
constexpr int kReduceThreads = 128;  // reduce_kernel: a thread a walker

__host__ __device__ inline int tiles_of(int n, int t) { return (n + t - 1) / t; }

// The image (h, w), its transform (mh, mw), the rows of a tile and the bins
// of a column group (conv_lnl.py's global_tiles).
struct Plan {
  int h, w, mh, mw, rows, cols;
  __host__ __device__ int row_tiles() const { return tiles_of(h, rows); }
  __host__ __device__ int col_groups() const { return tiles_of(mw / 2 + 1, cols); }
};

inline size_t tables_bytes(int mh, int mw) {
  return sizeof(float2) * (size_t)(fc::twiddle_entries(mh) + fc::twiddle_entries(mw)) +
         sizeof(int) * (size_t)fc::layout_ints(mh, mw);
}

// Dynamic shared memory of a row tile (2, 4 and the backward's last launch)
// and of a column group (3): conv_lnl.py's global_row_smem, global_column_smem.
inline size_t row_smem(const Plan& p) {
  return sizeof(float2) * (size_t)p.rows * fc::pitch(p.mw) + tables_bytes(p.mh, p.mw);
}

inline size_t column_smem(const Plan& p) {
  return sizeof(float2) * (size_t)p.mh * fc::pitch(2 * p.cols) + tables_bytes(p.mh, p.mw);
}

// The plan as the host makes it: each transform side the image's own where
// the FFT route takes it, padded_side otherwise; tiles within kMaxTile and
// every loop index of a block below 2^16 (FastDiv).
inline bool plan_ok(const Plan& p) {
  return p.h >= 2 && p.w >= 2 && p.mh == fc::transform_side(p.h) &&
         p.mw == fc::transform_side(p.w) && p.rows >= 1 && p.rows <= kMaxTile &&
         p.cols >= 1 && p.cols <= kMaxTile && p.rows * p.mw < 65536 &&
         p.mh * 2 * p.cols < 65536;
}

// The largest of v over the block (NaNs dropped), in every thread.
__device__ inline float block_max(float v) {
  __shared__ float part[kWarps];
  __shared__ float all;
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = part[0];
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, part[i]);
    all = m;
  }
  __syncthreads();
  return all;
}

// The walker's squared-image scale exponent from its tiles' peaks: the
// exponent of the largest |raw| within +-kMaxScaleExp, 0 where it is 0 or
// not finite (convolve_and_reduce's).
__device__ inline int walker_scale_exp(const float* peaks, int tiles) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < tiles; i += kThreads) m = fmaxf(m, __ldg(peaks + i));
  m = block_max(m);
  int se = 0;
  if (m > 0.0f && isfinite(m))
    se = max(-fc::kMaxScaleExp, min(fc::kMaxScaleExp, ilogbf(m)));
  return se;
}

__device__ __forceinline__ const int* pos_w(const fc::MixedGeom& m, const Plan& p) {
  return m.lay + fc::kLayoutHeader + 2 * p.mh;
}

// The row passes of a tile of n rows (the W axis's table and codes).
template <bool INVERSE>
__device__ __forceinline__ void tile_rows(float2* z, int n, const Plan& p,
                                          const fc::MixedGeom& m) {
  fc::mixed_lines<INVERSE, true>(z, n, p.mw, m.tw + m.lay[0], m.lay + 3 + fc::kMaxPasses,
                                 m.lay[2 + fc::kMaxPasses]);
}

// Launch 1: the largest |raw| of each tile of rows, peaks (B, row_tiles).
__global__ void __launch_bounds__(kThreads) peak_kernel(const float* __restrict__ raws,
                                                        Plan p, float* __restrict__ peaks) {
  const int b = blockIdx.x, t = blockIdx.y;
  const int y0 = t * p.rows, n = min(p.rows, p.h - y0);
  const float* raw = raws + ((size_t)b * p.h + y0) * p.w;
  float mx = 0.0f;
#pragma unroll 4
  for (int q = threadIdx.x; q < n * p.w; q += kThreads) mx = fmaxf(mx, fabsf(__ldg(raw + q)));
  mx = block_max(mx);
  if (threadIdx.x == 0) peaks[(size_t)b * p.row_tiles() + t] = mx;
}

// Launch 2: the forward row passes of a tile of S's rows.  Forward (conv):
// rows [y0, y0 + n) of the raw image, padded to M_w and packed x + i s x^2
// with the walker's scale.  BACKWARD: transform row y (y < H) at the slots
// the forward's readout read its weights from, pixel row (y - H/2) mod H,
// column tx <= 2W - 2 from (tx or tx - W) - W/2 mod W, zeros above; the
// imaginary part times 2^scale_exp (a walker whose lnl is not finite is
// skipped: its gradient is 0).
template <bool BACKWARD>
__global__ void __launch_bounds__(kThreads)
rows_forward_kernel(const float* __restrict__ raws, const float* __restrict__ peaks,
                    const float2* __restrict__ weights, const int* __restrict__ scale_exp,
                    const float* __restrict__ lnl, Plan p, const float2* __restrict__ twiddle,
                    const int* __restrict__ layout, float2* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, t = blockIdx.y;
  if (BACKWARD && !isfinite(__ldg(lnl + b))) return;  // the same for the whole block
  float2* z = reinterpret_cast<float2*>(smem);
  const int ld = fc::pitch(p.mw);
  const fc::MixedGeom m = fc::load_mixed(z + (size_t)p.rows * ld, twiddle, layout, p.mh, p.mw);
  const int y0 = t * p.rows, n = min(p.rows, p.h - y0);
  const fc::FastDiv by_mw(p.mw);
  if constexpr (!BACKWARD) {
    const int se = walker_scale_exp(peaks + (size_t)b * p.row_tiles(), p.row_tiles());
    const float s = ldexpf(1.0f, -se);
    const float* raw = raws + ((size_t)b * p.h + y0) * p.w;
#pragma unroll 4
    for (int q = threadIdx.x; q < n * p.mw; q += kThreads) {
      const int ly = by_mw.div(q), x = q - ly * p.mw;
      const float v = x < p.w ? __ldg(raw + ly * p.w + x) : 0.0f;
      z[ly * ld + x] = make_float2(v, s * (v * v));
    }
  } else {
    const float ys = ldexpf(1.0f, __ldg(scale_exp + b));
    const float2* wts = weights + (size_t)b * p.h * p.w;
#pragma unroll 4
    for (int q = threadIdx.x; q < n * p.mw; q += kThreads) {
      const int ly = by_mw.div(q), tx = q - ly * p.mw;
      float2 v = make_float2(0.0f, 0.0f);
      if (tx <= 2 * p.w - 2) {
        int y = y0 + ly - p.h / 2, x = (tx < p.w ? tx : tx - p.w) - p.w / 2;
        if (y < 0) y += p.h;
        if (x < 0) x += p.w;
        v = __ldg(wts + y * p.w + x);
        v.y *= ys;
      }
      z[ly * ld + tx] = v;
    }
  }
  __syncthreads();
  tile_rows<false>(z, n, p, m);
  const int* pw = pos_w(m, p);
  float2* dst = scratch + ((size_t)b * p.h + y0) * p.mw;
#pragma unroll 4
  for (int q = threadIdx.x; q < n * p.mw; q += kThreads) {
    const int ly = by_mw.div(q), kx = q - ly * p.mw;
    dst[q] = z[ly * ld + pw[kx]];
  }
}

// The bin kx that column tc of a group's tile holds, -1 if none: tile
// columns [0, C) are the group's bins c0 + i (i < own), [C, 2C) their
// partners M_w - (c0 + i) where that is another bin (0 < c0 + i < M_w / 2).
__device__ __forceinline__ int group_bin(int tc, int c0, int own, const Plan& p) {
  const int i = tc < p.cols ? tc : tc - p.cols;
  if (i >= own) return -1;
  const int kx = c0 + i;
  if (tc < p.cols) return kx;
  return (kx == 0 || 2 * kx == p.mw) ? -1 : p.mw - kx;
}

// Launch 3: the column passes, the pair step and the inverse column passes
// of one group of columns of one walker, in place in S (module comment,
// step 3).  ks are the spectra at the transform's sides (the backward's
// conjugate ones), walker b reading target b / per_target's.
template <bool BACKWARD>
__global__ void __launch_bounds__(kThreads)
columns_kernel(Plan p, const float2* __restrict__ twiddle, const int* __restrict__ layout,
               fc::Spectra ks, int per_target, size_t spectra_stride,
               const float* __restrict__ lnl, float2* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  if (BACKWARD && !isfinite(__ldg(lnl + b))) return;
  const int cw = 2 * p.cols, ld = fc::pitch(cw), wh = p.mw / 2;
  float2* z = reinterpret_cast<float2*>(smem);
  const fc::MixedGeom m = fc::load_mixed(z + (size_t)p.mh * ld, twiddle, layout, p.mh, p.mw);
  const int c0 = blockIdx.y * p.cols, own = min(p.cols, wh + 1 - c0);
  float2* img = scratch + (size_t)b * p.h * p.mw;
  const bool fold_h = p.mh != p.h;
  const fc::FastDiv by_cw(cw);
#pragma unroll 4
  for (int q = threadIdx.x; q < p.mh * cw; q += kThreads) {
    const int r = by_cw.div(q), tc = q - r * cw;
    const int kx = group_bin(tc, c0, own, p);
    // the row of S that transform row r reads: rows from H up are zeros in
    // the forward, and repeat rows 0 .. H - 2 in the backward
    int src = r;
    if (r >= p.h) src = (BACKWARD && fold_h && r <= 2 * p.h - 2) ? r - p.h : -1;
    z[r * ld + tc] = (kx >= 0 && src >= 0) ? img[(size_t)src * p.mw + kx]
                                           : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  fc::mixed_lines<false, false>(z, p.mh, cw, m.tw, m.lay + 2, m.lay[1]);

  // mixed_pair_step's ownership: the thread of bin (ky, kx) writes (-ky,
  // -kx) too, in the partner column; in the columns kx = 0 and kx = M_w / 2
  // the bin with ky <= M_h / 2 owns the pair, in the same column
  const int* pos_h = m.lay + fc::kLayoutHeader;
  const int* bin_h = pos_h + p.mh;
  const fc::Spectra k = fc::target_spectra(ks, b / per_target, spectra_stride);
  const float gain = __ldg(k.var_gain);
  const fc::FastDiv by_own(own);
#pragma unroll 4
  for (int t = threadIdx.x; t < p.mh * own; t += kThreads) {
    const int r = by_own.div(t), i = t - r * own;
    const int ky = bin_h[r], kx = c0 + i;
    const bool edge = kx == 0 || kx == wh;
    if (edge && ky > p.mh / 2) continue;
    const int nky = ky ? p.mh - ky : 0;
    fc::pair_ptrs(z + r * ld + i, z + pos_h[nky] * ld + (edge ? i : p.cols + i),
                  edge && nky == ky, ky * (wh + 1) + kx, k, gain);
  }
  __syncthreads();
  fc::mixed_lines<true, false>(z, p.mh, cw, m.tw, m.lay + 2, m.lay[1]);

#pragma unroll 4
  for (int q = threadIdx.x; q < p.h * cw; q += kThreads) {
    const int s = by_cw.div(q), tc = q - s * cw;
    const int kx = group_bin(tc, c0, own, p);
    if (kx < 0) continue;
    float2 v = z[s * ld + tc];
    if (!BACKWARD && fold_h && s <= p.h - 2) v = fc::cadd(v, z[(s + p.h) * ld + tc]);
    img[(size_t)s * p.mw + kx] = v;
  }
}

// Rows of S into a tile at the layout's positions, for the inverse row
// passes: tile row ly reads S's row row_of(y0 + ly).  The block barrier
// first makes the layout that fc::load_mixed is copying visible.
template <class RowOf>
__device__ __forceinline__ void load_spectrum_rows(float2* z, const float2* img, int y0, int n,
                                                   const Plan& p, const fc::MixedGeom& m,
                                                   RowOf row_of) {
  __syncthreads();
  const int ld = fc::pitch(p.mw);
  const int* pw = pos_w(m, p);
  const fc::FastDiv by_mw(p.mw);
#pragma unroll 4
  for (int q = threadIdx.x; q < n * p.mw; q += kThreads) {
    const int ly = by_mw.div(q), kx = q - ly * p.mw;
    z[ly * ld + pw[kx]] = img[(size_t)row_of(y0 + ly) * p.mw + kx];
  }
}

// Launch 4: the inverse row passes of the rows of S that image rows [y0,
// y0 + n) read, the readout (shift and, along a padded W axis, fold) and the
// tile's lnL partial sum into partials (B, row_tiles), float64.  RESID: each
// pixel's weights (a, c) and the tile's peaks of |a| and |c| into maxes (B,
// row_tiles, 2), as convolve_and_reduce forms them.
template <bool RESID>
__global__ void __launch_bounds__(kThreads)
readout_kernel(const float* __restrict__ peaks, Plan p, const float2* __restrict__ twiddle,
               const int* __restrict__ layout, fc::Spectra ks, fc::Data ds, int per_target,
               size_t data_stride, size_t spectra_stride, const float2* __restrict__ scratch,
               double* __restrict__ partials, float* __restrict__ maxes,
               float2* __restrict__ weights) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double partial[kWarps];
  __shared__ float wmax[2 * kWarps];
  const int b = blockIdx.x, t = blockIdx.y, tiles = p.row_tiles();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* z = reinterpret_cast<float2*>(smem);
  const int ld = fc::pitch(p.mw);
  const fc::MixedGeom m = fc::load_mixed(z + (size_t)p.rows * ld, twiddle, layout, p.mh, p.mw);
  const int y0 = t * p.rows, n = min(p.rows, p.h - y0);
  const int se = walker_scale_exp(peaks + (size_t)b * tiles, tiles);
  const int h = p.h, w = p.w;
  load_spectrum_rows(z, scratch + (size_t)b * h * p.mw, y0, n, p, m, [h](int y) {
    const int s = y + h / 2;
    return s >= h ? s - h : s;
  });
  __syncthreads();
  tile_rows<true>(z, n, p, m);

  const int tgt = b / per_target;
  const fc::Spectra k = fc::target_spectra(ks, tgt, spectra_stride);
  const fc::Data d = fc::target_data(ds, tgt, data_stride);
  const float conv_scale = 1.0f / (float)(p.mh * p.mw);
  const float mvar_scale = ldexpf(conv_scale, se) / __ldg(k.var_gain);
  const bool fold_w = p.mw != w;
  const fc::FastDiv by_w(w);
  float2* wts = RESID ? weights + (size_t)b * h * w : nullptr;
  double sum = 0.0;
  float amax = 0.0f, cmax = 0.0f;
#pragma unroll 4
  for (int q = threadIdx.x; q < n * w; q += kThreads) {
    const int ly = by_w.div(q), x = q - ly * w;
    const int px = (y0 + ly) * w + x;
    int sx = x + w / 2;
    if (sx >= w) sx -= w;
    float2 c = z[ly * ld + sx];
    if (fold_w && sx < w - 1) c = fc::cadd(c, z[ly * ld + sx + w]);
    const float conv = c.x * conv_scale, mvar = c.y * mvar_scale;
    const float ivm = 1.0f / (mvar + __ldg(d.obs_var + px));
    const float resid = __ldg(d.obs + px) - conv;
    const bool good = __ldg(d.good + px) > 0.0f;
    if constexpr (RESID) {  // before the term: see convolve_and_reduce
      const float ri = __fmul_rn(resid, ivm);
      const float a = good ? ri : 0.0f;
      const float cwt = good ? __fmul_rn(0.5f, __fsub_rn(__fmul_rn(ri, ri), ivm)) : 0.0f;
      wts[px] = make_float2(a, cwt);
      amax = fmaxf(amax, fabsf(a));
      cmax = fmaxf(cmax, fabsf(cwt));
    }
    const float safe_ivm = good ? ivm : 1.0f;
    const float term = resid * resid * ivm - logf(fc::kInv2Pi * safe_ivm);
    if (good) sum += (double)(-0.5f * term);
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) partial[warp] = sum;
  if constexpr (RESID) {
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    }
    if (lane == 0) {
      wmax[warp] = amax;
      wmax[kWarps + warp] = cmax;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < kWarps; ++i) tot += partial[i];
    const size_t at = (size_t)b * tiles + t;
    partials[at] = tot;
    if constexpr (RESID) {
      float am = wmax[0], cm = wmax[kWarps];
      for (int i = 1; i < kWarps; ++i) {
        am = fmaxf(am, wmax[i]);
        cm = fmaxf(cm, wmax[kWarps + i]);
      }
      maxes[2 * at] = am;
      maxes[2 * at + 1] = cm;
    }
  }
}

// Launch 5: each walker's lnL from its tiles' partial sums, in tile order;
// RESID: its scale exponent from the tiles' weight peaks.
template <bool RESID>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const double* __restrict__ partials, const float* __restrict__ maxes, int batch,
              int tiles, float* __restrict__ out, int* __restrict__ scale_exp) {
  const int b = blockIdx.x * kReduceThreads + threadIdx.x;
  if (b >= batch) return;
  const double* part = partials + (size_t)b * tiles;
  double tot = 0.0;
  for (int i = 0; i < tiles; ++i) tot += part[i];
  const float r = (float)tot;
  out[b] = isfinite(r) ? r : -INFINITY;
  if constexpr (RESID) {
    const float* mx = maxes + 2 * (size_t)b * tiles;
    float am = mx[0], cm = mx[1];
    for (int i = 1; i < tiles; ++i) {
      am = fmaxf(am, mx[2 * i]);
      cm = fmaxf(cm, mx[2 * i + 1]);
    }
    const bool ok = am > 0.0f && isfinite(am) && cm > 0.0f && isfinite(cm);
    const int e = ok ? ilogbf(am) - ilogbf(cm) : 0;
    scale_exp[b] = max(-fc::kMaxScaleExp, min(fc::kMaxScaleExp, e));
  }
}

// The backward's last launch: the inverse row passes of S's rows [y0, y0 +
// n) (the crop: image rows read themselves), then grad_b [a (x) psf + 2 raw
// (c (x) var)] (cluster_backward's combine); 0 for a walker whose lnl is not
// finite.
__global__ void __launch_bounds__(kThreads)
rows_backward_kernel(const float* __restrict__ raws, const int* __restrict__ scale_exp,
                     const float* __restrict__ lnl, const float* __restrict__ grad, Plan p,
                     const float2* __restrict__ twiddle, const int* __restrict__ layout,
                     fc::Spectra kcs, int per_target, size_t spectra_stride,
                     const float2* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, t = blockIdx.y;
  const int y0 = t * p.rows, n = min(p.rows, p.h - y0), w = p.w;
  float* o = out + ((size_t)b * p.h + y0) * w;
  if (!isfinite(__ldg(lnl + b))) {  // the same for the whole block
    for (int q = threadIdx.x; q < n * w; q += kThreads) o[q] = 0.0f;
    return;
  }
  float2* z = reinterpret_cast<float2*>(smem);
  const int ld = fc::pitch(p.mw);
  const fc::MixedGeom m = fc::load_mixed(z + (size_t)p.rows * ld, twiddle, layout, p.mh, p.mw);
  load_spectrum_rows(z, scratch + (size_t)b * p.h * p.mw, y0, n, p, m, [](int y) { return y; });
  __syncthreads();
  tile_rows<true>(z, n, p, m);

  const fc::Spectra kc = fc::target_spectra(kcs, b / per_target, spectra_stride);
  const int se = __ldg(scale_exp + b);
  const float gb = __ldg(grad + b);
  const float conv_scale = 1.0f / (float)(p.mh * p.mw);
  const float c_scale = ldexpf(conv_scale, -se) / __ldg(kc.var_gain);
  const float* raw = raws + ((size_t)b * p.h + y0) * w;
  const fc::FastDiv by_w(w);
#pragma unroll 4
  for (int q = threadIdx.x; q < n * w; q += kThreads) {
    const int ly = by_w.div(q), x = q - ly * w;
    const float2 v = z[ly * ld + x];
    const float ga = v.x * conv_scale, gc = v.y * c_scale;
    o[q] = gb * (ga + 2.0f * __ldg(raw + q) * gc);
  }
}

template <class Kernel>
inline int set_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  return 0;
}

// The forward's launches 2-5 (and 1 unless the peaks are already written:
// the fused kernel's render pass writes them).  Scratch: S (B, H, M_w)
// float2, peaks (B, row_tiles) float, partials (B, row_tiles) double and,
// RESID, maxes (B, row_tiles, 2) float.  Returns 0 or the first cudaError.
template <bool RESID>
inline int launch_forward(const float* raws, bool peaks_written, int batch, const Plan& p,
                          const float2* twiddle, const int* layout, const fc::Spectra& ks,
                          const fc::Data& ds, int per_target, size_t data_stride,
                          size_t spectra_stride, float2* scratch, float* peaks,
                          double* partials, float* maxes, float* out, float2* weights,
                          int* scale_exp, cudaStream_t stream) {
  const dim3 tiles((unsigned)batch, (unsigned)p.row_tiles());
  const dim3 groups((unsigned)batch, (unsigned)p.col_groups());
  int err;
  if ((err = set_smem(&rows_forward_kernel<false>, row_smem(p))) ||
      (err = set_smem(&columns_kernel<false>, column_smem(p))) ||
      (err = set_smem(&readout_kernel<RESID>, row_smem(p))))
    return err;
  if (!peaks_written) {
    peak_kernel<<<tiles, kThreads, 0, stream>>>(raws, p, peaks);
    if ((err = (int)cudaGetLastError())) return err;
  }
  rows_forward_kernel<false><<<tiles, kThreads, row_smem(p), stream>>>(
      raws, peaks, nullptr, nullptr, nullptr, p, twiddle, layout, scratch);
  if ((err = (int)cudaGetLastError())) return err;
  columns_kernel<false><<<groups, kThreads, column_smem(p), stream>>>(
      p, twiddle, layout, ks, per_target, spectra_stride, nullptr, scratch);
  if ((err = (int)cudaGetLastError())) return err;
  readout_kernel<RESID><<<tiles, kThreads, row_smem(p), stream>>>(
      peaks, p, twiddle, layout, ks, ds, per_target, data_stride, spectra_stride, scratch,
      partials, maxes, weights);
  if ((err = (int)cudaGetLastError())) return err;
  reduce_kernel<RESID><<<tiles_of(batch, kReduceThreads), kReduceThreads, 0, stream>>>(
      partials, maxes, batch, p.row_tiles(), out, scale_exp);
  return (int)cudaGetLastError();
}

// The backward's three launches from the forward's weights and scale
// exponents, kcs the conjugate spectra; S (B, H, M_w) float2 scratch.
inline int launch_backward(const float* raws, int batch, const Plan& p, const float2* twiddle,
                           const int* layout, const fc::Spectra& kcs, int per_target,
                           size_t spectra_stride, const float2* weights, const int* scale_exp,
                           const float* lnl, const float* grad, float2* scratch, float* out,
                           cudaStream_t stream) {
  const dim3 tiles((unsigned)batch, (unsigned)p.row_tiles());
  const dim3 groups((unsigned)batch, (unsigned)p.col_groups());
  int err;
  if ((err = set_smem(&rows_forward_kernel<true>, row_smem(p))) ||
      (err = set_smem(&columns_kernel<true>, column_smem(p))) ||
      (err = set_smem(&rows_backward_kernel, row_smem(p))))
    return err;
  rows_forward_kernel<true><<<tiles, kThreads, row_smem(p), stream>>>(
      nullptr, nullptr, weights, scale_exp, lnl, p, twiddle, layout, scratch);
  if ((err = (int)cudaGetLastError())) return err;
  columns_kernel<true><<<groups, kThreads, column_smem(p), stream>>>(
      p, twiddle, layout, kcs, per_target, spectra_stride, lnl, scratch);
  if ((err = (int)cudaGetLastError())) return err;
  rows_backward_kernel<<<tiles, kThreads, row_smem(p), stream>>>(
      raws, scale_exp, lnl, grad, p, twiddle, layout, kcs, per_target, spectra_stride, scratch,
      out);
  return (int)cudaGetLastError();
}

}  // namespace fftglobal
}  // namespace psfmc
