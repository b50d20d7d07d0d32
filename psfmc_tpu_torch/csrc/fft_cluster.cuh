// conv_lnl's cluster route: fft_conv.cuh's complex FFT pair of one walker
// held across the shared memory of a thread-block cluster of C = 2, 4 or 8
// blocks (Hopper's distributed shared memory), for the transforms that fit
// no single block (conv_lnl.py's cluster_size: 88x88 -> 180x180, 94x94 ->
// 192x192, 101x101 -> 210x210, 160x180, 196x196 and 200x200 on 2 blocks,
// 256x256 on 4; transforms up to about 470 a side on 8).  Shared by
// conv_lnl.cu (the forward and its residual instantiation),
// conv_lnl_backward.cu and fused_lnl.cu (its cluster route).
//
// What it computes is the padded route's scheme (fft_conv.cuh's
// PaddedGeom; psfmc_tpu_torch.ops.kernels.conv_lnl.padded_fft_conv_plain)
// at the transform M_h x M_w = padded_shape(H, W): the image's own sides
// where they are even with no prime factor above 7, 2N - 1 padded to such a
// side otherwise.  Both sides are planned on the mixed-radix geometry (a
// power of two as radix-2 passes of it), so that one instantiation serves
// every shape and the pair step reads bins through the layout's tables.
//
// Layout.  Rank r of the cluster holds rows [r R, r R + R) of the
// transform (R = ceil(M_h / C); the last rank may hold fewer) at the row
// pitch M_w + 1 in its own shared memory, then both axes' twiddle tables
// and the layout, as MixedGeom keeps them.  Schedule (one cluster a
// walker, 512 threads a block):
//   1. each rank loads and pads its rows, the real parts (conv_lnl;
//      cluster_load_rows; the fused kernel renders there instead); the
//      peak |raw| of every rank, read through distributed shared memory
//      after a cluster barrier, gives the squared image's scale; the pack;
//   2. the row passes on its own rows (mixed_lines, local shared memory);
//      cluster barrier;
//   3. the column passes: rank r owns columns [r Wc, r Wc + Wc) (Wc =
//      ceil(M_w / C)) and reads and writes every element of them in the
//      rank that holds its row (mapa + generic loads and stores), a cluster
//      barrier after each pass;
//   4. the pair step over its own row positions (mixed_pair_step's
//      ownership), the partner bin (-ky, -kx) in whichever rank holds it;
//      cluster barrier; the inverse column passes; the inverse row passes;
//      cluster barrier;
//   5. the readout of image rows [r Hc, r Hc + Hc) (Hc = ceil(H / C)):
//      each output pixel reads its shifted slot and, along a padded axis,
//      the fold's terms, in whichever rank holds them; the rank's lnL in
//      float64 (per thread, then warps in order) goes into rank 0's shared
//      memory; cluster barrier; rank 0 sums the ranks in order and writes
//      the walker's lnL (-inf if not finite).  The residual instantiation
//      also writes each pixel's weights (a, c) and the walker's scale
//      exponent from the weights' peaks, reduced over the ranks alike.
// The backward (cluster_backward) runs the same split: each rank copies the
// weights into its own rows' slots (the adjoint of the readout's shift and
// fold), the pair with the conjugate spectra, and the combine of its image
// rows.  A block never leaves while a peer may still read its shared
// memory: every access to a peer precedes a cluster barrier that all ranks
// pass.  Between two column passes only the owning rank's threads touch a
// column; the cluster barrier there is the ordering the programming guide
// gives for distributed shared memory.
//
// What bounds it: as on the single-block routes, arithmetic (one complex
// FFT pair of the transform per walker) against the bytes of the image,
// the data and the spectra; the column passes' traffic crosses the
// SM-to-SM network, (C - 1) / C of it remote.
//
// Numerics: the FFT route's (fp32, no --use_fast_math, the same scales and
// non-finite handling); the lnL is reduced in a fixed order, no atomics.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "fft_conv.cuh"

namespace psfmc {
namespace fftconv {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kClusterUnschedulable = -1;  // launch_cluster: no cluster fits

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory of one rank: R rows of the transform, both axes'
// twiddle tables and the layout (conv_lnl.py's cluster_smem_bytes).
inline size_t cluster_image_bytes(int mh, int mw, int ranks) {
  return sizeof(float2) * ((size_t)ceil_div(mh, ranks) * pitch(mw) +
                           twiddle_entries(mh) + twiddle_entries(mw)) +
         sizeof(int) * (size_t)layout_ints(mh, mw);
}

// The transform (mh, mw) of an (h, w) image split over `ranks` blocks; z
// holds this rank's rows, tw both axes' tables and lay the layout.
struct ClusterGeom {
  int h, w, mh, mw, ld;
  int rows, rank, ranks;
  int row0, nrows;  // this rank's rows of the transform
  int col0, ncols;  // the columns its column passes own
  int img0, nimg;   // the image rows it reads out
  bool fold_h, fold_w;
  FastDiv by_rows;
  float2* z;
  const float2* tw;
  const int* lay;

  __device__ ClusterGeom(int h_, int w_, int mh_, int mw_, int ranks_, float2* z_,
                         const float2* tw_, const int* lay_)
      : h(h_), w(w_), mh(mh_), mw(mw_), ld(pitch(mw_)), rows(ceil_div(mh_, ranks_)),
        rank((int)cg::this_cluster().block_rank()), ranks(ranks_),
        fold_h(mh_ != h_), fold_w(mw_ != w_), by_rows(ceil_div(mh_, ranks_)), z(z_),
        tw(tw_), lay(lay_) {
    row0 = rank * rows;
    nrows = min(rows, mh - row0);
    const int cols = ceil_div(mw, ranks);
    col0 = rank * cols;
    ncols = min(cols, mw - col0);
    const int hc = ceil_div(h, ranks);
    img0 = rank * hc;
    nimg = max(0, min(hc, h - img0));
  }

  // slot (y, x) of the transform, in the shared memory of the rank that
  // holds row y
  __device__ __forceinline__ float2* at(int y, int x) const {
    const int r = by_rows.div(y);
    return cg::this_cluster().map_shared_rank(z + (y - r * rows) * ld + x, r);
  }

  // what output pixel (y, x) reads: slot ((y + h/2) mod h, (x + w/2) mod
  // w) and, along a padded axis where that slot s <= N - 2, also s + N,
  // summed (z00 + z01) + (z10 + z11) as PaddedGeom::read sums them
  __device__ __forceinline__ float2 read(int y, int x) const {
    y += h / 2;
    x += w / 2;
    if (y >= h) y -= h;
    if (x >= w) x -= w;
    const float2* q = at(y, x);
    const bool fx = fold_w && x < w - 1, fy = fold_h && y < h - 1;
    float2 v = q[0];
    if (fx) v = cadd(v, q[w]);
    if (fy) {
      const float2* u = at(y + h, x);
      float2 t = u[0];
      if (fx) t = cadd(t, u[w]);
      v = cadd(v, t);
    }
    return v;
  }
};

// This rank's geometry; starts copying both twiddle tables and the layout
// into shared memory after its rows (a block barrier before the first pass
// makes them visible).
__device__ inline ClusterGeom load_cluster(unsigned char* smem, int h, int w, int mh,
                                           int mw, int ranks, const float2* table,
                                           const int* layout) {
  float2* z = reinterpret_cast<float2*>(smem);
  float2* tw = z + (size_t)ceil_div(mh, ranks) * pitch(mw);
  const MixedGeom m = load_mixed(tw, table, layout, mh, mw);
  return ClusterGeom(h, w, mh, mw, ranks, z, m.tw, m.lay);
}

// The row passes of this rank's rows (the W axis's table and codes).
template <bool INVERSE, bool SCALE = false>
__device__ void cluster_rows(const ClusterGeom& g, float ys = 1.0f) {
  mixed_lines<INVERSE, true, SCALE>(g.z, g.nrows, g.mw, g.tw + g.lay[0],
                                    g.lay + 3 + kMaxPasses, g.lay[2 + kMaxPasses], ys);
}

// One column pass (mixed_pass's work items and butterflies) over the
// columns this rank owns, each element in the rank that holds its row.
template <int ODD, int K, bool INVERSE>
__device__ void cluster_column_pass(const ClusterGeom& g, int len) {
  constexpr int P = ODD << K;
  const int n = g.mh, mp = len / P, tws = n / len;
  const FastDiv by_lines(g.ncols), by_mp(mp);
  const int items = g.ncols * (n / P);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int q = by_lines.div(item), line = item - q * g.ncols;
    const int blk = by_mp.div(q), j = q - blk * mp;
    const int base = blk * len + j, x = g.col0 + line;
    float2* p[P];
    float2 v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      p[r] = g.at(base + r * mp, x);
      v[r] = *p[r];
    }
    mixed_butterflies<ODD, K, INVERSE>(v, g.tw, j, mp, tws);
#pragma unroll
    for (int r = 0; r < P; ++r) *p[r] = v[r];
  }
}

template <bool INVERSE>
__device__ __forceinline__ void cluster_column_pass_of(int code, const ClusterGeom& g,
                                                       int len) {
  switch (code) {
    case 0x11: cluster_column_pass<1, 1, INVERSE>(g, len); break;
    case 0x12: cluster_column_pass<1, 2, INVERSE>(g, len); break;
    case 0x13: cluster_column_pass<1, 3, INVERSE>(g, len); break;
    case 0x14: cluster_column_pass<1, 4, INVERSE>(g, len); break;
    case 0x30: cluster_column_pass<3, 0, INVERSE>(g, len); break;
    case 0x31: cluster_column_pass<3, 1, INVERSE>(g, len); break;
    case 0x32: cluster_column_pass<3, 2, INVERSE>(g, len); break;
    case 0x50: cluster_column_pass<5, 0, INVERSE>(g, len); break;
    case 0x51: cluster_column_pass<5, 1, INVERSE>(g, len); break;
    case 0x70: cluster_column_pass<7, 0, INVERSE>(g, len); break;
    case 0x71: cluster_column_pass<7, 1, INVERSE>(g, len); break;
    default: __trap();  // a code the host's planner never writes
  }
}

// Every column pass (the H axis's codes, mixed_lines's order), each
// followed by a cluster barrier.
template <bool INVERSE>
__device__ void cluster_columns(const ClusterGeom& g) {
  const int npass = g.lay[1];
  const int* codes = g.lay + 2;
  int len = INVERSE ? 1 : g.mh;
  for (int pp = 0; pp < npass; ++pp) {
    const int code = codes[INVERSE ? npass - 1 - pp : pp];
    const int elems = (code >> 4) << (code & 15);
    if (INVERSE) len *= elems;
    cluster_column_pass_of<INVERSE>(code, g, len);
    if (!INVERSE) len /= elems;
    cg::this_cluster().sync();
  }
}

// mixed_pair_step over this rank's row positions: the thread that walks
// bin k owns the pair (k, -k) (kx = 0 where ky <= H/2; the column kx = W/2
// once for ky <= H/2, by the rank that holds its row); the partner is read
// and written in whichever rank holds it.
__device__ inline void cluster_pair_step(const ClusterGeom& g, const Spectra& k) {
  const int h = g.mh, w = g.mw, wh = w / 2, w2 = wh + 1;
  const int* pos_h = g.lay + kLayoutHeader;
  const int* bin_h = pos_h + h;
  const int* pos_w = bin_h + h;
  const int* bin_w = pos_w + w;
  const float gain = __ldg(k.var_gain);
  const FastDiv by_wh(wh);
#pragma unroll 4
  for (int t = threadIdx.x; t < g.nrows * wh; t += kThreads) {
    const int lr = by_wh.div(t), c = 2 * (t - lr * wh);
    const int ky = bin_h[g.row0 + lr], kx = bin_w[c];
    if (kx == 0 && ky > h / 2) continue;
    const int nky = ky ? h - ky : 0, nkx = kx ? w - kx : 0;
    pair_ptrs(g.z + lr * g.ld + c, g.at(pos_h[nky], pos_w[nkx]),
              nky == ky && nkx == kx, ky * w2 + kx, k, gain);
  }
  const int half = pos_w[wh];
  for (int ky = threadIdx.x; ky <= h / 2; ky += kThreads) {
    const int r = pos_h[ky] - g.row0;
    if (r < 0 || r >= g.nrows) continue;
    const int nky = ky ? h - ky : 0;
    pair_ptrs(g.z + r * g.ld + half, g.at(pos_h[nky], half), nky == ky, ky * w2 + wh,
              k, gain);
  }
}

// Step 1's load (conv_lnl's): this rank's rows of the walker's raw image
// from global memory, the image's pixels, zeros elsewhere; returns the
// largest |raw| this thread read.
__device__ inline float cluster_load_rows(const ClusterGeom& g, const float* raw) {
  const int mw = g.mw, ld = g.ld;
  const FastDiv by_mw(mw);
  float mx = 0.0f;
#pragma unroll 4
  for (int q = threadIdx.x; q < g.nrows * mw; q += kThreads) {
    const int ly = by_mw.div(q), x = q - ly * mw, y = g.row0 + ly;
    const float v = (y < g.h && x < g.w) ? __ldg(raw + y * g.w + x) : 0.0f;
    g.z[ly * ld + x] = make_float2(v, 0.0f);
    mx = fmaxf(mx, fabsf(v));
  }
  return mx;
}

// The forward from the walker's raw image, in the real parts of the
// transform's slots (zeros outside the image; written by this block's
// threads before the call, or by a peer's before a cluster barrier that
// both passed; `local_max` the largest |raw| this thread wrote), to its lnL
// in *out (rank 0 writes it); RESID as convolve_and_reduce's.  The
// imaginary parts need not be initialised: the pack writes them all.
template <bool RESID>
__device__ void cluster_convolve_and_reduce(const ClusterGeom& g, float local_max,
                                            const Spectra& k, const Data& d, float* out,
                                            float2* weights, int* scale_exp) {
  __shared__ float maxes[RESID ? 3 * kWarps : kWarps];
  __shared__ double partial[kWarps];
  __shared__ float peak;                         // this rank's largest |raw|
  __shared__ double rank_sums[kMaxCluster];      // rank 0's: each rank's lnL
  __shared__ float rank_peaks[2 * kMaxCluster];  // ... and its weights' peaks
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mw = g.mw, ld = g.ld;
  const FastDiv by_mw(mw);

  float mx = local_max;
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) maxes[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = maxes[0];
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, maxes[i]);
    peak = m;
  }
  cluster.sync();  // also: every block of the cluster has started
  mx = 0.0f;
  for (int r = 0; r < g.ranks; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&peak, r));
  int se = 0;
  if (mx > 0.0f && isfinite(mx))
    se = max(-kMaxScaleExp, min(kMaxScaleExp, ilogbf(mx)));
  const float s = ldexpf(1.0f, -se);
  for (int q = threadIdx.x; q < g.nrows * mw; q += kThreads) {
    const int ly = by_mw.div(q);
    float2* p = g.z + ly * ld + (q - ly * mw);
    const float x = p->x;
    p->y = s * (x * x);
  }
  __syncthreads();

  cluster_rows<false>(g);
  cluster.sync();
  cluster_columns<false>(g);
  cluster_pair_step(g, k);
  cluster.sync();
  cluster_columns<true>(g);
  cluster_rows<true>(g);
  cluster.sync();

  const float conv_scale = 1.0f / (float)(g.mh * g.mw);
  const float mvar_scale = ldexpf(conv_scale, se) / __ldg(k.var_gain);
  const FastDiv by_w(g.w);
  double sum = 0.0;
  float amax = 0.0f, cmax = 0.0f;
#pragma unroll 4
  for (int t = threadIdx.x; t < g.nimg * g.w; t += kThreads) {
    const int ly = by_w.div(t), x = t - ly * g.w, y = g.img0 + ly;
    const int p = y * g.w + x;
    const float2 c = g.read(y, x);
    const float conv = c.x * conv_scale, mvar = c.y * mvar_scale;
    const float ivm = 1.0f / (mvar + __ldg(d.obs_var + p));
    const float resid = __ldg(d.obs + p) - conv;
    const bool good = __ldg(d.good + p) > 0.0f;
    if constexpr (RESID) {  // before the term: see convolve_and_reduce
      const float ri = __fmul_rn(resid, ivm);
      const float a = good ? ri : 0.0f;
      const float cw = good ? __fmul_rn(0.5f, __fsub_rn(__fmul_rn(ri, ri), ivm)) : 0.0f;
      weights[p] = make_float2(a, cw);
      amax = fmaxf(amax, fabsf(a));
      cmax = fmaxf(cmax, fabsf(cw));
    }
    const float safe_ivm = good ? ivm : 1.0f;
    const float term = resid * resid * ivm - logf(kInv2Pi * safe_ivm);
    if (good) sum += (double)(-0.5f * term);
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) partial[warp] = sum;
  if constexpr (RESID) {
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    }
    if (lane == 0) {
      maxes[kWarps + warp] = amax;
      maxes[2 * kWarps + warp] = cmax;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < kWarps; ++i) tot += partial[i];
    *cluster.map_shared_rank(&rank_sums[g.rank], 0) = tot;
    if constexpr (RESID) {
      float am = maxes[kWarps], cm = maxes[2 * kWarps];
      for (int i = 1; i < kWarps; ++i) {
        am = fmaxf(am, maxes[kWarps + i]);
        cm = fmaxf(cm, maxes[2 * kWarps + i]);
      }
      *cluster.map_shared_rank(&rank_peaks[g.rank], 0) = am;
      *cluster.map_shared_rank(&rank_peaks[kMaxCluster + g.rank], 0) = cm;
    }
  }
  cluster.sync();
  if (g.rank == 0 && threadIdx.x == 0) {
    double tot = 0.0;
    for (int r = 0; r < g.ranks; ++r) tot += rank_sums[r];
    const float r = (float)tot;
    *out = isfinite(r) ? r : -INFINITY;
    if constexpr (RESID) {
      float am = rank_peaks[0], cm = rank_peaks[kMaxCluster];
      for (int i = 1; i < g.ranks; ++i) {
        am = fmaxf(am, rank_peaks[i]);
        cm = fmaxf(cm, rank_peaks[kMaxCluster + i]);
      }
      const bool ok = am > 0.0f && isfinite(am) && cm > 0.0f && isfinite(cm);
      const int e = ok ? ilogbf(am) - ilogbf(cm) : 0;
      *scale_exp = max(-kMaxScaleExp, min(kMaxScaleExp, e));
    }
  }
}

// The backward of one walker from its weights (conv_lnl_backward.cu's
// steps 1-3 on the cluster's split): the weights into this rank's rows at
// the slots the forward's readout read them from (copy_weights on
// PaddedGeom, its zeros elsewhere), the pair with the conjugate spectra kc
// (the first row pass scaling the imaginary parts by 2^se), and the combine
// of this rank's image rows into o.
__device__ inline void cluster_backward(const ClusterGeom& g, const float* raw,
                                        const float2* wts, const Spectra& kc, int se,
                                        float gb, float* o) {
  cg::cluster_group cluster = cg::this_cluster();
  const int h = g.h, w = g.w, mw = g.mw;
  const FastDiv by_mw(mw);
  for (int q = threadIdx.x; q < g.nrows * mw; q += kThreads) {
    const int ly = by_mw.div(q), tx = q - ly * mw, ty = g.row0 + ly;
    float2* dst = g.z + ly * g.ld + tx;
    if (ty <= 2 * h - 2 && tx <= 2 * w - 2) {
      int y = (ty < h ? ty : ty - h) - h / 2, x = (tx < w ? tx : tx - w) - w / 2;
      if (y < 0) y += h;
      if (x < 0) x += w;
      __pipeline_memcpy_async(dst, wts + y * w + x, sizeof(float2));
    } else {
      *dst = make_float2(0.0f, 0.0f);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  cluster_rows<false, true>(g, ldexpf(1.0f, se));
  cluster.sync();
  cluster_columns<false>(g);
  cluster_pair_step(g, kc);
  cluster.sync();
  cluster_columns<true>(g);
  cluster_rows<true>(g);
  cluster.sync();

  // grad_b [a (x) psf + 2 raw (c (x) var)] from the image's corner
  const float conv_scale = 1.0f / (float)(g.mh * g.mw);
  const float c_scale = ldexpf(conv_scale, -se) / __ldg(kc.var_gain);
  const FastDiv by_w(w);
#pragma unroll 4
  for (int t = threadIdx.x; t < g.nimg * w; t += kThreads) {
    const int ly = by_w.div(t), x = t - ly * w, y = g.img0 + ly;
    const int p = y * w + x;
    const float2 v = *g.at(y, x);
    const float ga = v.x * conv_scale, gc = v.y * c_scale;
    o[p] = gb * (ga + 2.0f * __ldg(raw + p) * gc);
  }
  cluster.sync();  // no rank leaves while a peer still reads its rows
}

// A launch of `kernel` with one cluster of `ranks` blocks a walker and
// `smem` bytes of dynamic shared memory a block.  Returns 0, the cudaError
// of the attribute call or the launch, or kClusterUnschedulable where the
// launch was refused and cudaOccupancyMaxActiveClusters finds no such
// cluster fits the card.
template <class... Params, class... Args>
int launch_cluster(void (*kernel)(Params...), int batch, int ranks, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (ranks < 2 || ranks > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * (unsigned)ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    int clusters = 1;
    if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg) ==
            cudaSuccess &&
        clusters < 1)
      return kClusterUnschedulable;
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace fftconv
}  // namespace psfmc
