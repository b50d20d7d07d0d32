// The two circular convolutions of one walker as one complex 2-D FFT pair
// held in the block's shared memory, and the masked Gaussian lnL read out
// of it.  Shared by conv_lnl.cu and fused_lnl.cu (their FFT route, taken
// when H and W are powers of two and the walker fits in a block).
//
// What it computes, from the walker's raw image x already in shared
// memory (psfmc_tpu_torch.ops.kernels.conv_lnl.packed_fft_conv_plain is
// the same scheme in plain PyTorch, fft_stages_plain the same butterfly
// schedule):
//   z      = x + i s x^2                    one float2 image, in place
//   Z      = FFT2(z)
//   A(k)   = (Z(k) + conj Z(-k)) / 2        spectrum of x
//   B(k)   = (Z(k) - conj Z(-k)) / 2i       spectrum of s x^2
//   Y(k)   = A(k) Kpsf(k) + i B(k) g Kvar(k)
//   y      = IFFT2(Y) = conv + i s g mvar   (unnormalised, unshifted)
//   lnl    = -1/2 sum_good [(obs - conv)^2 ivm - log(ivm / 2 pi)],
//   ivm    = 1 / (mvar + obs_var)           (-inf if not finite)
// with the ifftshift, the 1/(H W) and the 1/(s g) folded into the readout.
//
// Both scales are powers of two (exact in fp32).  In a float32 complex
// image the smaller part is only as exact as the larger part's rounding
// (the Hermitian split cancels, a butterfly mixes the parts), so the two
// parts are kept at one scale on both sides: s, taken from the block's
// max |x|, makes x and s x^2 peak alike; g, fixed by the host from the
// kernels' spectra at k = 0, lifts the PSF variance spectrum (1e-5 of
// the PSF's on the flagship) to the PSF spectrum's scale.  x * x is
// formed first, unscaled, so that it overflows exactly where the plain
// version's does.  fmaxf drops NaNs: the scale of a NaN walker does not
// matter, its lnL is -inf either way.
//
// The FFT: radix-2 butterflies, forward as decimation in frequency
// (natural order in, bit-reversed out), inverse as decimation in time
// (bit-reversed in, natural out), so no permutation pass is needed; the
// pointwise step addresses bin k at the bit-reversed index (__brev).  A
// pass keeps 2^R elements (R <= 4) of one line in a thread's registers and
// runs R consecutive stages on them, so a 128-point line costs two trips
// through shared memory per direction, not seven.  Twiddles come from a
// table exp(-2 pi i k / M), k < M/2, M = max(H, W), built on the host in
// float64 and copied to shared memory.
//
// What bounds it on the H100 (cycles of one block by phase, from the
// build with PSFMC_FFT_STAMPS, 128x128, NVIDIA H100 80GB HBM3 at 700 W):
// the eight register passes take about half (4,100 cycles each for 256 KB
// through shared memory, a quarter of its rate: with one block of 16
// warps on an SM the butterflies' instruction issue sets their pace); the
// lnL readout 0.29 (every block reads obs, obs_var and good, 192 KB, from
// L2 at the same moment, then a division and a logf per pixel); the
// pointwise step 0.13; load and pack 0.11.  The function's own bound is
// arithmetic (2.3 MFLOP per walker).
//
// Bank conflicts: the image is row-major float2 with a row pitch of W + 1.
// Column passes put consecutive lanes on consecutive columns (unit
// stride).  Row passes put consecutive lanes on consecutive rows of the
// same column: with the odd pitch, 16 lanes reading 8 bytes each touch
// all 32 banks once.  The twiddle reads are broadcasts (a warp shares its
// position within the line).  The pointwise step reads bins at
// bit-reversed columns; it deals the lanes over the columns' top bits,
// which leaves a 2-way conflict (consecutive lanes on consecutive kx
// were 8-way at W = 128 and took 23% of conv_lnl's cycles).
// Every global read beside shared-memory stores (the raw image, the
// spectra, the data) is an ld.global.nc in a loop unrolled by four, so
// that several are in flight: with one block of 16 warps on an SM, a
// load that waits for the store before it leaves the memory latency bare.
//
// Numerics: true fp32, no --use_fast_math, no __sinf/__cosf/__expf/__logf,
// no tensor cores.  The lnL terms are summed in float64 per thread in a
// fixed order, then by warp shuffles and over the warps in order: no
// atomics, the same bits on every launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace psfmc {
namespace fftconv {

// With -DPSFMC_FFT_STAMPS (a second build that only chip_smoke.py
// --profile makes) block 0 records the SM's clock after every phase, each
// behind a block barrier; fft_phase_clocks copies the stamps out.  The
// normal build has none of it.
constexpr int kNumStamps = 10;
#ifdef PSFMC_FFT_STAMPS
__device__ long long g_stamps[kNumStamps];
#define PSFMC_STAMP(i)                                                  \
  do {                                                                  \
    __syncthreads();                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0)                            \
      psfmc::fftconv::g_stamps[i] = clock64();                          \
  } while (0)
#else
#define PSFMC_STAMP(i)
#endif

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;  // 512: 16 float2 in registers each
constexpr int kMaxStages = 4;          // radix-2 stages per register pass
constexpr int kMaxScaleExp = 96;       // |log2 s| is clamped to this
constexpr float kInv2Pi = 0.15915494309189535f;

struct Spectra {  // half spectra (H, W/2+1), real and imaginary planes
  const float *psf_r, *psf_i, *var_r, *var_i;
  const float* var_gain;  // one float: the power of two g
};

struct Data {  // (H, W)
  const float *obs, *obs_var, *good;
};

__host__ __device__ inline int pitch(int w) { return w + 1; }

inline bool power_of_two(int n) { return n >= 2 && (n & (n - 1)) == 0; }

// Dynamic shared memory of the image and the twiddle table.
inline size_t image_bytes(int h, int w) {
  return sizeof(float2) * ((size_t)h * pitch(w) + (size_t)(h > w ? h : w) / 2);
}

__device__ __forceinline__ int log2i(int n) { return 31 - __clz(n); }

__device__ __forceinline__ int bit_reverse(int k, int bits) {
  return (int)(__brev((unsigned)k) >> (32 - bits));
}

// R consecutive radix-2 stages, s0 .. s0 + R - 1 of the line's log2(N), on
// the 2^R elements base + r * stride that a thread holds; lo = base mod
// stride.  Stage s pairs elements h = N >> (s + 1) apart and uses the
// twiddle exp(-2 pi i j 2^s / N), j the lower element's index mod h.
template <int R, bool INVERSE>
__device__ __forceinline__ void butterflies(float2 (&v)[1 << R],
                                            const float2* tw, int lo,
                                            int stride_log2, int s0,
                                            int tw_shift) {
#pragma unroll
  for (int tt = 0; tt < R; ++tt) {
    const int t = INVERSE ? R - 1 - tt : tt;
    const int half = 1 << (R - 1 - t);
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      if (r & half) continue;
      const int j = lo + ((r & (half - 1)) << stride_log2);
      const float2 c = tw[(j << (s0 + t)) << tw_shift];
      const float2 a = v[r], b = v[r | half];
      if (!INVERSE) {  // (a + b, (a - b) w)
        const float dx = a.x - b.x, dy = a.y - b.y;
        v[r] = make_float2(a.x + b.x, a.y + b.y);
        v[r | half] = make_float2(dx * c.x - dy * c.y, dx * c.y + dy * c.x);
      } else {  // (a + b conj w, a - b conj w)
        const float bx = b.x * c.x + b.y * c.y, by = b.y * c.x - b.x * c.y;
        v[r] = make_float2(a.x + bx, a.y + by);
        v[r | half] = make_float2(a.x - bx, a.y - by);
      }
    }
  }
}

// One register pass over every line of the image: rows (ROWS, lines run
// along x) or columns.  Work items are (line, base); consecutive lanes
// take consecutive lines.
template <int R, bool INVERSE, bool ROWS>
__device__ void fft_pass(float2* z, int h, int w, int s0, const float2* tw,
                         int tw_shift) {
  const int n = ROWS ? w : h, lines = ROWS ? h : w;
  const int m = log2i(n), lines_log2 = log2i(lines);
  const int stride_log2 = m - s0 - R;
  const int ld = pitch(w);
  const int step = ROWS ? (1 << stride_log2) : (ld << stride_log2);
  const int items = lines << (m - R);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int line = item & (lines - 1);
    const int q = item >> lines_log2;
    const int lo = q & ((1 << stride_log2) - 1);
    const int base = ((q >> stride_log2) << (m - s0)) + lo;
    float2* p = ROWS ? z + line * ld + base : z + base * ld + line;
    float2 v[1 << R];
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) v[r] = p[r * step];
    butterflies<R, INVERSE>(v, tw, lo, stride_log2, s0, tw_shift);
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) p[r * step] = v[r];
  }
}

// All log2(N) stages of every row or every column, as ceil(log2 N / 4)
// register passes of nearly equal depth, each followed by a block barrier.
template <bool INVERSE, bool ROWS>
__device__ void fft_lines(float2* z, int h, int w, const float2* tw,
                          int tw_log2) {
  const int m = log2i(ROWS ? w : h);
  const int tw_shift = tw_log2 - m;
  const int npass = (m + kMaxStages - 1) / kMaxStages;
  const int depth = m / npass, extra = m % npass;
  for (int pp = 0; pp < npass; ++pp) {
    const int p = INVERSE ? npass - 1 - pp : pp;
    const int s0 = p * depth + min(p, extra);
    switch (depth + (p < extra ? 1 : 0)) {
      case 1: fft_pass<1, INVERSE, ROWS>(z, h, w, s0, tw, tw_shift); break;
      case 2: fft_pass<2, INVERSE, ROWS>(z, h, w, s0, tw, tw_shift); break;
      case 3: fft_pass<3, INVERSE, ROWS>(z, h, w, s0, tw, tw_shift); break;
      default: fft_pass<4, INVERSE, ROWS>(z, h, w, s0, tw, tw_shift); break;
    }
    __syncthreads();
  }
}

// Z -> Y for the pair of bins k = (ky, kx) and -k, in place, on the
// bit-reversed layout the forward passes leave; e = ky * (W/2+1) + kx
// indexes the half spectra.  K(-k) = conj K(k) gives the kernels' other
// half, so Y(-k) = conj P + i conj Q where Y(k) = P + i Q.
__device__ __forceinline__ void pair_bins(float2* z, int h, int w, int ky,
                                          int kx, int e, const Spectra& k,
                                          float gain) {
  const int ld = pitch(w), hb = log2i(h), wb = log2i(w);
  const int nky = (h - ky) & (h - 1), nkx = (w - kx) & (w - 1);
  const int p1 = bit_reverse(ky, hb) * ld + bit_reverse(kx, wb);
  const int p2 = bit_reverse(nky, hb) * ld + bit_reverse(nkx, wb);
  const float pr = __ldg(k.psf_r + e), pi = __ldg(k.psf_i + e);
  const float vr = gain * __ldg(k.var_r + e), vi = gain * __ldg(k.var_i + e);
  const float2 z1 = z[p1], z2 = z[p2];
  const float ar = 0.5f * (z1.x + z2.x), ai = 0.5f * (z1.y - z2.y);
  const float br = 0.5f * (z1.y + z2.y), bi = 0.5f * (z2.x - z1.x);
  const float Pr = ar * pr - ai * pi, Pi = ar * pi + ai * pr;
  const float Qr = br * vr - bi * vi, Qi = br * vi + bi * vr;
  z[p1] = make_float2(Pr - Qi, Pi + Qr);                // P + i Q
  if (p2 != p1) z[p2] = make_float2(Pr + Qi, Qr - Pi);  // conj P + i conj Q
}

// The pointwise step over the whole image.  The thread that owns bin k
// also writes bin -k, so each pair has exactly one owner: for 0 < kx <
// W/2 the partner lies in the other half; in the columns kx = 0 and kx =
// W/2 the bin with ky <= H/2 owns the pair, and the four self-paired bins
// are written once.  The spectra are read with ld.global.nc, which the
// compiler may hoist above the shared-memory stores of the bins before.
__device__ void pair_step(float2* z, int h, int w, const Spectra& k) {
  const int w2 = w / 2 + 1, wh = w / 2, whb = log2i(w) - 1;
  const float gain = __ldg(k.var_gain);
#pragma unroll 4
  for (int t = threadIdx.x; t < h * wh; t += kThreads) {  // kx < W/2
    const int ky = t >> whb, c = t & (wh - 1);
    // Bin kx sits at the bit-reversed column, whose bank is set by kx's
    // top bits: the lane's bits 1..3 go there (8 bank pairs, the most
    // that bins below W/2 reach), bits 0 and 4 stay kx's lowest, so that
    // a warp still reads the spectra as 16-byte runs.
    int kx = c;
    if (whb >= 5)
      kx = (c & 1) | (((c >> 4) & 1) << 1) | ((c >> 5) << 2) |
           (((c >> 1) & 7) << (whb - 3));
    if (kx == 0 && ky > h / 2) continue;
    pair_bins(z, h, w, ky, kx, ky * w2 + kx, k, gain);
  }
  for (int ky = threadIdx.x; ky <= h / 2; ky += kThreads)  // kx = W/2
    pair_bins(z, h, w, ky, wh, ky * w2 + wh, k, gain);
}

// From the raw image in the real parts of z (written by the block's
// threads before the call, `local_max` being the largest |raw| this thread
// wrote; the barrier of the max reduction makes the image visible to all)
// to the walker's lnL in *out.  tw is the table in shared memory.
__device__ void convolve_and_reduce(float2* z, int h, int w, const float2* tw,
                                    int tw_log2, float local_max,
                                    const Spectra& k, const Data& d,
                                    float* out) {
  __shared__ float maxes[kWarps];
  __shared__ double partial[kWarps];
  const int ld = pitch(w), wb = log2i(w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the power-of-two scale of the squared image
  float mx = local_max;
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) maxes[warp] = mx;
  __syncthreads();
  mx = maxes[0];
  for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, maxes[i]);
  int se = 0;
  if (mx > 0.0f && isfinite(mx))
    se = max(-kMaxScaleExp, min(kMaxScaleExp, ilogbf(mx)));
  const float s = ldexpf(1.0f, -se);
  for (int p = threadIdx.x; p < h * w; p += kThreads) {
    float2* q = z + (p >> wb) * ld + (p & (w - 1));
    const float x = q->x;
    q->y = s * (x * x);
  }
  __syncthreads();
  PSFMC_STAMP(2);

  fft_lines<false, true>(z, h, w, tw, tw_log2);
  PSFMC_STAMP(3);
  fft_lines<false, false>(z, h, w, tw, tw_log2);
  PSFMC_STAMP(4);
  pair_step(z, h, w, k);
  __syncthreads();
  PSFMC_STAMP(5);
  fft_lines<true, false>(z, h, w, tw, tw_log2);
  PSFMC_STAMP(6);
  fft_lines<true, true>(z, h, w, tw, tw_log2);
  PSFMC_STAMP(7);

  // output pixel (y, x) reads ((y + H/2) mod H, (x + W/2) mod W)
  const float conv_scale = 1.0f / (float)(h * w);
  const float mvar_scale = ldexpf(conv_scale, se) / __ldg(k.var_gain);
  double sum = 0.0;
#pragma unroll 4
  for (int p = threadIdx.x; p < h * w; p += kThreads) {
    const int y = p >> wb, x = p & (w - 1);
    const float2 c = z[((y + h / 2) & (h - 1)) * ld + ((x + w / 2) & (w - 1))];
    const float conv = c.x * conv_scale, mvar = c.y * mvar_scale;
    const float ivm = 1.0f / (mvar + __ldg(d.obs_var + p));
    const float resid = __ldg(d.obs + p) - conv;
    const bool g = __ldg(d.good + p) > 0.0f;
    const float safe_ivm = g ? ivm : 1.0f;
    const float term = resid * resid * ivm - logf(kInv2Pi * safe_ivm);
    if (g) sum += (double)(-0.5f * term);
  }
  PSFMC_STAMP(8);
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) partial[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < kWarps; ++i) tot += partial[i];
    const float r = (float)tot;
    *out = isfinite(r) ? r : -INFINITY;
  }
  PSFMC_STAMP(9);
}

// The table's M/2 entries from global into shared memory; a barrier
// before the first pass (convolve_and_reduce has one) makes them visible.
__device__ __forceinline__ void load_twiddles(float2* tw, const float2* table,
                                              int tw_log2) {
  for (int i = threadIdx.x; i < (1 << tw_log2) / 2; i += kThreads)
    tw[i] = table[i];
}

}  // namespace fftconv
}  // namespace psfmc

#ifdef PSFMC_FFT_STAMPS
// The clocks of the last launch's block 0: [0] at the kernel's start, then
// after the image is in shared memory (load or render), the pack, the
// forward rows, the forward columns, the pointwise step, the inverse
// columns, the inverse rows, the lnL readout, and the final reduction.
extern "C" int fft_phase_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(
      out, psfmc::fftconv::g_stamps,
      sizeof(long long) * psfmc::fftconv::kNumStamps);
}
#endif
