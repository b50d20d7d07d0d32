// The two circular convolutions of one walker as one complex 2-D FFT pair
// held in the block's shared memory, and the masked Gaussian lnL read out
// of it.  Shared by conv_lnl.cu and fused_lnl.cu (their FFT route, taken
// when the walker fits in a block and its sides are even with no prime
// factor above 7, and their padded route).
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
// Two geometries of the same scheme (the kernels are templates on it):
//
// Pow2Geom, both sides powers of two: radix-2 butterflies, forward as
// decimation in frequency (natural order in, bit-reversed out), inverse
// as decimation in time (bit-reversed in, natural out), so no permutation
// pass is needed; the pointwise step addresses bin k at the bit-reversed
// index (__brev).  A pass keeps 2^R elements (R <= 4) of one line in a
// thread's registers and runs R consecutive stages on them, so a
// 128-point line costs two trips through shared memory per direction,
// not seven.  Twiddles come from a table exp(-2 pi i k / M), k < M/2, M =
// max(H, W), built on the host in float64 and copied to shared memory.
//
// MixedGeom, every other even side with no prime factor above 7 (96 =
// 3 x 2^5, 100 = 5^2 x 2^2, 98 = 7^2 x 2, 120, 144, ...): the same two
// directions with radix-2, -3, -5 and -7 stages.  The host plans each axis
// (conv_lnl.py's fft_plan): every radix-3, -5 or -7 stage opens a register
// pass (the radix-7 stages first) and takes up to two (radix 3) or one
// (radix 5 and 7) radix-2 stages after it, at most 16 elements a thread;
// the radix-2 stages left over make passes of up to four; the last stage
// is radix 2.  96 runs [3 2 2][2 2 2], 100 [5 2][5 2], 144 [3 2 2][3 2 2],
// 98 [7][7 2]: two trips through shared memory per direction, as at 128.
// A stage of radix r on a sub-block of length L takes the elements L/r
// apart, their r-point DFT, then the twiddle exp(-2 pi i p j / L) on
// output p (the inverse: the conjugate twiddle, then the inverse DFT), so
// the forward leaves bin k at the digit reversal of k over the
// stage radices in the order they ran, and the inverse, running the
// stages backwards, reads that same layout.  The host builds the layout
// as small int tables (bin -> position and position -> bin, H + W ints
// each, beside the pass codes) and one twiddle table per axis (N entries
// of exp(-2 pi i k / N) for a side N that is not a power of two, N/2 for
// one that is), in float64, cast; the kernel copies them to shared memory
// next to the image.  Work items per pass are lines x N/P (P the pass's
// elements); the loop over them is ragged at its end, and the divisions
// by the line count and the stride are one multiply-high each (FastDiv).
// Because the last stage is radix 2, a bin's kx < W/2 exactly when its
// column position is even; the pointwise step walks positions (even
// columns, consecutive lanes two float2 apart: the same 2-way bound as
// the power-of-two step's swizzle) and looks the bins up in the tables.
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

// A batch of walkers may fit several targets (conv_lnl.cu's forward): target
// t's planes lie `stride` floats after target 0's, its spectra's variance
// gain `stride ? t : 0` floats; a stride of 0 shares one plane among all
// walkers.  The structs above stay the single-target ones, so the kernels
// that take no target (the residual and backward instantiations, the fused
// kernel) compile as before.
__device__ __forceinline__ Spectra target_spectra(const Spectra& k, int t,
                                                  size_t stride) {
  const size_t o = stride * (size_t)t;
  return Spectra{k.psf_r + o, k.psf_i + o, k.var_r + o, k.var_i + o,
                 k.var_gain + (stride ? t : 0)};
}

__device__ __forceinline__ Data target_data(const Data& d, int t, size_t stride) {
  const size_t o = stride * (size_t)t;
  return Data{d.obs + o, d.obs_var + o, d.good + o};
}

__host__ __device__ inline int pitch(int w) { return w + 1; }

__host__ __device__ inline bool power_of_two(int n) {
  return n >= 2 && (n & (n - 1)) == 0;
}

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
// take consecutive lines.  With SCALE the imaginary parts are multiplied
// by ys as they are read (the backward's scale of its second image).
template <int R, bool INVERSE, bool ROWS, bool SCALE = false>
__device__ void fft_pass(float2* z, int h, int w, int s0, const float2* tw,
                         int tw_shift, float ys = 1.0f) {
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
    if constexpr (SCALE) {
#pragma unroll
      for (int r = 0; r < (1 << R); ++r) v[r].y *= ys;
    }
    butterflies<R, INVERSE>(v, tw, lo, stride_log2, s0, tw_shift);
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) p[r * step] = v[r];
  }
}

// fft_pass of `stages` radix-2 stages (1 to 4).
template <bool INVERSE, bool ROWS, bool SCALE>
__device__ __forceinline__ void fft_pass_of(int stages, float2* z, int h,
                                            int w, int s0, const float2* tw,
                                            int tw_shift, float ys) {
  switch (stages) {
    case 1: fft_pass<1, INVERSE, ROWS, SCALE>(z, h, w, s0, tw, tw_shift, ys); break;
    case 2: fft_pass<2, INVERSE, ROWS, SCALE>(z, h, w, s0, tw, tw_shift, ys); break;
    case 3: fft_pass<3, INVERSE, ROWS, SCALE>(z, h, w, s0, tw, tw_shift, ys); break;
    default: fft_pass<4, INVERSE, ROWS, SCALE>(z, h, w, s0, tw, tw_shift, ys); break;
  }
}

// All log2(N) stages of every row or every column, as ceil(log2 N / 4)
// register passes of nearly equal depth, each followed by a block barrier.
// With SCALE the first pass multiplies the imaginary parts by ys as it
// reads them.
template <bool INVERSE, bool ROWS, bool SCALE = false>
__device__ void fft_lines(float2* z, int h, int w, const float2* tw,
                          int tw_log2, float ys = 1.0f) {
  const int m = log2i(ROWS ? w : h);
  const int tw_shift = tw_log2 - m;
  const int npass = (m + kMaxStages - 1) / kMaxStages;
  const int depth = m / npass, extra = m % npass;
  for (int pp = 0; pp < npass; ++pp) {
    const int p = INVERSE ? npass - 1 - pp : pp;
    const int s0 = p * depth + min(p, extra);
    const int stages = depth + (p < extra ? 1 : 0);
    if (SCALE && pp == 0)
      fft_pass_of<INVERSE, ROWS, SCALE>(stages, z, h, w, s0, tw, tw_shift, ys);
    else
      fft_pass_of<INVERSE, ROWS, false>(stages, z, h, w, s0, tw, tw_shift, 1.0f);
    __syncthreads();
  }
}

// Z -> Y for the pair of bins k and -k held at q1 and q2 (the same slot
// when `self`: a bin that is its own partner), in place; e = ky * (W/2+1)
// + kx indexes the half spectra.  K(-k) = conj K(k) gives the kernels'
// other half, so Y(-k) = conj P + i conj Q where Y(k) = P + i Q.
__device__ __forceinline__ void pair_ptrs(float2* q1, float2* q2, bool self,
                                          int e, const Spectra& k, float gain) {
  const float pr = __ldg(k.psf_r + e), pi = __ldg(k.psf_i + e);
  const float vr = gain * __ldg(k.var_r + e), vi = gain * __ldg(k.var_i + e);
  const float2 z1 = *q1, z2 = *q2;
  const float ar = 0.5f * (z1.x + z2.x), ai = 0.5f * (z1.y - z2.y);
  const float br = 0.5f * (z1.y + z2.y), bi = 0.5f * (z2.x - z1.x);
  const float Pr = ar * pr - ai * pi, Pi = ar * pi + ai * pr;
  const float Qr = br * vr - bi * vi, Qi = br * vi + bi * vr;
  *q1 = make_float2(Pr - Qi, Pi + Qr);                // P + i Q
  if (!self) *q2 = make_float2(Pr + Qi, Qr - Pi);     // conj P + i conj Q
}

// pair_ptrs for the bins at the positions p1 and p2 of the layout the
// forward passes leave in z.
__device__ __forceinline__ void pair_at(float2* z, int p1, int p2, int e,
                                        const Spectra& k, float gain) {
  pair_ptrs(z + p1, z + p2, p2 == p1, e, k, gain);
}

// pair_at for the bins (ky, kx) and -k on the bit-reversed layout.
__device__ __forceinline__ void pair_bins(float2* z, int h, int w, int ky,
                                          int kx, int e, const Spectra& k,
                                          float gain) {
  const int ld = pitch(w), hb = log2i(h), wb = log2i(w);
  const int nky = (h - ky) & (h - 1), nkx = (w - kx) & (w - 1);
  const int p1 = bit_reverse(ky, hb) * ld + bit_reverse(kx, wb);
  const int p2 = bit_reverse(nky, hb) * ld + bit_reverse(nkx, wb);
  pair_at(z, p1, p2, e, k, gain);
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

// ---- mixed radix: the geometry of sides with factors 2, 3, 5 and 7 ----

// The int tables of the layout (conv_lnl.py's fft_layout): [0] the first
// entry of W's twiddle table; [1] the passes along H, [2, 2 + kMaxPasses)
// their codes (16 x the odd radix + the radix-2 stages after it); [10]
// and [11, 19) the same along W; then H's bin -> position and position ->
// bin tables (H ints each), then W's (W each).
constexpr int kMaxPasses = 8;
constexpr int kLayoutHeader = 20;

__host__ __device__ inline int layout_ints(int h, int w) {
  return kLayoutHeader + 2 * (h + w);
}

__host__ __device__ inline int twiddle_entries(int n) {
  return power_of_two(n) ? n / 2 : n;
}

// Even, and no prime factor above 7.
inline bool seven_smooth_even(int n) {
  if (n < 2 || n % 2) return false;
  const int factors[4] = {2, 3, 5, 7};
  for (int f : factors)
    while (n % f == 0) n /= f;
  return n == 1;
}

// Dynamic shared memory of the image, both twiddle tables and the layout.
inline size_t mixed_image_bytes(int h, int w) {
  return sizeof(float2) * ((size_t)h * pitch(w) + twiddle_entries(h) +
                           twiddle_entries(w)) +
         sizeof(int) * (size_t)layout_ints(h, w);
}

// x / d for 0 <= x, d < 2^16 as one multiply-high: m = floor(2^32 / d) + 1
// is off by less than 1, so x m / 2^32 is off x / d by less than x / 2^32
// < 1 / d, too little to cross an integer.
struct FastDiv {
  unsigned m;
  int d;
  __device__ explicit FastDiv(int d_)
      : m(d_ > 1 ? 0xffffffffu / (unsigned)d_ + 1u : 0u), d(d_) {}
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : (int)__umulhi((unsigned)x, m);
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {  // a conj b
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cscale(float c, float2 a) {
  return make_float2(c * a.x, c * a.y);
}

// a - i sgn b and a + i sgn b: the two outputs of a conjugate pair of
// roots (sgn 1 forward, -1 inverse).
template <bool INVERSE>
__device__ __forceinline__ void rotate_pair(float2 a, float2 b, float2& lo,
                                            float2& hi) {
  const float bx = INVERSE ? -b.x : b.x, by = INVERSE ? -b.y : b.y;
  lo = make_float2(a.x + by, a.y - bx);
  hi = make_float2(a.x - by, a.y + bx);
}

// The R-point DFT in place, unnormalised: exp(-2 pi i p q / R) forward,
// its conjugate inverse.
template <int R, bool INVERSE>
__device__ __forceinline__ void small_dft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0], b = x[1];
    x[0] = cadd(a, b);
    x[1] = csub(a, b);
  } else if constexpr (R == 3) {
    constexpr float kS = 0.86602540378443864676f;  // sin(2 pi / 3)
    const float2 t = cadd(x[1], x[2]);
    const float2 m = csub(x[0], cscale(0.5f, t));
    x[0] = cadd(x[0], t);
    rotate_pair<INVERSE>(m, cscale(kS, csub(x[1], x[2])), x[1], x[2]);
  } else if constexpr (R == 5) {
    constexpr float kC1 = 0.30901699437494742410f;   // cos(2 pi / 5)
    constexpr float kC2 = -0.80901699437494742410f;  // cos(4 pi / 5)
    constexpr float kS1 = 0.95105651629515357212f;   // sin(2 pi / 5)
    constexpr float kS2 = 0.58778525229247312917f;   // sin(4 pi / 5)
    const float2 a1 = cadd(x[1], x[4]), b1 = csub(x[1], x[4]);
    const float2 a2 = cadd(x[2], x[3]), b2 = csub(x[2], x[3]);
    const float2 c1 = cadd(x[0], cadd(cscale(kC1, a1), cscale(kC2, a2)));
    const float2 c2 = cadd(x[0], cadd(cscale(kC2, a1), cscale(kC1, a2)));
    const float2 s1 = cadd(cscale(kS1, b1), cscale(kS2, b2));
    const float2 s2 = csub(cscale(kS2, b1), cscale(kS1, b2));
    x[0] = cadd(x[0], cadd(a1, a2));
    rotate_pair<INVERSE>(c1, s1, x[1], x[4]);
    rotate_pair<INVERSE>(c2, s2, x[2], x[3]);
  } else {
    static_assert(R == 7, "radix 2, 3, 5 or 7");
    constexpr float kC1 = 0.62348980185873353053f;   // cos(2 pi / 7)
    constexpr float kC2 = -0.22252093395631440429f;  // cos(4 pi / 7)
    constexpr float kC3 = -0.90096886790241912624f;  // cos(6 pi / 7)
    constexpr float kS1 = 0.78183148246802980871f;   // sin(2 pi / 7)
    constexpr float kS2 = 0.97492791218182360702f;   // sin(4 pi / 7)
    constexpr float kS3 = 0.43388373911755812048f;   // sin(6 pi / 7)
    const float2 a1 = cadd(x[1], x[6]), b1 = csub(x[1], x[6]);
    const float2 a2 = cadd(x[2], x[5]), b2 = csub(x[2], x[5]);
    const float2 a3 = cadd(x[3], x[4]), b3 = csub(x[3], x[4]);
    const float2 c1 = cadd(x[0], cadd(cadd(cscale(kC1, a1), cscale(kC2, a2)),
                                      cscale(kC3, a3)));
    const float2 c2 = cadd(x[0], cadd(cadd(cscale(kC2, a1), cscale(kC3, a2)),
                                      cscale(kC1, a3)));
    const float2 c3 = cadd(x[0], cadd(cadd(cscale(kC3, a1), cscale(kC1, a2)),
                                      cscale(kC2, a3)));
    const float2 s1 = cadd(cadd(cscale(kS1, b1), cscale(kS2, b2)), cscale(kS3, b3));
    const float2 s2 = csub(csub(cscale(kS2, b1), cscale(kS3, b2)), cscale(kS1, b3));
    const float2 s3 = cadd(csub(cscale(kS3, b1), cscale(kS1, b2)), cscale(kS2, b3));
    x[0] = cadd(x[0], cadd(cadd(a1, a2), a3));
    rotate_pair<INVERSE>(c1, s1, x[1], x[6]);
    rotate_pair<INVERSE>(c2, s2, x[2], x[5]);
    rotate_pair<INVERSE>(c3, s3, x[3], x[4]);
  }
}

// One stage of radix R on the P elements a thread holds, in blocks of T
// (the sub-block of the line, in units of the pass's stride mp): element
// i + q T/R of a block is digit q.  Forward: the DFT, then output p times
// tw[p e]; inverse: input p times conj tw[p e], then the inverse DFT.  e
// = (j + i mp) scale is the exponent of the stage's root exp(-2 pi i / L)
// in table entries (j the item's offset within the stride).
template <int R, int T, int P, bool INVERSE>
__device__ __forceinline__ void radix_stage(float2 (&v)[P], const float2* tw,
                                            int j, int mp, int scale) {
  constexpr int hs = T / R;
#pragma unroll
  for (int blk = 0; blk < P; blk += T) {
#pragma unroll
    for (int i = 0; i < hs; ++i) {
      const int e = (j + i * mp) * scale;
      float2 x[R];
#pragma unroll
      for (int q = 0; q < R; ++q) x[q] = v[blk + i + q * hs];
      if constexpr (INVERSE) {
#pragma unroll
        for (int p = 1; p < R; ++p) x[p] = cmul_conj(x[p], tw[p * e]);
      }
      small_dft<R, INVERSE>(x);
      if constexpr (!INVERSE) {
#pragma unroll
        for (int p = 1; p < R; ++p) x[p] = cmul(x[p], tw[p * e]);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) v[blk + i + q * hs] = x[q];
    }
  }
}

// The pass's radix-2 stages U .. K-1 (forward) or K-1 .. U (inverse).
template <int ODD, int K, int U, bool INVERSE>
__device__ __forceinline__ void two_stages(float2 (&v)[ODD << K],
                                           const float2* tw, int j, int mp,
                                           int tws) {
  if constexpr (U < K) {
    constexpr int P = ODD << K, T = (P / ODD) >> U;
    if constexpr (INVERSE) two_stages<ODD, K, U + 1, true>(v, tw, j, mp, tws);
    radix_stage<2, T, P, INVERSE>(v, tw, j, mp, tws * (ODD << U));
    if constexpr (!INVERSE) two_stages<ODD, K, U + 1, false>(v, tw, j, mp, tws);
  }
}

// A register pass of one stage of radix ODD (none if 1) and K radix-2
// stages after it; tws = N / L, L the sub-block length at its first stage.
template <int ODD, int K, bool INVERSE>
__device__ __forceinline__ void mixed_butterflies(float2 (&v)[ODD << K],
                                                  const float2* tw, int j,
                                                  int mp, int tws) {
  constexpr int P = ODD << K;
  if constexpr (!INVERSE && ODD > 1)
    radix_stage<ODD, P, P, false>(v, tw, j, mp, tws);
  two_stages<ODD, K, 0, INVERSE>(v, tw, j, mp, tws);
  if constexpr (INVERSE && ODD > 1)
    radix_stage<ODD, P, P, true>(v, tw, j, mp, tws);
}

// One register pass over every line (rows if ROWS) of length n.  Work items
// are (line, block, j): consecutive lanes take consecutive lines; the item
// holds the P elements block * len + j + r * mp of its line.
template <int ODD, int K, bool INVERSE, bool ROWS, bool SCALE = false>
__device__ void mixed_pass(float2* z, int n, int lines, int ld, int len,
                           const float2* tw, float ys = 1.0f) {
  constexpr int P = ODD << K;
  const int mp = len / P, tws = n / len;
  const FastDiv by_lines(lines), by_mp(mp);
  const int items = lines * (n / P);
  const int step = ROWS ? mp : mp * ld;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int q = by_lines.div(item), line = item - q * lines;
    const int blk = by_mp.div(q), j = q - blk * mp;
    const int base = blk * len + j;
    float2* p = ROWS ? z + line * ld + base : z + base * ld + line;
    float2 v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) v[r] = p[r * step];
    if constexpr (SCALE) {
#pragma unroll
      for (int r = 0; r < P; ++r) v[r].y *= ys;
    }
    mixed_butterflies<ODD, K, INVERSE>(v, tw, j, mp, tws);
#pragma unroll
    for (int r = 0; r < P; ++r) p[r * step] = v[r];
  }
}

// mixed_pass of the pass code `code`.
template <bool INVERSE, bool ROWS, bool SCALE>
__device__ __forceinline__ void mixed_pass_of(int code, float2* z, int n,
                                              int lines, int ld, int len,
                                              const float2* tw, float ys) {
  switch (code) {
    case 0x11: mixed_pass<1, 1, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x12: mixed_pass<1, 2, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x13: mixed_pass<1, 3, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x14: mixed_pass<1, 4, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x30: mixed_pass<3, 0, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x31: mixed_pass<3, 1, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x32: mixed_pass<3, 2, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x50: mixed_pass<5, 0, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x51: mixed_pass<5, 1, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x70: mixed_pass<7, 0, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    case 0x71: mixed_pass<7, 1, INVERSE, ROWS, SCALE>(z, n, lines, ld, len, tw, ys); break;
    default: __trap();  // a code the host's planner never writes
  }
}

// Every pass of one axis (its codes from the layout), each followed by a
// block barrier.  The forward runs them in order, the inverse backwards.
// With SCALE the first pass multiplies the imaginary parts by ys as it
// reads them.
template <bool INVERSE, bool ROWS, bool SCALE = false>
__device__ void mixed_lines(float2* z, int h, int w, const float2* tw,
                            const int* codes, int npass, float ys = 1.0f) {
  const int n = ROWS ? w : h, lines = ROWS ? h : w, ld = pitch(w);
  int len = INVERSE ? 1 : n;
  for (int pp = 0; pp < npass; ++pp) {
    const int code = codes[INVERSE ? npass - 1 - pp : pp];
    const int elems = (code >> 4) << (code & 15);
    if (INVERSE) len *= elems;
    if (SCALE && pp == 0)
      mixed_pass_of<INVERSE, ROWS, SCALE>(code, z, n, lines, ld, len, tw, ys);
    else
      mixed_pass_of<INVERSE, ROWS, false>(code, z, n, lines, ld, len, tw, 1.0f);
    if (!INVERSE) len /= elems;
    __syncthreads();
  }
}

// The pointwise step on the digit-reversed layout.  A bin's kx < W/2
// exactly when its column position is even (the last stage is radix 2), so
// the loop walks the even column positions of every row position and
// reads the bins there from the position -> bin tables: consecutive lanes
// two float2 apart, at most 2-way as the power-of-two step's swizzle;
// the partners' reads are at most 2-way at 96x96, 2.5-way at 98x98 and
// 3-way at 100x100 (tests/test_torch_fft.py counts the ways).  Ownership as
// in pair_step: kx = 0 owns the pair where ky <= H/2, and the column kx =
// W/2 is walked once for ky <= H/2.
__device__ void mixed_pair_step(float2* z, int h, int w, const int* lay,
                                const FastDiv& by_wh, const Spectra& k) {
  const int wh = w / 2, w2 = wh + 1, ld = pitch(w);
  const int* pos_h = lay + kLayoutHeader;
  const int* bin_h = pos_h + h;
  const int* pos_w = bin_h + h;
  const int* bin_w = pos_w + w;
  const float gain = __ldg(k.var_gain);
#pragma unroll 4
  for (int t = threadIdx.x; t < h * wh; t += kThreads) {
    const int r = by_wh.div(t), c = 2 * (t - r * wh);
    const int ky = bin_h[r], kx = bin_w[c];
    if (kx == 0 && ky > h / 2) continue;
    const int nky = ky ? h - ky : 0, nkx = kx ? w - kx : 0;
    pair_at(z, r * ld + c, pos_h[nky] * ld + pos_w[nkx], ky * w2 + kx, k, gain);
  }
  const int half = pos_w[wh];
  for (int ky = threadIdx.x; ky <= h / 2; ky += kThreads)
    pair_at(z, pos_h[ky] * ld + half, pos_h[ky ? h - ky : 0] * ld + half,
            ky * w2 + wh, k, gain);
}

// ---- the two geometries ----

// Both sides powers of two; tw the table of max(H, W) in shared memory.
struct Pow2Geom {
  int h, w, ld, wb, tw_log2;
  const float2* tw;
  __device__ Pow2Geom(int h_, int w_, const float2* tw_, int tw_log2_)
      : h(h_), w(w_), ld(pitch(w_)), wb(log2i(w_)), tw_log2(tw_log2_),
        tw(tw_) {}
  // the shared-memory slot of pixel p = y W + x
  __device__ __forceinline__ int at(int p) const {
    return (p >> wb) * ld + (p & (w - 1));
  }
  // the slot of ((y + H/2) mod H, (x + W/2) mod W)
  __device__ __forceinline__ int shifted(int p) const {
    const int y = p >> wb, x = p & (w - 1);
    return ((y + h / 2) & (h - 1)) * ld + ((x + w / 2) & (w - 1));
  }
  // what output pixel p reads, and the inverse's normalisation
  __device__ __forceinline__ float2 read(const float2* z, int p) const {
    return z[shifted(p)];
  }
  __device__ __forceinline__ float inv_size() const {
    return 1.0f / (float)(h * w);
  }
  template <bool INVERSE, bool ROWS, bool SCALE = false>
  __device__ void lines(float2* z, float ys = 1.0f) const {
    fft_lines<INVERSE, ROWS, SCALE>(z, h, w, tw, tw_log2, ys);
  }
  __device__ void pairs(float2* z, const Spectra& k) const {
    pair_step(z, h, w, k);
  }
};

// Even 7-smooth sides; tw both axes' tables and lay the layout, both in
// shared memory.
struct MixedGeom {
  int h, w, ld;
  FastDiv by_w, by_wh;
  const float2* tw;
  const int* lay;
  __device__ MixedGeom(int h_, int w_, const float2* tw_, const int* lay_)
      : h(h_), w(w_), ld(pitch(w_)), by_w(w_), by_wh(w_ / 2), tw(tw_),
        lay(lay_) {}
  __device__ __forceinline__ int at(int p) const {
    const int y = by_w.div(p);
    return y * ld + (p - y * w);
  }
  __device__ __forceinline__ int shifted(int p) const {
    int y = by_w.div(p), x = p - y * w;
    y += h / 2;
    x += w / 2;
    if (y >= h) y -= h;
    if (x >= w) x -= w;
    return y * ld + x;
  }
  __device__ __forceinline__ float2 read(const float2* z, int p) const {
    return z[shifted(p)];
  }
  __device__ __forceinline__ float inv_size() const {
    return 1.0f / (float)(h * w);
  }
  template <bool INVERSE, bool ROWS, bool SCALE = false>
  __device__ void lines(float2* z, float ys = 1.0f) const {
    const int* hdr = lay + (ROWS ? 2 + kMaxPasses : 1);
    mixed_lines<INVERSE, ROWS, SCALE>(z, h, w, ROWS ? tw + lay[0] : tw,
                                      hdr + 1, hdr[0], ys);
  }
  __device__ void pairs(float2* z, const Spectra& k) const {
    mixed_pair_step(z, h, w, lay, by_wh, k);
  }
};

// The padded geometry: an image of h x w pixels in the corner [0, h) x
// [0, w) of the transform t (t.h x t.w, Pow2Geom or MixedGeom; row pitch
// t.w + 1), zeros elsewhere.  Each side is the image's own (on the FFT
// route: no fold) or at least 2N - 1, where the transform's circular
// convolution of the zero-padded image and kernel is the linear one z;
// output pixel p reads its shifted slot s = (n + N/2) mod N per axis and,
// along a padded axis where s <= N - 2, also z[s + N]: the N-point
// circular convolution, up to four terms summed (z00 + z01) + (z10 + z11).
template <class Inner>
struct PaddedGeom {
  int h, w;  // the image
  Inner t;   // the transform
  FastDiv by_w;
  bool fold_h, fold_w;
  __device__ PaddedGeom(int h_, int w_, const Inner& t_)
      : h(h_), w(w_), t(t_), by_w(w_), fold_h(t_.h != h_), fold_w(t_.w != w_) {}
  __device__ __forceinline__ int at(int p) const {
    const int y = by_w.div(p);
    return y * t.ld + (p - y * w);
  }
  __device__ __forceinline__ float2 read(const float2* z, int p) const {
    int y = by_w.div(p), x = p - y * w;
    y += h / 2;
    x += w / 2;
    if (y >= h) y -= h;
    if (x >= w) x -= w;
    const float2* q = z + y * t.ld + x;
    const bool fx = fold_w && x < w - 1, fy = fold_h && y < h - 1;
    float2 v = q[0];
    if (fx) v = cadd(v, q[w]);
    if (fy) {
      float2 u = q[h * t.ld];
      if (fx) u = cadd(u, q[h * t.ld + w]);
      v = cadd(v, u);
    }
    return v;
  }
  __device__ __forceinline__ float inv_size() const {
    return 1.0f / (float)(t.h * t.w);
  }
  template <bool INVERSE, bool ROWS, bool SCALE = false>
  __device__ void lines(float2* z, float ys = 1.0f) const {
    t.template lines<INVERSE, ROWS, SCALE>(z, ys);
  }
  __device__ void pairs(float2* z, const Spectra& k) const { t.pairs(z, k); }
};

// The padded route's transform side for an image side n >= 2 (conv_lnl.py's
// padded_size): the smallest even 7-smooth side of at least 2n - 1; and a
// side's transform, the side itself where the FFT route takes it.
inline int padded_side(int n) {
  int m = 2 * n;
  while (!seven_smooth_even(m)) m += 2;
  return m;
}

inline int transform_side(int n) {
  return seven_smooth_even(n) ? n : padded_side(n);
}

// The padded route's plan as the host makes it (conv_lnl.py's padded_shape):
// each side at least 2, each transform side the image's own where the FFT
// route takes it and padded_side otherwise, at least one side padded.
inline bool padded_plan(int h, int w, int mh, int mw) {
  return h >= 2 && w >= 2 && mh == transform_side(h) && mw == transform_side(w) &&
         (mh != h || mw != w);
}

// A launch on the geometry of the transform (mh, mw) (the image's own
// sides on the FFT route): `pow2_kernel` or `mixed_kernel` by its sides,
// with its dynamic shared memory set, and the log2 of the power-of-two
// table's length; returns 0 or the cudaError of the attribute call.
template <class Kernel>
int prepare_geometry(Kernel pow2_kernel, Kernel mixed_kernel, int mh, int mw,
                     Kernel* kernel, size_t* smem, int* tw_log2) {
  const bool pow2 = power_of_two(mh) && power_of_two(mw);
  *smem = pow2 ? image_bytes(mh, mw) : mixed_image_bytes(mh, mw);
  *kernel = pow2 ? pow2_kernel : mixed_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  *tw_log2 = 0;
  while ((1 << *tw_log2) < (mh > mw ? mh : mw)) ++*tw_log2;
  return 0;
}

// The FFT route's launch at (h, w): both sides powers of two, or both even
// with no prime factor above 7; returns 0 or the cudaError of the shape
// check or the attribute call.
template <class Kernel>
int prepare_fft(Kernel pow2_kernel, Kernel mixed_kernel, int h, int w,
                Kernel* kernel, size_t* smem, int* tw_log2) {
  const bool pow2 = power_of_two(h) && power_of_two(w);
  if (!pow2 && !(seven_smooth_even(h) && seven_smooth_even(w)))
    return (int)cudaErrorInvalidValue;
  return prepare_geometry(pow2_kernel, mixed_kernel, h, w, kernel, smem, tw_log2);
}

// The raw image of one walker from global memory into the real parts of
// z; returns the largest |raw| this thread read.
template <class Geom>
__device__ float load_image(float2* z, const Geom& g, const float* raw) {
  float mx = 0.0f;
#pragma unroll 4
  for (int p = threadIdx.x; p < g.h * g.w; p += kThreads) {
    const float v = __ldg(raw + p);
    z[g.at(p)].x = v;
    mx = fmaxf(mx, fabsf(v));
  }
  return mx;
}

// The padded geometry's load: the raw image into [0, h) x [0, w) and zeros
// into both parts of every other slot of the transform (shared memory is
// not initialised; the square step then writes the image pixels'
// imaginary parts only).
template <class Inner>
__device__ float load_image(float2* z, const PaddedGeom<Inner>& g, const float* raw) {
  const int mw = g.t.w, ld = g.t.ld;
  const FastDiv by_mw(mw);
  float mx = 0.0f;
#pragma unroll 4
  for (int q = threadIdx.x; q < g.t.h * mw; q += kThreads) {
    const int y = by_mw.div(q), x = q - y * mw;
    const float v = (y < g.h && x < g.w) ? __ldg(raw + y * g.w + x) : 0.0f;
    z[y * ld + x] = make_float2(v, 0.0f);
    mx = fmaxf(mx, fabsf(v));
  }
  return mx;
}

// From the raw image in the real parts of z (written by the block's
// threads before the call, `local_max` being the largest |raw| this thread
// wrote; the barrier of the max reduction makes the image visible to all)
// to the walker's lnL in *out.
//
// RESID (conv_lnl's forward under autograd, whose backward reads what it
// writes): the readout also stores, in pixel order, the likelihood's two
// weights w = (a, c), a = good r ivm = dlnL/dconv and c = good ((r ivm)^2
// - ivm) / 2 = dlnL/dmvar, each operation rounded on its own (no
// contraction), to weights[p] (8 bytes a pixel), and
// to *scale_exp the clamped difference e_a - e_c of the exponents of
// their block peaks (0 unless both are finite and positive): the power of
// two that gives the backward's packed image a + i 2^(e_a - e_c) c one
// scale.  The lnL is the same, bit for bit: the weights are formed before
// the lnL's term and share no product with it, because the compiler fuses
// the term's r^2 ivm - log(...) into one FMA only while ivm has no later
// use.
template <class Geom, bool RESID = false>
__device__ void convolve_and_reduce(float2* z, const Geom& g, float local_max,
                                    const Spectra& k, const Data& d,
                                    float* out, float2* weights = nullptr,
                                    int* scale_exp = nullptr) {
  __shared__ float maxes[RESID ? 3 * kWarps : kWarps];
  __shared__ double partial[kWarps];
  const int h = g.h, w = g.w;
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
    float2* q = z + g.at(p);
    const float x = q->x;
    q->y = s * (x * x);
  }
  __syncthreads();
  PSFMC_STAMP(2);

  g.template lines<false, true>(z);
  PSFMC_STAMP(3);
  g.template lines<false, false>(z);
  PSFMC_STAMP(4);
  g.pairs(z, k);
  __syncthreads();
  PSFMC_STAMP(5);
  g.template lines<true, false>(z);
  PSFMC_STAMP(6);
  g.template lines<true, true>(z);
  PSFMC_STAMP(7);

  // output pixel (y, x) reads ((y + H/2) mod H, (x + W/2) mod W), and on
  // the padded geometry the fold's terms beside it
  const float conv_scale = g.inv_size();
  const float mvar_scale = ldexpf(conv_scale, se) / __ldg(k.var_gain);
  double sum = 0.0;
  float amax = 0.0f, cmax = 0.0f;  // RESID: the weights' peaks (NaNs dropped)
#pragma unroll 4
  for (int p = threadIdx.x; p < h * w; p += kThreads) {
    const float2 c = g.read(z, p);
    const float conv = c.x * conv_scale, mvar = c.y * mvar_scale;
    const float ivm = 1.0f / (mvar + __ldg(d.obs_var + p));
    const float resid = __ldg(d.obs + p) - conv;
    const bool good = __ldg(d.good + p) > 0.0f;
    if constexpr (RESID) {  // before the term: see the note above
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
  PSFMC_STAMP(8);
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
    const float r = (float)tot;
    *out = isfinite(r) ? r : -INFINITY;
    if constexpr (RESID) {
      float am = maxes[kWarps], cm = maxes[2 * kWarps];
      for (int i = 1; i < kWarps; ++i) {
        am = fmaxf(am, maxes[kWarps + i]);
        cm = fmaxf(cm, maxes[2 * kWarps + i]);
      }
      const bool ok = am > 0.0f && isfinite(am) && cm > 0.0f && isfinite(cm);
      const int e = ok ? ilogbf(am) - ilogbf(cm) : 0;
      *scale_exp = max(-kMaxScaleExp, min(kMaxScaleExp, e));
    }
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

// Both axes' twiddle tables into tw and the layout right after them, in
// shared memory; the same barrier makes them visible.
__device__ inline MixedGeom load_mixed(float2* tw, const float2* table,
                                       const int* layout, int h, int w) {
  const int entries = twiddle_entries(h) + twiddle_entries(w);
  int* lay = reinterpret_cast<int*>(tw + entries);
  for (int i = threadIdx.x; i < entries; i += kThreads) tw[i] = table[i];
  for (int i = threadIdx.x; i < layout_ints(h, w); i += kThreads)
    lay[i] = layout[i];
  return MixedGeom(h, w, tw, lay);
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
