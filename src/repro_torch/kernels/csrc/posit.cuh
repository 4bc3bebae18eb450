// Posit<n,es> field codec for device code, shared by the PLAM matmul
// (plam_matmul.cuh), the posit codec kernels (posit_codec.cu) and the
// element-wise multipliers (posit_mul.cu).
//
// A line-for-line port of repro/numerics/posit.py (decode_fields,
// encode_fields, decode, encode) in uint32 arithmetic.  C++ shifts by
// 32 or more are undefined, so every variable shift goes through
// shl()/shr(), which return 0 outside [0, 32) as the reference's
// _shl/_shr do.  Built without --use_fast_math and without FTZ: inputs
// are read as raw bits, so f32 subnormals encode to +-minpos.
#pragma once

#include <cstdint>

namespace plam {

// The bf16 values that Posit<n,es> holds exactly: a bf16 carries 7
// fraction bits, so its posit is exact where the regime (terminator
// included) leaves es exponent bits and 7 fraction bits, m <= n - 8 - es.
// With m = k + 2 for k >= 0 and 1 - k for k < 0, that is scales
// [(1 - mmax) 2^es, (mmax - 1) 2^es - 1]: [-12, 11] at Posit<16,1>.  An
// empty range (lo > hi) where not even k = 0 leaves the room.
constexpr int kBf16FracBits = 7;
constexpr int exact_bf16_mmax(int n, int es) { return n - 1 - es - kBf16FracBits; }
constexpr int exact_bf16_lo(int n, int es) {
  return exact_bf16_mmax(n, es) >= 2 ? (1 - exact_bf16_mmax(n, es)) * (1 << es) : 1;
}
constexpr int exact_bf16_hi(int n, int es) {
  return exact_bf16_mmax(n, es) >= 2 ? (exact_bf16_mmax(n, es) - 1) * (1 << es) - 1 : 0;
}

struct Spec {
  int n;
  int es;
  int fb;  // fraction bits of the widest fraction (n - 3 - es)
  uint32_t mask_n;
  uint32_t nar;
  uint32_t maxpos_body;
  int exact_lo, exact_hi;  // scales at which every bf16 value is a posit
};

// The same fields as constants of the type, for a spec known when the
// kernel is compiled: decode_fields and log_word then fold its masks,
// shifts and branches into immediates.  Both take either spec type.
template <int N, int ES>
struct FixedSpec {
  static constexpr int n = N;
  static constexpr int es = ES;
  static constexpr int fb = N - 3 - ES;
  static constexpr uint32_t mask_n = N < 32 ? ((1u << N) - 1u) : 0xFFFFFFFFu;
  static constexpr uint32_t nar = 1u << (N - 1);
  static constexpr uint32_t maxpos_body = (1u << (N - 1)) - 1u;
  static constexpr int exact_lo = exact_bf16_lo(N, ES);
  static constexpr int exact_hi = exact_bf16_hi(N, ES);
};

inline Spec make_spec(int n, int es) {
  Spec s;
  s.n = n;
  s.es = es;
  s.fb = n - 3 - es;
  s.mask_n = n < 32 ? ((1u << n) - 1u) : 0xFFFFFFFFu;
  s.nar = 1u << (n - 1);
  s.maxpos_body = (1u << (n - 1)) - 1u;
  s.exact_lo = exact_bf16_lo(n, es);
  s.exact_hi = exact_bf16_hi(n, es);
  return s;
}

__device__ __forceinline__ uint32_t shl(uint32_t x, int s) {
  return (s >= 0 && s < 32) ? (x << s) : 0u;
}

__device__ __forceinline__ uint32_t shr(uint32_t x, int s) {
  return (s >= 0 && s < 32) ? (x >> s) : 0u;
}

struct Fields {
  int sign;
  int scale;      // k * 2^es + e
  uint32_t frac;  // left-aligned to fb fractional bits
  bool is_zero;
  bool is_nar;
};

template <class S>
__device__ __forceinline__ Fields decode_fields(uint32_t bits, const S& sp) {
  Fields f;
  const uint32_t u = bits & sp.mask_n;
  f.is_zero = u == 0u;
  f.is_nar = u == sp.nar;
  f.sign = (int)((u >> (sp.n - 1)) & 1u);
  const uint32_t mag = f.sign ? ((0u - u) & sp.mask_n) : u;
  const uint32_t body = mag & sp.maxpos_body;
  // left-align the n-1 body bits so the first regime bit is bit 31
  const uint32_t v = body << (33 - sp.n);  // 33 - n in [1, 29]
  const int r0 = (int)(v >> 31);
  const uint32_t pad = (1u << (33 - sp.n)) - 1u;
  const uint32_t w = (r0 ? ~v : v) | pad;  // never 0: pad >= 1
  const int m = __clz((int)w);             // regime run length
  const int k = r0 ? m - 1 : -m;
  const uint32_t rest = shl(v, m + 1);     // exponent+fraction, left-aligned
  const int e = sp.es > 0 ? (int)(rest >> (32 - sp.es)) : 0;
  f.frac = (rest << sp.es) >> (32 - sp.fb);
  f.scale = k * (1 << sp.es) + e;
  return f;
}

// Pack (sign, scale, frac with fbits fractional bits) into a pattern with
// round-to-nearest-even on the full pattern, saturating at +-maxpos and
// never rounding a non-zero value to zero or NaR.
template <class S>
__device__ __forceinline__ uint32_t encode_fields(int sign, int scale, uint32_t frac,
                                                  int fbits, const S& sp) {
  const int n = sp.n, es = sp.es;
  int k;
  uint32_t e;
  if (es > 0) {
    k = scale >> es;  // arithmetic shift == floor division
    e = (uint32_t)(scale & ((1 << es) - 1));
  } else {
    k = scale;
    e = 0u;
  }
  const bool too_big = k >= n - 2;
  const bool too_small = k <= -(n - 1);
  const int kc = k < -(n - 2) ? -(n - 2) : (k > n - 3 ? n - 3 : k);
  const int m = kc >= 0 ? kc + 2 : 1 - kc;  // regime width incl. terminator
  const int avail = (n - 1) - m;            // bits left for exponent+fraction
  const uint32_t regime = kc >= 0 ? shl(1u, kc + 2) - 2u : 1u;

  const uint32_t combined = shl(e, fbits) | frac;
  const int shift_out = es + fbits - avail;
  const uint32_t kept = shift_out > 0 ? shr(combined, shift_out) : shl(combined, -shift_out);
  const uint32_t round_bit = shift_out > 0 ? (shr(combined, shift_out - 1) & 1u) : 0u;
  const uint32_t sticky_mask = shift_out > 1 ? shl(1u, shift_out - 1) - 1u : 0u;
  const bool sticky = (combined & sticky_mask) != 0u;
  const uint32_t body_pre = shl(regime, avail) + kept;
  const uint32_t inc = round_bit & ((sticky || (body_pre & 1u)) ? 1u : 0u);
  uint32_t body = body_pre + inc;
  if (body > sp.maxpos_body) body = sp.maxpos_body;  // carry past maxpos saturates
  if (too_big) body = sp.maxpos_body;
  if (too_small) body = 1u;  // minpos
  return sign ? ((0u - body) & sp.mask_n) : body;
}

// f32 bit pattern -> posit pattern (repro.numerics.encode).
template <class S>
__device__ __forceinline__ uint32_t encode_f32_bits(uint32_t b, const S& sp) {
  if ((b & 0x7FFFFFFFu) == 0u) return 0u;
  const int raw_e = (int)((b >> 23) & 0xFFu);
  if (raw_e == 255) return sp.nar;  // inf/nan -> NaR
  // subnormals get scale -127, which clamps to minpos
  return encode_fields((int)(b >> 31), raw_e - 127, b & 0x7FFFFFu, 23, sp);
}

// posit pattern -> f32 (repro.numerics.decode).
template <class S>
__device__ __forceinline__ float decode_f32(uint32_t bits, const S& sp) {
  const Fields f = decode_fields(bits, sp);
  if (f.is_zero) return 0.0f;
  if (f.is_nar) return __uint_as_float(0x7FC00000u);
  int scale = f.scale;
  uint32_t mant;
  if (sp.fb <= 23) {
    mant = f.frac << (23 - sp.fb);
  } else {  // one extra RNE step into the f32 mantissa
    const int sh = sp.fb - 23;
    const uint32_t lower = f.frac & ((1u << sh) - 1u);
    const uint32_t half = 1u << (sh - 1);
    const uint32_t hi = f.frac >> sh;
    const bool rnd = lower > half || (lower == half && (hi & 1u));
    mant = hi + (rnd ? 1u : 0u);
    scale += (int)(mant >> 23);
    mant &= 0x7FFFFFu;
  }
  return __uint_as_float(((uint32_t)f.sign << 31) | ((uint32_t)(scale + 127) << 23) | mant);
}

// The PLAM operand of repro/kernels/plam_matmul.py::_log_words: the
// f32-aligned log magnitude (scale + 127) << 23 | mantissa23 with the
// sign folded in as (sign << 31) by an unsigned add, so that the product
// of two operands is ONE add of their words:
//   (la - bias + sa<<31) + (lb + sb<<31) == (sa ^ sb) << 31 | (la + lb - bias)
// modulo 2^32, because la + lb - bias lies in (0, 2^31).  `valid` is
// false for zero and NaR, whose products contribute +0.0.
template <class S>
__device__ __forceinline__ uint32_t log_word(uint32_t bits, const S& sp, bool& valid) {
  const Fields f = decode_fields(bits, sp);
  valid = !(f.is_zero || f.is_nar);
  const uint32_t mant = sp.fb <= 23 ? (f.frac << (23 - sp.fb)) : (f.frac >> (sp.fb - 23));
  const uint32_t lmag = ((uint32_t)(f.scale + 127) << 23) | mant;
  return valid ? lmag + ((uint32_t)f.sign << 31) : 0u;
}

// A's log word straight from a float activation's f32 bits (a bf16 is
// its 16 bits shifted up): log_word(encode_f32_bits(x)), without the
// pattern in between.  Where x is a bf16 value (its low 16 bits are 0)
// at a scale the posit holds exactly, the posit's scale and mantissa are
// x's own, so the sign-folded word IS x's bits: a range check and a
// copy.  Zero gives word 0 (invalid); everything else (f32 values with
// more than 8 significant bits, scales outside the range, subnormals
// (minpos), inf and NaN (NaR, word 0)) takes the full encode and decode.
//
// a_word_exact is its common case alone, without a branch: x where x is a
// bf16 value in the exact range, else 0, and `full` set where a_word must
// take the full encode (x neither exact nor zero).  A loader of many
// elements takes it for all of them first and the full encode only where
// one needs it.
template <class S>
__device__ __forceinline__ uint32_t a_word_exact(uint32_t x, const S& sp, bool& full) {
  const int e = (int)((x >> 23) & 0xFFu) - 127;
  const bool exact = (x & 0xFFFFu) == 0u && e >= sp.exact_lo && e <= sp.exact_hi;
  full = !exact && (x & 0x7FFFFFFFu) != 0u;
  return exact ? x : 0u;
}

template <class S>
__device__ __forceinline__ uint32_t a_word_full(uint32_t x, const S& sp) {
  bool valid;
  return log_word(encode_f32_bits(x, sp), sp, valid);
}

// a_word keeps its early returns: written with a_word_exact, the decode
// path (one element at a time) ran 1-2% slower at M = 4 on the H100.
template <class S>
__device__ __forceinline__ uint32_t a_word(uint32_t x, const S& sp) {
  const int e = (int)((x >> 23) & 0xFFu) - 127;
  if ((x & 0xFFFFu) == 0u && e >= sp.exact_lo && e <= sp.exact_hi) return x;
  if ((x & 0x7FFFFFFFu) == 0u) return 0u;
  return a_word_full(x, sp);
}

}  // namespace plam
