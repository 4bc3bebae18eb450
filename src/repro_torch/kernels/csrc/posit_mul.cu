// Element-wise posit multipliers: the PLAM product (pattern x pattern ->
// pattern, eqs. 14-21) and the exact posit product with RNE (eqs. 3-10).
//
// Replaces the Pallas TPU kernels repro/kernels/posit_codec.py::
// plam_mul_elementwise / exact_mul_elementwise (_plam_mul_kernel and
// _exact_mul_kernel staged by _tiled_elementwise2).  Bit-identical to
// repro_torch.numerics.plam_mul / exact_mul: the fields come from
// posit.cuh's decode_fields and the result is packed by its
// encode_fields, with fb fraction bits for PLAM and 2*fb + 1 for the
// exact product.  No TPU tile padding: each thread takes one lane of a
// grid-stride loop and the last lanes are simply the loop's end.
//
// What bounds it on an H100: integer operations, just.  Each lane reads
// two int32 patterns and writes one (12 bytes) and does the operations
// counted below, so the design keeps the lane in registers with no
// shared memory, reads and writes coalesced 32-bit words, and launches
// enough blocks (16 per SM) to hide the latency of the loads behind
// other warps' arithmetic.
//
// Operations a lane needs, counted by hand from the functions as written
// (posit.cuh's decode_fields and encode_fields, and the lane functions
// below): one for each operator, comparison, select, clamp (min or max),
// clz or multiply on a lane's values.  Values of the spec alone are
// computed once per launch and not counted, a comparison reused by a
// second select counts once, and shl()/shr()'s range guards cost nothing
// (PTX shifts already give 0 at 32 or more).  Loop control and address
// arithmetic are not the function's work and are left out.
//
//                     ALU-only   add-like   multiply   clz
//   decode_fields        16          8          -       1   (twice)
//   plam glue             7          3          -       -
//   exact glue           10          5          1       -
//   encode_fields        33         12          -       -
//   plam_mul lane        72         31          0       2   = 105
//   exact_mul lane       75         33          1       2   = 111
//
// ALU-only: logic, right shifts, shifts by a lane value, comparisons,
// selects, clamps.  Add-like: adds, subtracts, negations and left shifts
// by a constant, which can also issue as IMAD on the FMA pipe.  Per SM
// and clock an H100 issues 128 lane-instructions (4 schedulers x 32), of
// which at most 64 on the ALU pipe, 64 IMAD on the FMA pipe and 16 clz
// (FLO, quarter rate).  So a lane takes at least
// max(ALU / 64, all / 128, clz / 16) SM-clocks: 72/64 for plam_mul and
// 75/64 for exact_mul, the ALU pipe binding.  The bound prices these
// ALU-only operations at 64 lanes per SM per clock.
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

// the counts above, which chip_smoke.py reads from this file for K4's bound
constexpr int kPlamMulAluOpsPerLane = 72;
constexpr int kExactMulAluOpsPerLane = 75;

namespace {

__device__ __forceinline__ uint32_t plam_mul_lane(uint32_t a, uint32_t b, const plam::Spec& sp) {
  const plam::Fields fa = plam::decode_fields(a, sp);
  const plam::Fields fb = plam::decode_fields(b, sp);
  if (fa.is_nar || fb.is_nar) return sp.nar;  // NaR absorbs, even times zero
  if (fa.is_zero || fb.is_zero) return 0u;
  const uint32_t fsum = fa.frac + fb.frac;   // eq. (17): the product becomes a sum
  const int carry = (int)(fsum >> sp.fb);    // eqs. (19)-(21)
  const uint32_t frac = fsum & ((1u << sp.fb) - 1u);
  return plam::encode_fields(fa.sign ^ fb.sign, fa.scale + fb.scale + carry, frac, sp.fb, sp);
}

// Needs 2*fb + 1 + es <= 30 (every spec with n <= 16): the fraction
// product (1+fa)(1+fb) < 2^(2fb+2) then fits 32 bits.
__device__ __forceinline__ uint32_t exact_mul_lane(uint32_t a, uint32_t b, const plam::Spec& sp) {
  const plam::Fields fa = plam::decode_fields(a, sp);
  const plam::Fields fb = plam::decode_fields(b, sp);
  if (fa.is_nar || fb.is_nar) return sp.nar;
  if (fa.is_zero || fb.is_zero) return 0u;
  const int w = 2 * sp.fb;
  const uint32_t one = 1u << sp.fb;
  const uint32_t prod = (one | fa.frac) * (one | fb.frac);  // eq. (6), in [2^w, 2^(w+2))
  const uint32_t ovf = (prod >> (w + 1)) & 1u;              // product >= 2 ?
  // a uniform (w+1)-bit fraction, hidden bit stripped
  const uint32_t frac = ovf ? prod - (1u << (w + 1)) : (prod - (1u << w)) << 1;
  return plam::encode_fields(fa.sign ^ fb.sign, fa.scale + fb.scale + (int)ovf, frac, w + 1, sp);
}

template <bool kExact>
__global__ void posit_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                 int32_t* __restrict__ out, int64_t n, plam::Spec sp) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t x = (uint32_t)a[i], y = (uint32_t)b[i];
    out[i] = (int32_t)(kExact ? exact_mul_lane(x, y, sp) : plam_mul_lane(x, y, sp));
  }
}

constexpr int kThreads = 256;

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);  // 16 blocks per SM
}

}  // namespace

// a, b, out: int32 [n] posit patterns (unused high bits ignored on input).
// exact != 0 selects the exact product, which needs 2*(n-3-es) + 1 + es <= 30.
extern "C" int posit_mul_launch(const void* a, const void* b, void* out, int64_t n,
                                int posit_n, int posit_es, int exact, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  if (exact && 2 * sp.fb + 1 + posit_es > 30) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (exact)
    posit_mul_kernel<true><<<g, kThreads, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                                  (int32_t*)out, n, sp);
  else
    posit_mul_kernel<false><<<g, kThreads, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                                   (int32_t*)out, n, sp);
  return (int)cudaGetLastError();
}
