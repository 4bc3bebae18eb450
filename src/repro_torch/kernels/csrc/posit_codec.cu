// Posit codec kernels: encode (f32/bf16 -> pattern), decode (pattern ->
// f32) and quantize (decode . encode), element-wise.
//
// Replaces the Pallas TPU kernels repro/kernels/posit_codec.py::
// posit_encode / posit_decode / posit_quantize (_encode_kernel,
// _decode_kernel, _quantize_kernel staged by _tiled_elementwise).
// Bit-identical to repro.numerics.encode / decode: the field logic is
// posit.cuh, and inputs are read as raw bits (__float_as_uint; a bf16 is
// its 16 bits shifted up), so subnormal inputs encode to +-minpos whatever
// the float mode.  Build without --use_fast_math / FTZ.
//
// Where it runs: the serving path's activations are encoded inside the
// PLAM matmul (plam_matmul.cuh, kFloatA), so this kernel encodes the
// weights once at engine build (quantize_params, bf16 -> int16) and
// serves the conformance oracle and the linear plam_sim path's weights.
//
// What bounds it on an H100: bytes.  A bf16 input has only 65,536
// values, so an encode that looks its pattern up in a 128 KB table in
// shared memory needs one operation a lane on its value (the table index
// from the input's bits; loads, stores and address arithmetic left out)
// against 2 + 2 bytes (bf16 -> int16) at 3.35 TB/s: 0.054 ms for a
// [4096, 11008] weight.  That count is K3's bound.
//
// This design computes the fields for a spec given at run time instead.
// Its operations a lane, counted by hand as posit_mul.cu counts K4's (one
// for each operator, comparison or select on a lane's values; values of
// the spec alone hoisted; loop and address arithmetic left out), are its
// design floor, not the function's:
//
//                       ALU-only   add-like
//   encode_fields           33         12   (posit_mul.cu's count)
//   encode_f32_bits glue     9          1   (zero test: and, compare,
//                                            select; exponent: shift,
//                                            and; NaR test: compare,
//                                            select; sign shift,
//                                            mantissa and; scale - 127)
//   encode lane             42         13   = 55
//
// At 64 ALU lanes per SM per clock that is 42 / 64 SM-clocks a lane:
// 0.113 ms for the weight on 132 SMs at 1980 MHz, 2.1x the bound.  The
// design reads and writes one 32-bit word (or one 16-bit word) per
// thread, coalesced, in a grid-stride loop; encode writes int16 directly
// when the caller stores 16-bit patterns, so weights are never staged in
// int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

// the counts above, which chip_smoke.py reads from this file: K3's bound
// (a table encode of bf16 input) and this design's floor
constexpr int kEncodeBoundAluOpsPerLane = 1;
constexpr int kEncodeAluOpsPerLane = 42;

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3 };

__device__ __forceinline__ uint32_t f32_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t f32_bits(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

__device__ __forceinline__ uint32_t pattern_bits(int32_t b) { return (uint32_t)b; }
__device__ __forceinline__ uint32_t pattern_bits(int16_t b) { return (uint32_t)(uint16_t)b; }

__device__ __forceinline__ void store_pattern(int32_t* p, uint32_t bits) { *p = (int32_t)bits; }
__device__ __forceinline__ void store_pattern(int16_t* p, uint32_t bits) {
  *p = (int16_t)(uint16_t)bits;  // pack16: the low 16 bits
}

template <typename TIn, typename TOut>
__global__ void encode_kernel(const TIn* __restrict__ x, TOut* __restrict__ out, int64_t n,
                              plam::Spec sp) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    store_pattern(out + i, plam::encode_f32_bits(f32_bits(x[i]), sp));
}

template <typename TIn>
__global__ void decode_kernel(const TIn* __restrict__ bits, float* __restrict__ out, int64_t n,
                              plam::Spec sp) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = plam::decode_f32(pattern_bits(bits[i]), sp);
}

template <typename TIn>
__global__ void quantize_kernel(const TIn* __restrict__ x, float* __restrict__ out, int64_t n,
                                plam::Spec sp) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = plam::decode_f32(plam::encode_f32_bits(f32_bits(x[i]), sp), sp);
}

constexpr int kThreads = 256;

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);  // 16 blocks per SM
}

}  // namespace

// x: f32 or bf16 [n]; out: int32 or int16 [n] (int16 only for n <= 16 posits).
extern "C" int posit_encode_launch(const void* x, int x_dtype, void* out, int out_dtype,
                                   int64_t n, int posit_n, int posit_es, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (x_dtype == kF32 && out_dtype == kI32) {
    encode_kernel<<<g, kThreads, 0, s>>>((const float*)x, (int32_t*)out, n, sp);
  } else if (x_dtype == kF32 && out_dtype == kI16) {
    encode_kernel<<<g, kThreads, 0, s>>>((const float*)x, (int16_t*)out, n, sp);
  } else if (x_dtype == kBF16 && out_dtype == kI32) {
    encode_kernel<<<g, kThreads, 0, s>>>((const __nv_bfloat16*)x, (int32_t*)out, n, sp);
  } else if (x_dtype == kBF16 && out_dtype == kI16) {
    encode_kernel<<<g, kThreads, 0, s>>>((const __nv_bfloat16*)x, (int16_t*)out, n, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bits: int32 or int16 [n]; out: f32 [n].
extern "C" int posit_decode_launch(const void* bits, int bits_dtype, void* out, int64_t n,
                                   int posit_n, int posit_es, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (bits_dtype == kI32) {
    decode_kernel<<<g, kThreads, 0, s>>>((const int32_t*)bits, (float*)out, n, sp);
  } else if (bits_dtype == kI16) {
    decode_kernel<<<g, kThreads, 0, s>>>((const int16_t*)bits, (float*)out, n, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: f32 or bf16 [n]; out: f32 [n].
extern "C" int posit_quantize_launch(const void* x, int x_dtype, void* out, int64_t n,
                                     int posit_n, int posit_es, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  if (x_dtype == kF32) {
    quantize_kernel<<<g, kThreads, 0, s>>>((const float*)x, (float*)out, n, sp);
  } else if (x_dtype == kBF16) {
    quantize_kernel<<<g, kThreads, 0, s>>>((const __nv_bfloat16*)x, (float*)out, n, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
