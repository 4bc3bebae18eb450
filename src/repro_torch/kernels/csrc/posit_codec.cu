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
// PLAM matmul (plam_matmul.cuh, kFloatA), so the encode takes weights:
// once at engine build (quantize_params, bf16 -> int16), and on every
// forward of the plam_sim path without prequantized weights (core/modes.py,
// bf16 -> int16).  The quantize projects both operands of every
// projection under posit_quant (training: bf16 weights and activations ->
// f32); the decode widens prequantized weights for every mode but
// plam_sim (core/modes.py::_pattern_matmul, core/prequant.py::
// dequantize_params).  All three serve the conformance oracle.
//
// What bounds it on an H100: bytes.  A bf16 input has only 65,536
// values, so an encode that looks its pattern up in a table needs one
// operation a lane on its value (the table index from the input's bits;
// loads, stores and address arithmetic left out) against 2 + 2 bytes
// (bf16 -> int16) at 3.35 TB/s: 0.054 ms for a [4096, 11008] weight.
// That count is K3's bound.
//
// Encode and quantize each take one of two paths; the wrapper picks it
// (posit_codec.py::encode_path, quantize_path: the same rule) and passes
// the table for the first:
//
// - The table path: bf16 input, n <= 16, at least 2^20 lanes (every
//   weight, and a training batch's activations).  Each block copies a
//   64 KB table of the 32,768 non-negative bf16 patterns (indexed by
//   bits & 0x7FFF, uint16) into shared memory with 16-byte loads (64 KB,
//   half the 128 KB of all 65,536 patterns: half the fill), then takes
//   8-lane chunks in a grid-stride loop, two in flight a thread: one
//   16-byte load of 8 bf16, 8 lookups and the sign, and 16-byte stores.  Blocks: min(SMs,
//   ceil(n / 32768)): one block an SM fills half the tables that two
//   would (chip_smoke.py's table probe times the "two blocks an SM"
//   variant beside it).  The tables are built once per (spec, device) by
//   the computed path:
//   - encode: the patterns p(|x|).  By sign symmetry p(x) = sign(x) ?
//     (0 - p(|x|)) & mask_n : p(|x|) (true for +-0, and for inf and NaN,
//     whose NaR negates to itself).  One 16-byte store of 8 int16 or two
//     of 4 int32 (the uint16 zero-extended, as repro.numerics.encode
//     returns bits & mask_n).
//   - quantize: the bf16 bits of q(|x|) = decode(encode(|x|)).  Every
//     q(x) of a bf16 x is a bf16 value at every spec with n <= 16 (its
//     posit keeps at most 7 fraction bits where x has them, and the
//     scale stays in f32's range); the wrapper checks the low 16 bits of
//     each built entry and raises where one is set.  q(-x) is q(x) with
//     the sign bit set, except where q(x) is +0 (x = -0) or NaN (x inf or
//     NaN: 0x7FC00000 whatever the sign).  Two 16-byte stores of 4 f32
//     (the entry shifted up).
// - The computed path, for everything else (f32 input, n > 16, fewer
//   lanes: activations, the conformance vectors): posit.cuh's
//   encode_f32_bits (and decode_f32) on each lane, with the spec compiled
//   in at Posit<16,1> (plam::FixedSpec) and given at run time otherwise,
//   over the same 8-lane chunks with 16-byte loads and stores from
//   kByLaneMaxLanes (2^20) lanes on, one lane a thread below (a decode
//   step's activations, where eight lanes a thread leave most of the card
//   idle; chip_smoke.py's phase times sweeps both sides).
//
// The decode always computes each lane (a table of the 65,536 patterns'
// f32 values would be 256 KB, beyond shared memory): decode_f32 with
// Posit<16,1> compiled in, 8-lane chunks of int16 or int32 patterns, two
// in flight a thread, two 16-byte stores of 4 f32 (one lane a thread below
// kDecodeByLaneMaxLanes, 2^17: its lanes are lighter than the encode's).
//
// Every chunked path takes the lanes before x's first 16-byte boundary (a
// view at an odd element offset, such as x[1:]) and the tail after the
// last whole chunk one at a time; where out is not on a 16-byte boundary
// at that lane, the chunks store lane by lane.
//
// Operations a lane, counted by hand as posit_mul.cu counts K4's (one for
// each operator, comparison or select on a lane's values; values of the
// spec alone hoisted; loop and address arithmetic, loads and stores left
// out):
//
//                                      ALU-only   add-like
//   encode_fields                          33         12   (posit_mul.cu's count)
//   encode_f32_bits glue                    9          1   (zero test: and,
//                                                           compare, select;
//                                                           exponent: shift,
//                                                           and; NaR test:
//                                                           compare, select;
//                                                           sign shift,
//                                                           mantissa and;
//                                                           scale - 127)
//   computed lane, run-time spec           42         13   = 55
//   with Posit<16,1> compiled in:
//     shift_out = 24 - avail lies in [11, 24], so kept's compare, shl
//     and select, round_bit's select and sticky_mask's compare and
//     select fold away                     -6         -1
//   computed lane, Posit<16,1>             36         12   = 48
//   table lane                              5          1   (index and, sign
//                                                           test, negate,
//                                                           mask and, select;
//                                                           the second bf16
//                                                           of a word: its
//                                                           shift, and the
//                                                           pack: an or,
//                                                           half a lane each)
//
//   decode_fields                          16          8   (posit_mul.cu's
//                                                           count; and one
//                                                           clz)
//   decode_f32 glue                         4          4   (zero and NaR
//                                                           selects, two ors
//                                                           of the fields;
//                                                           the mantissa's,
//                                                           exponent's and
//                                                           sign's shifts,
//                                                           scale + 127; the
//                                                           fb <= 23 branch
//                                                           is the spec's)
//   decode lane                            20         12   = 32 (Posit<16,1>
//                                                           folds masks and
//                                                           shifts into
//                                                           immediates, no
//                                                           operation)
//   quantize computed lane, Posit<16,1>    56         24   = 80 (the encode's
//                                                           36 + 12 and the
//                                                           decode's; 62 + 25
//                                                           at a run-time
//                                                           spec)
//   quantize table lane                     8          1   (index and, sign
//                                                           test, the two
//                                                           compares, their
//                                                           and, the sign's
//                                                           or, select; the
//                                                           second bf16 of a
//                                                           word: its shift,
//                                                           half a lane,
//                                                           rounded up; the
//                                                           shift up to f32)
//
// At 64 ALU lanes per SM per clock (132 SMs at 1980 MHz), a [4096, 11008]
// encode takes at least 0.113 ms at a run-time spec, 0.097 ms at
// Posit<16,1> (an f32 input's bytes bound is 0.108 ms), and 0.013 ms on
// the table path, below its bytes: these are the paths' design floors.
// At 2^24 lanes a decode's 20 operations take 0.020 ms, below its bytes
// (0.030 ms from int16, 0.040 from int32); a computed f32 quantize's 56
// take 0.056 ms, above its bytes (0.040 ms): that path is bound by its
// operations.  A table quantize's 8 take 0.008 ms against 0.030 ms of
// bytes (bf16 -> f32).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "posit.cuh"

// the counts above, which chip_smoke.py reads from this file: K3's bound
// (a table encode of bf16 input) and the floors of the paths it times
constexpr int kEncodeBoundAluOpsPerLane = 1;
constexpr int kEncodeFixedAluOpsPerLane = 36;
constexpr int kEncodeTableAluOpsPerLane = 5;
constexpr int kDecodeFixedAluOpsPerLane = 20;
constexpr int kQuantizeFixedAluOpsPerLane = 56;
constexpr int kQuantizeTableAluOpsPerLane = 8;

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3 };

// Lanes are raw words: uint32_t for f32 and int32, uint16_t for bf16 and
// int16 (the low 16 bits of a pattern).

constexpr int kChunk = 8;  // lanes a chunk
// the computed paths take one lane a thread below this many lanes, 8-lane
// chunks from it on: the encode and quantize (ALU-heavy) and the decode
// (chip_smoke.py's phase times: both sides of each, in turns)
constexpr int64_t kByLaneMaxLanes = 1048576;
constexpr int64_t kDecodeByLaneMaxLanes = 131072;
constexpr int kThreads = 256;
constexpr int kTableEntries = 1 << 15;  // the non-negative bf16 patterns
constexpr int kTableBytes = kTableEntries * 2;
constexpr int kTableThreads = 1024;
constexpr int kTableLanesPerBlock = 32768;
constexpr int kMaxDevices = 64;

// 8 lanes of U as one or two 16-byte words
template <typename U>
struct Chunk {
  uint4 w[sizeof(U) / 2];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename U>
__device__ __forceinline__ Chunk<U> load_chunk(const U* p) {
  Chunk<U> c;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(U) / 2); ++i) c.w[i] = __ldcs(q + i);
  return c;
}

template <typename U>
__device__ __forceinline__ uint32_t lane_of(const Chunk<U>& c, int j) {
  if constexpr (sizeof(U) == 2) {
    return (word(c.w[0], j >> 1) >> (16 * (j & 1))) & 0xFFFFu;
  } else {
    return word(c.w[j >> 2], j & 3);
  }
}

// op over a chunk's 8 lanes, stored 16 bytes at a time where o is on a
// 16-byte boundary (vec), lane by lane otherwise
template <typename UIn, typename UOut, class Op>
__device__ __forceinline__ void put_chunk(UOut* o, const Chunk<UIn>& in, Op op, bool vec) {
  uint32_t p[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) p[j] = op(lane_of(in, j));
  if (vec) {
    uint4* q = reinterpret_cast<uint4*>(o);
    if constexpr (sizeof(UOut) == 2) {
      __stcs(q, make_uint4((p[0] & 0xFFFFu) | (p[1] << 16), (p[2] & 0xFFFFu) | (p[3] << 16),
                           (p[4] & 0xFFFFu) | (p[5] << 16), (p[6] & 0xFFFFu) | (p[7] << 16)));
    } else {
      __stcs(q, make_uint4(p[0], p[1], p[2], p[3]));
      __stcs(q + 1, make_uint4(p[4], p[5], p[6], p[7]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) o[j] = (UOut)p[j];
  }
}

// The chunks [c, chunks) of a grid-stride loop: out chunk = op(x chunk),
// kDepth in flight a thread.
template <int kDepth, typename UIn, typename UOut, class Op>
__device__ __forceinline__ void stream_chunks(const UIn* __restrict__ xv, UOut* __restrict__ ov,
                                              int64_t chunks, int64_t c, int64_t stride,
                                              bool out_vec, Op op) {
  for (; c + (kDepth - 1) * stride < chunks; c += kDepth * stride) {
    Chunk<UIn> in[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) in[d] = load_chunk(xv + (c + d * stride) * kChunk);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) put_chunk(ov + (c + d * stride) * kChunk, in[d], op, out_vec);
  }
  for (; c < chunks; c += stride) put_chunk(ov + c * kChunk, load_chunk(xv + c * kChunk), op, out_vec);
}

// out[i] = op(x[i]) for i < n.  Lanes [0, head) (before x's first
// 16-byte boundary) and those past the last whole chunk one at a time;
// the chunks from head on in a grid-stride loop, kDepth in flight a
// thread.
template <int kDepth, typename UIn, typename UOut, class Op>
__device__ __forceinline__ void encode_stream(const UIn* __restrict__ x, UOut* __restrict__ out,
                                              int64_t n, int head, bool out_vec, Op op) {
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t chunks = (n - head) / kChunk;
  const int64_t tail = head + chunks * kChunk;
  if (tid < head) out[tid] = (UOut)op((uint32_t)x[tid]);
  if (tid < n - tail) out[tail + tid] = (UOut)op((uint32_t)x[tail + tid]);
  stream_chunks<kDepth>(x + head, out + head, chunks, tid, stride, out_vec, op);
}

// out[i] = op(x[i]) for i < n, one lane a thread in a grid-stride loop:
// the computed paths' small tensors (fewer than kByLaneMaxLanes or
// kDecodeByLaneMaxLanes lanes), which 8-lane chunks would spread over an
// eighth of the threads.
template <typename UIn, typename UOut, class Op>
__device__ __forceinline__ void lane_stream(const UIn* __restrict__ x, UOut* __restrict__ out,
                                            int64_t n, Op op) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = (UOut)op((uint32_t)x[i]);
}

// -- the computed paths ------------------------------------------------------

template <typename UIn, typename UOut, class S>
__global__ void encode_kernel(const UIn* __restrict__ x, UOut* __restrict__ out, int64_t n,
                              int head, bool out_vec, bool by_lane, S sp) {
  const auto op = [=](uint32_t r) {
    return plam::encode_f32_bits(sizeof(UIn) == 2 ? r << 16 : r, sp);
  };
  if (by_lane) lane_stream(x, out, n, op);
  else encode_stream<1>(x, out, n, head, out_vec, op);
}

// patterns (int16 lanes zero-extended; decode_fields masks to n bits) -> f32 bits
template <typename UIn, typename UOut, class S>
__global__ void decode_kernel(const UIn* __restrict__ bits, UOut* __restrict__ out, int64_t n,
                              int head, bool out_vec, bool by_lane, S sp) {
  const auto op = [=](uint32_t r) { return __float_as_uint(plam::decode_f32(r, sp)); };
  if (by_lane) lane_stream(bits, out, n, op);
  else encode_stream<2>(bits, out, n, head, out_vec, op);
}

template <typename UIn, typename UOut, class S>
__global__ void quantize_kernel(const UIn* __restrict__ x, UOut* __restrict__ out, int64_t n,
                                int head, bool out_vec, bool by_lane, S sp) {
  const auto op = [=](uint32_t r) {
    const uint32_t b = sizeof(UIn) == 2 ? r << 16 : r;
    return __float_as_uint(plam::decode_f32(plam::encode_f32_bits(b, sp), sp));
  };
  if (by_lane) lane_stream(x, out, n, op);
  else encode_stream<1>(x, out, n, head, out_vec, op);
}

// -- the table paths ---------------------------------------------------------

// table: kTableEntries uint16 on a 16-byte boundary, copied into the
// block's shared memory
__device__ __forceinline__ const uint16_t* table_to_shared(const uint16_t* __restrict__ table) {
  extern __shared__ uint4 smem[];
  const uint4* src = reinterpret_cast<const uint4*>(table);
  for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) smem[i] = src[i];
  __syncthreads();
  return reinterpret_cast<const uint16_t*>(smem);
}

template <typename UOut>
__global__ void __launch_bounds__(kTableThreads, 2)
    encode_table_kernel(const uint16_t* __restrict__ x, UOut* __restrict__ out, int64_t n,
                        int head, bool out_vec, const uint16_t* __restrict__ table,
                        uint32_t mask_n) {
  const uint16_t* tab = table_to_shared(table);
  encode_stream<2>(x, out, n, head, out_vec, [=](uint32_t r) {
    const uint32_t t = tab[r & 0x7FFFu];
    return (r & 0x8000u) ? ((0u - t) & mask_n) : t;
  });
}

// table: the bf16 bits of q(|x|) for each non-negative bf16 pattern
__global__ void __launch_bounds__(kTableThreads, 2)
    quantize_table_kernel(const uint16_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
                          int head, bool out_vec, const uint16_t* __restrict__ table) {
  const uint16_t* tab = table_to_shared(table);
  encode_stream<2>(x, out, n, head, out_vec, [=](uint32_t r) {
    const uint32_t t = tab[r & 0x7FFFu];
    const bool neg = (r & 0x8000u) && t != 0u && t != 0x7FC0u;
    return (neg ? t | 0x8000u : t) << 16;
  });
}

// -- launches ----------------------------------------------------------------

struct Layout {
  int head;      // lanes before x's first 16-byte boundary
  bool out_vec;  // out + head is on a 16-byte boundary
};

template <typename UIn, typename UOut>
Layout layout(const UIn* x, const UOut* out, int64_t n) {
  const int64_t to_edge = (int64_t)(((16u - ((uintptr_t)x & 15u)) & 15u) / sizeof(UIn));
  const int head = (int)(to_edge < n ? to_edge : n);
  return {head, ((uintptr_t)(out + head) & 15u) == 0};
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);  // 16 blocks per SM
}

template <typename UIn, typename UOut, class S>
using ComputedKernel = void (*)(const UIn*, UOut*, int64_t, int, bool, bool, S);

template <typename UIn, typename UOut, class S>
int run_computed(ComputedKernel<UIn, UOut, S> kernel, const UIn* x, UOut* out, int64_t n,
                 int64_t by_lane_max, S sp, cudaStream_t s) {
  const Layout l = layout(x, out, n);
  const bool by_lane = n < by_lane_max;
  const int64_t chunks = (n - l.head) / kChunk;
  const int grid = grid_for(by_lane ? n : chunks > 0 ? chunks : 1);
  kernel<<<grid, kThreads, 0, s>>>(x, out, n, l.head, l.out_vec, by_lane, sp);
  return (int)cudaGetLastError();
}

template <class S>
int launch_encode(const void* x, int x_dtype, void* out, int out_dtype, int64_t n, S sp,
                  cudaStream_t s) {
  using U32 = uint32_t;
  using U16 = uint16_t;
  if (x_dtype == kF32 && out_dtype == kI32)
    return run_computed(encode_kernel<U32, U32, S>, (const U32*)x, (U32*)out, n,
                        kByLaneMaxLanes, sp, s);
  if (x_dtype == kF32 && out_dtype == kI16)
    return run_computed(encode_kernel<U32, U16, S>, (const U32*)x, (U16*)out, n,
                        kByLaneMaxLanes, sp, s);
  if (x_dtype == kBF16 && out_dtype == kI32)
    return run_computed(encode_kernel<U16, U32, S>, (const U16*)x, (U32*)out, n,
                        kByLaneMaxLanes, sp, s);
  if (x_dtype == kBF16 && out_dtype == kI16)
    return run_computed(encode_kernel<U16, U16, S>, (const U16*)x, (U16*)out, n,
                        kByLaneMaxLanes, sp, s);
  return (int)cudaErrorInvalidValue;
}

template <class S>
int launch_decode(const void* bits, int bits_dtype, void* out, int64_t n, S sp, cudaStream_t s) {
  using U32 = uint32_t;
  using U16 = uint16_t;
  if (bits_dtype == kI32)
    return run_computed(decode_kernel<U32, U32, S>, (const U32*)bits, (U32*)out, n,
                        kDecodeByLaneMaxLanes, sp, s);
  if (bits_dtype == kI16)
    return run_computed(decode_kernel<U16, U32, S>, (const U16*)bits, (U32*)out, n,
                        kDecodeByLaneMaxLanes, sp, s);
  return (int)cudaErrorInvalidValue;
}

template <class S>
int launch_quantize(const void* x, int x_dtype, void* out, int64_t n, S sp, cudaStream_t s) {
  using U32 = uint32_t;
  using U16 = uint16_t;
  if (x_dtype == kF32)
    return run_computed(quantize_kernel<U32, U32, S>, (const U32*)x, (U32*)out, n,
                        kByLaneMaxLanes, sp, s);
  if (x_dtype == kBF16)
    return run_computed(quantize_kernel<U16, U32, S>, (const U16*)x, (U32*)out, n,
                        kByLaneMaxLanes, sp, s);
  return (int)cudaErrorInvalidValue;
}

// The current device's SM count, read once per (table kernel, device)
// together with the kernel's shared-memory attribute, which is set then;
// `ready` holds the kernel's state (the device's SMs once set, else 0).  A
// refused attribute is returned on every call.
cudaError_t table_kernel_ready(const void* kernel, std::atomic<int>* ready, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int count = ready[dev].load(std::memory_order_acquire);
  if (count == 0) {
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (e != cudaSuccess) return e;
    ready[dev].store(count, std::memory_order_release);
  }
  *sms = count;
  return cudaSuccess;
}

int table_blocks(int64_t n, int sms) {
  const int64_t want = (n + kTableLanesPerBlock - 1) / kTableLanesPerBlock;
  return (int)(want < sms ? want : sms);
}

template <typename UOut>
int launch_encode_table(const uint16_t* x, UOut* out, int64_t n, const uint16_t* table,
                        uint32_t mask_n, cudaStream_t s) {
  static std::atomic<int> ready[kMaxDevices];
  int sms = 0;
  const cudaError_t e = table_kernel_ready((const void*)encode_table_kernel<UOut>, ready, &sms);
  if (e != cudaSuccess) return (int)e;
  const Layout l = layout(x, out, n);
  encode_table_kernel<<<table_blocks(n, sms), kTableThreads, kTableBytes, s>>>(
      x, out, n, l.head, l.out_vec, table, mask_n);
  return (int)cudaGetLastError();
}

int launch_quantize_table(const uint16_t* x, uint32_t* out, int64_t n, const uint16_t* table,
                          cudaStream_t s) {
  static std::atomic<int> ready[kMaxDevices];
  int sms = 0;
  const cudaError_t e = table_kernel_ready((const void*)quantize_table_kernel, ready, &sms);
  if (e != cudaSuccess) return (int)e;
  const Layout l = layout(x, out, n);
  quantize_table_kernel<<<table_blocks(n, sms), kTableThreads, kTableBytes, s>>>(
      x, out, n, l.head, l.out_vec, table);
  return (int)cudaGetLastError();
}

// a table for the table paths: bf16 input, n <= 16, on a 16-byte boundary
bool table_ok(const void* table, int x_dtype, int posit_n) {
  return x_dtype == kBF16 && posit_n <= 16 && ((uintptr_t)table & 15u) == 0;
}

}  // namespace

// x: f32 or bf16 [n]; out: int32 or int16 [n] (int16 only for n <= 16
// posits).  table: null for the computed path; for the table path (bf16
// x, n <= 16) the patterns of the 32,768 non-negative bf16 patterns,
// uint16 on a 16-byte boundary.
extern "C" int posit_encode_launch(const void* x, int x_dtype, void* out, int out_dtype,
                                   int64_t n, int posit_n, int posit_es, const void* table,
                                   void* stream) {
  if (n <= 0 || (out_dtype == kI16 && posit_n > 16)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (table != nullptr) {
    if (!table_ok(table, x_dtype, posit_n)) return (int)cudaErrorInvalidValue;
    const uint32_t mask_n = (1u << posit_n) - 1u;
    const uint16_t* t = (const uint16_t*)table;
    if (out_dtype == kI16)
      return launch_encode_table((const uint16_t*)x, (uint16_t*)out, n, t, mask_n, s);
    if (out_dtype == kI32)
      return launch_encode_table((const uint16_t*)x, (uint32_t*)out, n, t, mask_n, s);
    return (int)cudaErrorInvalidValue;
  }
  if (posit_n == 16 && posit_es == 1)
    return launch_encode(x, x_dtype, out, out_dtype, n, plam::FixedSpec<16, 1>{}, s);
  return launch_encode(x, x_dtype, out, out_dtype, n, plam::make_spec(posit_n, posit_es), s);
}

// bits: int32 or int16 [n]; out: f32 [n].
extern "C" int posit_decode_launch(const void* bits, int bits_dtype, void* out, int64_t n,
                                   int posit_n, int posit_es, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (posit_n == 16 && posit_es == 1)
    return launch_decode(bits, bits_dtype, out, n, plam::FixedSpec<16, 1>{}, s);
  return launch_decode(bits, bits_dtype, out, n, plam::make_spec(posit_n, posit_es), s);
}

// x: f32 or bf16 [n]; out: f32 [n].  table: null for the computed path;
// for the table path (bf16 x, n <= 16) the bf16 bits of q(|x|) for the
// 32,768 non-negative bf16 patterns, uint16 on a 16-byte boundary.
extern "C" int posit_quantize_launch(const void* x, int x_dtype, void* out, int64_t n,
                                     int posit_n, int posit_es, const void* table,
                                     void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (table != nullptr) {
    if (!table_ok(table, x_dtype, posit_n)) return (int)cudaErrorInvalidValue;
    return launch_quantize_table((const uint16_t*)x, (uint32_t*)out, n,
                                 (const uint16_t*)table, s);
  }
  if (posit_n == 16 && posit_es == 1)
    return launch_quantize(x, x_dtype, out, n, plam::FixedSpec<16, 1>{}, s);
  return launch_quantize(x, x_dtype, out, n, plam::make_spec(posit_n, posit_es), s);
}
