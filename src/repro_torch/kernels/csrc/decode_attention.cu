// K5: single-token GQA decode attention over a contiguous KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_kernel), which walks S in order on one core,
// carrying (m, l, acc) in VMEM scratch from one grid step to the next,
// over a cache padded to a block multiple.  A contiguous cache at yi-6b's
// widths gives only batch x kv = 16 (sequence, kv head) pairs, so here
// the keys are split across blocks of the shared core in
// decode_attention.cuh, and the last split of each pair to finish
// combines the splits' softmax states: one launch.
//
// What bounds it on an H100: bytes (each live K/V row read once per
// sequence and kv head); what the design does about it is in the core's
// header.
#include "decode_attention.cuh"

using decode_attn::kBF16;
using decode_attn::kF32;

// q: [batch, h, hd]; k, v: [batch, s_len, kv, hd], all of `dtype` (f32 or
// bf16); lengths: int32 [batch] valid keys per sequence (0: every key
// masked, weights uniform over all s_len keys); out: [batch, h, hd] of
// `dtype`; partials: f32 [batch * h * n_splits * (hd + 2)] and counters:
// int32 [batch * kv], zero before the first call (the kernel leaves them
// zero), both unused when n_splits == 1; split_keys: keys a block covers;
// scale: hd^-0.5.  All contiguous on the device, 16-byte aligned.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, int dtype,
                                       const void* lengths, void* partials, void* counters,
                                       void* out, int batch, int h, int kv, int hd, int s_len,
                                       int n_splits, int split_keys, float scale,
                                       void* stream) {
  if (!decode_attn::valid_shape(batch, h, kv, hd, n_splits, split_keys, partials, counters) ||
      s_len <= 0 || (long long)(n_splits - 1) * split_keys >= s_len)
    return (int)cudaErrorInvalidValue;
  decode_attn::Params p{q, k, v, nullptr, (const int32_t*)lengths, out, (float*)partials,
                        (int32_t*)counters, h, kv, h / kv, s_len, 1, 0, n_splits, split_keys,
                        scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return decode_attn::launch<__nv_bfloat16, __nv_bfloat16, false>(p, batch, hd, s);
  if (dtype == kF32) return decode_attn::launch<float, float, false>(p, batch, hd, s);
  return (int)cudaErrorInvalidValue;
}
