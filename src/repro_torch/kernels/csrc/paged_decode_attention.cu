// K2: single-token GQA decode attention over a paged KV pool.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention_kernel (_paged_kernel), which walks a sequence's
// block table one pool block a grid step on one core, carrying the
// online softmax in VMEM.  Here the keys of each (sequence, kv head) are
// split across blocks of the shared core in decode_attention.cuh, which
// reads each split's slice of the block-table row into shared memory once
// and streams the pool rows it names (never a gathered copy).
//
// What bounds it on an H100: bytes (each live K/V row read once per
// sequence and kv head); what the design does about it is in the core's
// header.  At serving contexts (tens of keys) one split covers a
// sequence and the kernel is one short launch; at long contexts the
// splits fill the card.
#include "decode_attention.cuh"

using decode_attn::kBF16;
using decode_attn::kF32;

// q: [batch, h, hd]; k_pool, v_pool: [num_blocks, bs, kv, hd];
// block_tables: int32 [batch, max_blk] (rows padded with any valid block
// id); lengths: int32 [batch] valid keys per sequence (0: every key
// masked, weights uniform over all max_blk * bs keys); out: [batch, h,
// hd] in q's dtype; partials: f32 [batch * h * n_splits * (hd + 2)] and
// counters: int32 [batch * kv], zero before the first call (the kernel
// leaves them zero), both unused when n_splits == 1; split_keys: keys a
// block covers; scale: hd^-0.5.  All contiguous on the device, 16-byte
// aligned.
extern "C" int paged_decode_attention_launch(const void* q, int q_dtype, const void* k_pool,
                                             const void* v_pool, int kv_dtype,
                                             const void* block_tables, const void* lengths,
                                             void* out, void* partials, void* counters,
                                             int batch, int h, int kv, int hd, int bs,
                                             int max_blk, int n_splits, int split_keys,
                                             float scale, void* stream) {
  if (!decode_attn::valid_shape(batch, h, kv, hd, n_splits, split_keys, partials, counters) ||
      bs <= 0 || max_blk <= 0 || (long long)max_blk * bs > (1LL << 30) ||
      (long long)(n_splits - 1) * split_keys >= (long long)max_blk * bs)
    return (int)cudaErrorInvalidValue;
  decode_attn::Params p{q, k_pool, v_pool, (const int32_t*)block_tables, (const int32_t*)lengths,
                        out, (float*)partials, (int32_t*)counters, h, kv, h / kv,
                        max_blk * bs, bs, max_blk, n_splits, split_keys, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return decode_attn::launch<bf16, bf16, true>(p, batch, hd, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return decode_attn::launch<float, bf16, true>(p, batch, hd, s);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return decode_attn::launch<float, float, true>(p, batch, hd, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return decode_attn::launch<bf16, float, true>(p, batch, hd, s);
  return (int)cudaErrorInvalidValue;
}
