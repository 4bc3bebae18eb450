// Single-token GQA decode attention over a paged KV pool.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention_kernel (_paged_kernel).  One block per
// (kv head, sequence) covers the `group` q heads that share that kv head.
// The block reads its sequence's block-table row itself and streams the
// pool blocks it names (never a gathered copy): for each block it stages
// K and V in shared memory as f32, computes f32 scores q.k * hd^-0.5,
// masks positions >= length with -1e30, and updates an online softmax
// (running max m, normaliser l, accumulator acc) held in f32.  It writes
// acc / l in q's dtype.  Blocks past ceil(length / block_size) are
// skipped: a fully masked block would add exactly 0 and scale by exactly 1.
//
// What bounds it on an H100: bytes.  At decode every K/V element of the
// live context is read once (2 x bytes of the context per layer) and each
// is used `group` times in f32 FMAs, far below the card's compute rate.
// The design reads each K/V element once per (sequence, kv head), with
// consecutive threads on consecutive head dims (coalesced), and keeps the
// softmax state on chip: nothing but the output goes back to memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1 };
constexpr int kMaxGroup = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// grid (kv, batch); blockDim.x == hd (one thread per head dim).
template <typename TQ, typename TKV>
__global__ void paged_decode_attention_kernel(const TQ* __restrict__ q,
                                              const TKV* __restrict__ k_pool,
                                              const TKV* __restrict__ v_pool,
                                              const int32_t* __restrict__ block_tables,
                                              const int32_t* __restrict__ lengths,
                                              TQ* __restrict__ out, int h, int kv, int hd,
                                              int bs, int max_blk, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int group = h / kv;
  float* q_s = smem;                    // [group][hd]
  float* k_s = q_s + group * hd;        // [bs][hd + 1] (padded: rows read across threads)
  float* v_s = k_s + bs * (hd + 1);     // [bs][hd]
  float* p_s = v_s + bs * hd;           // [group][bs] scores, then probabilities
  float* m_s = p_s + group * bs;        // [group] running max
  float* c_s = m_s + group;             // [group] rescale of the old state
  float* l_s = c_s + group;             // [group] running normaliser

  for (int g = 0; g < group; ++g)
    q_s[g * hd + d] = to_f32(q[((size_t)b * h + kvh * group + g) * hd + d]);
  if (d < group) {
    m_s[d] = -1e30f;
    l_s[d] = 0.0f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;

  const int len = lengths[b];
  int nblk = (len + bs - 1) / bs;
  if (nblk > max_blk) nblk = max_blk;
  __syncthreads();

  for (int i = 0; i < nblk; ++i) {
    const int blk = block_tables[(size_t)b * max_blk + i];
    for (int s = 0; s < bs; ++s) {
      const size_t off = (((size_t)blk * bs + s) * kv + kvh) * hd + d;
      k_s[s * (hd + 1) + d] = to_f32(k_pool[off]);
      v_s[s * hd + d] = to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int idx = d; idx < group * bs; idx += hd) {
      const int g = idx / bs, s = idx % bs;
      float dot = 0.0f;
      for (int e = 0; e < hd; ++e) dot += q_s[g * hd + e] * k_s[s * (hd + 1) + e];
      p_s[idx] = (i * bs + s < len) ? dot * scale : -1e30f;
    }
    __syncthreads();
    if (d < group) {
      const float m_old = m_s[d];
      float m_new = m_old;
      for (int s = 0; s < bs; ++s) m_new = fmaxf(m_new, p_s[d * bs + s]);
      m_s[d] = m_new;
      c_s[d] = expf(m_old - m_new);
    }
    __syncthreads();
    for (int idx = d; idx < group * bs; idx += hd) p_s[idx] = expf(p_s[idx] - m_s[idx / bs]);
    __syncthreads();
    if (d < group) {
      float l = l_s[d] * c_s[d];
      for (int s = 0; s < bs; ++s) l += p_s[d * bs + s];
      l_s[d] = l;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
      float a = acc[g] * c_s[g];
      for (int s = 0; s < bs; ++s) a += p_s[g * bs + s] * v_s[s * hd + d];
      acc[g] = a;
    }
    __syncthreads();  // the next block overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    store(out + ((size_t)b * h + kvh * group + g) * hd + d, acc[g] / l_s[g]);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const int32_t* tables,
           const int32_t* lengths, void* out, int batch, int h, int kv, int hd, int bs,
           int max_blk, float scale, cudaStream_t stream) {
  const int group = h / kv;
  const size_t smem =
      sizeof(float) * ((size_t)group * hd + (size_t)bs * (hd + 1) + (size_t)bs * hd +
                       (size_t)group * bs + 3 * (size_t)group);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  paged_decode_attention_kernel<TQ, TKV><<<dim3(kv, batch), hd, smem, stream>>>(
      (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, tables, lengths, (TQ*)out, h, kv,
      hd, bs, max_blk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [batch, h, hd]; k_pool, v_pool: [num_blocks, bs, kv, hd]; block_tables:
// int32 [batch, max_blk]; lengths: int32 [batch] valid keys per sequence;
// out: [batch, h, hd] in q's dtype; scale: the score scale hd^-0.5.  All
// contiguous on the device.
extern "C" int paged_decode_attention_launch(const void* q, int q_dtype, const void* k_pool,
                                             const void* v_pool, int kv_dtype,
                                             const void* block_tables, const void* lengths,
                                             void* out, int batch, int h, int kv, int hd,
                                             int bs, int max_blk, float scale,
                                             void* stream) {
  if (batch <= 0 || kv <= 0 || h % kv != 0 || h / kv > kMaxGroup || hd <= 0 || hd > 1024 ||
      bs <= 0 || max_blk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* t = (const int32_t*)block_tables;
  const int32_t* l = (const int32_t*)lengths;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, t, l, out, batch, h, kv, hd,
                                                 bs, max_blk, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch<float, __nv_bfloat16>(q, k_pool, v_pool, t, l, out, batch, h, kv, hd, bs,
                                        max_blk, scale, s);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float>(q, k_pool, v_pool, t, l, out, batch, h, kv, hd, bs, max_blk,
                                scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch<__nv_bfloat16, float>(q, k_pool, v_pool, t, l, out, batch, h, kv, hd, bs,
                                        max_blk, scale, s);
  return (int)cudaErrorInvalidValue;
}
