// Single-token GQA decode attention over a contiguous KV cache, split
// along the sequence.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_kernel).  That kernel walks S in order on one core,
// carrying (m, l, acc) in VMEM scratch from one grid step to the next,
// over a cache padded to a 512 multiple.  A contiguous cache at yi-6b's
// widths gives only batch x kv = 16 (sequence, kv head) pairs, so one
// block per pair would leave most of the 132 SMs idle.  Here the keys are
// cut into chunks instead:
//
//   1. decode_attention_chunk_kernel, grid (chunks, kv, batch): one block
//      per (chunk, kv head, sequence) covers the `group` q heads of that
//      kv head.  It stages tiles of K and V in shared memory as f32,
//      computes scores (q * hd^-0.5) . k, masks positions >= length with
//      -1e30, and keeps an online softmax (running max m, normaliser l,
//      unnormalised accumulator acc) in f32.  It writes (m, l, acc) of
//      its chunk to f32 scratch that the wrapper allocates.  Chunks at or
//      past ceil(length / chunk) exit at once: their keys are all masked
//      and would add exactly 0.
//   2. decode_attention_combine_kernel, grid (h, batch): rescales each
//      live chunk's (l, acc) to the common max and writes acc / l in q's
//      dtype.
//
// A sequence of length 0 has every key masked; as in the plain version
// its weights are then uniform over all S keys, so such a sequence runs
// every chunk.
//
// What bounds it on an H100: bytes.  Each live K/V element is read once
// (per sequence and kv head) and used `group` times in f32 FMAs, far
// below the card's compute rate; the design reads each row with
// consecutive threads on consecutive head dims (coalesced), and only the
// small per-chunk state goes back to memory between the two kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1 };
constexpr int kMaxGroup = 16;
constexpr int kMaxTile = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Keys a sequence of this length runs over: all S when every key is masked.
__device__ __forceinline__ int active_keys(int len, int s_len) {
  return len > 0 ? (len < s_len ? len : s_len) : s_len;
}

// grid (chunks, kv, batch); blockDim.x == hd (one thread per head dim).
template <typename T>
__global__ void decode_attention_chunk_kernel(const T* __restrict__ q,
                                              const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              const int32_t* __restrict__ lengths,
                                              float* __restrict__ m_part,
                                              float* __restrict__ l_part,
                                              float* __restrict__ acc_part, int h, int kv,
                                              int hd, int s_len, int chunk, int tile,
                                              float scale) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int group = h / kv;
  const int len = lengths[b];
  const int start = c * chunk;
  const int active = active_keys(len, s_len);
  if (start >= active) return;  // every key of this chunk is masked
  const int end = start + chunk < active ? start + chunk : active;

  float* q_s = smem;                  // [group][hd], q * hd^-0.5
  float* k_s = q_s + group * hd;      // [tile][hd + 1] (padded: rows read across threads)
  float* v_s = k_s + tile * (hd + 1); // [tile][hd]
  float* p_s = v_s + tile * hd;       // [group][tile] scores, then probabilities
  float* m_s = p_s + group * tile;    // [group] running max
  float* c_s = m_s + group;           // [group] rescale of the old state
  float* l_s = c_s + group;           // [group] running normaliser

  for (int g = 0; g < group; ++g)
    q_s[g * hd + d] = to_f32(q[((size_t)b * h + kvh * group + g) * hd + d]) * scale;
  for (int g = d; g < group; g += hd) {
    m_s[g] = -1e30f;
    l_s[g] = 0.0f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += tile) {
    const int nt = end - t0 < tile ? end - t0 : tile;
    for (int s = 0; s < nt; ++s) {
      const size_t off = (((size_t)b * s_len + t0 + s) * kv + kvh) * hd + d;
      k_s[s * (hd + 1) + d] = to_f32(k[off]);
      v_s[s * hd + d] = to_f32(v[off]);
    }
    __syncthreads();
    for (int idx = d; idx < group * nt; idx += hd) {
      const int g = idx / nt, s = idx % nt;
      float dot = 0.0f;
      for (int e = 0; e < hd; ++e) dot += q_s[g * hd + e] * k_s[s * (hd + 1) + e];
      p_s[g * tile + s] = t0 + s < len ? dot : -1e30f;
    }
    __syncthreads();
    for (int g = d; g < group; g += hd) {
      const float m_old = m_s[g];
      float m_new = m_old;
      for (int s = 0; s < nt; ++s) m_new = fmaxf(m_new, p_s[g * tile + s]);
      m_s[g] = m_new;
      c_s[g] = expf(m_old - m_new);
    }
    __syncthreads();
    for (int idx = d; idx < group * nt; idx += hd) {
      const int g = idx / nt, s = idx % nt;
      p_s[g * tile + s] = expf(p_s[g * tile + s] - m_s[g]);
    }
    __syncthreads();
    for (int g = d; g < group; g += hd) {
      float l = l_s[g] * c_s[g];
      for (int s = 0; s < nt; ++s) l += p_s[g * tile + s];
      l_s[g] = l;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
      float a = acc[g] * c_s[g];
      for (int s = 0; s < nt; ++s) a += p_s[g * tile + s] * v_s[s * hd + d];
      acc[g] = a;
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

  const int n_chunks = gridDim.x;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    const size_t p = ((size_t)b * h + kvh * group + g) * n_chunks + c;
    acc_part[p * hd + d] = acc[g];
  }
  for (int g = d; g < group; g += hd) {  // the threads that last wrote m_s, l_s
    const size_t p = ((size_t)b * h + kvh * group + g) * n_chunks + c;
    m_part[p] = m_s[g];
    l_part[p] = l_s[g];
  }
}

// grid (h, batch); blockDim.x == hd.
template <typename T>
__global__ void decode_attention_combine_kernel(const int32_t* __restrict__ lengths,
                                                const float* __restrict__ m_part,
                                                const float* __restrict__ l_part,
                                                const float* __restrict__ acc_part,
                                                T* __restrict__ out, int h, int hd, int s_len,
                                                int chunk, int n_chunks) {
  const int hh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int live = (active_keys(lengths[b], s_len) + chunk - 1) / chunk;
  const size_t base = ((size_t)b * h + hh) * n_chunks;
  float m = -1e30f;
  for (int c = 0; c < live; ++c) m = fmaxf(m, m_part[base + c]);
  float l = 0.0f, a = 0.0f;
  for (int c = 0; c < live; ++c) {
    const float w = expf(m_part[base + c] - m);
    l += l_part[base + c] * w;
    a += acc_part[(base + c) * hd + d] * w;
  }
  store(out + ((size_t)b * h + hh) * hd + d, a / l);
}

size_t chunk_smem(int group, int hd, int tile) {
  return sizeof(float) * ((size_t)group * hd + (size_t)tile * (hd + 1) + (size_t)tile * hd +
                          (size_t)group * tile + 3 * (size_t)group);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int32_t* lengths, float* m_part,
           float* l_part, float* acc_part, void* out, int batch, int h, int kv, int hd,
           int s_len, int chunk, float scale, cudaStream_t stream) {
  const int group = h / kv;
  int tile = kMaxTile < chunk ? kMaxTile : chunk;
  while (tile > 1 && chunk_smem(group, hd, tile) > 48 * 1024) tile /= 2;
  const size_t smem = chunk_smem(group, hd, tile);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int n_chunks = (s_len + chunk - 1) / chunk;
  decode_attention_chunk_kernel<T><<<dim3(n_chunks, kv, batch), hd, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, m_part, l_part, acc_part, h, kv, hd,
      s_len, chunk, tile, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine_kernel<T><<<dim3(h, batch), hd, 0, stream>>>(
      lengths, m_part, l_part, acc_part, (T*)out, h, hd, s_len, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [batch, h, hd]; k, v: [batch, s_len, kv, hd], all of `dtype` (f32 or
// bf16); lengths: int32 [batch] valid keys per sequence; m_part, l_part:
// f32 [batch, h, chunks] and acc_part: f32 [batch, h, chunks, hd] scratch,
// chunks = ceil(s_len / chunk); out: [batch, h, hd] of `dtype`; scale:
// hd^-0.5.  All contiguous on the device.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, int dtype,
                                       const void* lengths, void* m_part, void* l_part,
                                       void* acc_part, void* out, int batch, int h, int kv,
                                       int hd, int s_len, int chunk, float scale,
                                       void* stream) {
  if (batch <= 0 || kv <= 0 || h % kv != 0 || h / kv > kMaxGroup || hd <= 0 || hd > 1024 ||
      s_len <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* l = (const int32_t*)lengths;
  float* mp = (float*)m_part;
  float* lp = (float*)l_part;
  float* ap = (float*)acc_part;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, l, mp, lp, ap, out, batch, h, kv, hd, s_len, chunk,
                                 scale, s);
  if (dtype == kF32)
    return launch<float>(q, k, v, l, mp, lp, ap, out, batch, h, kv, hd, s_len, chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}
