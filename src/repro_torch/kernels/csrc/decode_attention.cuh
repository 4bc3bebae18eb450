// The split-key decode-attention core shared by K2 (paged) and K5
// (contiguous): single-token GQA attention, one query row per q head,
// over a KV cache whose rows are found either through a block table or
// at a fixed stride.
//
// What bounds it on an H100: bytes.  Each live K/V element is read once
// per (sequence, kv head) and used by the `group` q heads of that kv
// head: 8 f32 FLOP a byte at group 8, against the card's 67 TFLOP/s /
// 3.35 TB/s = 20, so at the bytes bound the FMA pipes are ~40% busy and
// the conversions and shared-memory round trips must stay small.  The
// design:
//
// * Split along the keys.  One block per (key split, kv head, sequence),
//   grid (n_splits, kv, batch); the wrapper picks split_keys from the
//   cache's capacity and the card's SMs (kernels/decode_attention.py,
//   split_plan).  Splits at or past ceil(active / split_keys) exit at
//   once.  A sequence with one live split writes its output directly;
//   with several, each split writes (m, l, acc) to f32 scratch and the
//   last split of its (sequence, kv head) to arrive, counted by an
//   atomic in `counters`, combines them and resets its counter to 0.
// * Eight warps a block (four where a K/V row exceeds 256 bytes), each an
//   independent online softmax over its own tiles of kKeys keys (tiles w,
//   w + kWarps, ... of the split), each with its own two-stage cp.async
//   ring: 16-byte copies, neighbouring lanes on neighbouring addresses,
//   the next tile in flight while the current one is scored.  No block
//   barrier in the main loop; the warps merge once at the end.
// * Scores.  bf16 q with bf16 K: Q.K^T on the tensor cores (mma.sync
//   m16n8k16, the group's q heads padded to 16 rows, q in registers;
//   bf16 products are exact in f32).  Other dtype pairs: one lane a key,
//   f32 FMAs against q staged in shared memory as f32.
// * Softmax in f32 (expf), a lane a key, max by shuffles.  P.V on the
//   FMA pipes in f32 with lanes over head dims: probabilities never
//   round below f32.
// * Masking as the reference: scores of keys >= length are -1e30; a
//   sequence of length 0 has every key masked and so weights uniform
//   over all `cap` keys (S, or max_blk * block_size).  Keys past a tile's
//   end get -inf, which adds exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace decode_attn {

enum Dtype { kF32 = 0, kBF16 = 1 };
constexpr int kMaxGroup = 16;
constexpr unsigned kFull = 0xffffffffu;
#define DECODE_ATTN_NEG_INF __int_as_float(0xff800000)

struct Params {
  const void* q;             // [batch, h, hd]
  const void* k;             // contiguous [batch, cap, kv, hd] or pool [nb, bs, kv, hd]
  const void* v;
  const int32_t* tables;     // [batch, max_blk] pool block ids (paged only)
  const int32_t* lengths;    // [batch] valid keys per sequence
  void* out;                 // [batch, h, hd] in q's dtype
  float* partials;           // [batch * kv * n_splits * group] x (hd + 2), n_splits > 1
  int32_t* counters;         // [batch * kv], all 0 between calls, n_splits > 1
  int h, kv, group;
  int cap;                   // keys a sequence can hold: S, or max_blk * bs
  int bs, max_blk;           // paged only
  int n_splits, split_keys;
  float scale;               // hd^-0.5, applied to q.k
};

// Keys a sequence runs over: its length, capped at the cache; all of
// them when every key is masked (length 0).
__device__ __forceinline__ int active_keys(int len, int cap) {
  return len > 0 ? (len < cap ? len : cap) : cap;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// N consecutive elements at smem address p (aligned to their size) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const unsigned char* p, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(p + 4 * i);
        out[i] = x.x, out[i + 1] = x.y, out[i + 2] = x.z, out[i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = reinterpret_cast<const float*>(p)[i];
    }
  } else {
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 8) {
        const uint4 w = *reinterpret_cast<const uint4*>(p + 2 * i);
        out[i] = bf16_lo(w.x), out[i + 1] = bf16_hi(w.x);
        out[i + 2] = bf16_lo(w.y), out[i + 3] = bf16_hi(w.y);
        out[i + 4] = bf16_lo(w.z), out[i + 5] = bf16_hi(w.z);
        out[i + 6] = bf16_lo(w.w), out[i + 7] = bf16_hi(w.w);
      }
    } else if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(p + 2 * i);
        out[i] = bf16_lo(w.x), out[i + 1] = bf16_hi(w.x);
        out[i + 2] = bf16_lo(w.y), out[i + 3] = bf16_hi(w.y);
      }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(p + 2 * i);
        out[i] = bf16_lo(w), out[i + 1] = bf16_hi(w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = to_f32(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
    }
  }
}

// 16 bytes from global to shared memory; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile geometry for one K/V element type and head dim.
template <typename TKV, int HD>
struct Geometry {
  static constexpr int kRowBytes = HD * (int)sizeof(TKV);
  static constexpr int kKeys = kRowBytes <= 512 ? 16 : 8;  // keys a warp stages at once
  static constexpr int kStride = kRowBytes + 16;           // padded row: no bank conflicts
  static constexpr int kChunks = kRowBytes / 16;           // 16-byte copies a row
  static constexpr int kStages = 2;                        // ring depth
  static constexpr int kWarps = kRowBytes <= 256 ? 8 : 4;  // within 227 KB of smem
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStageBytes = 2 * kKeys * kStride;  // K rows, then V rows
  static constexpr int kRingBytes = kStages * kStageBytes;  // one warp's ring
  // P.V: lanes over head dims, kDims each; kRowsAtOnce keys side by side
  static constexpr int kDims = HD >= 32 ? HD / 32 : 1;
  static constexpr int kLanesPerRow = HD / kDims;
  static constexpr int kRowsAtOnce = 32 / kLanesPerRow;
  static_assert(kRowBytes % 16 == 0, "a row must be whole 16-byte chunks");
  static_assert((kKeys * kChunks) % 32 == 0, "every lane copies the same number of chunks");
};

// Dynamic shared memory of one block, in bytes, and its layout.
template <typename TQ, typename TKV, int HD, int GB>
struct Layout {
  using G = Geometry<TKV, HD>;
  static constexpr bool kMma =
      std::is_same<TQ, __nv_bfloat16>::value && std::is_same<TKV, __nv_bfloat16>::value;
  static constexpr int kRing = G::kWarps * G::kRingBytes;
  static constexpr int kQ = kMma ? 0 : GB * HD * 4;                // q as f32 (FMA scores)
  static constexpr int kScores = G::kWarps * GB * G::kKeys * 4;  // [warp][g][key]
  static constexpr int kProbs = G::kWarps * G::kKeys * GB * 4;   // [warp][key][g]
  // per-warp (m, l); block (m, 1/l)
  static constexpr int kState = 2 * G::kWarps * GB * 4 + 2 * GB * 4;
  static constexpr int kFixed = kRing + kQ + kScores + kProbs + kState + 16;
  // The merge reuses the drained rings: the warps' accumulators, then the
  // combine's per-thread partials and a chunk of split weights.
  static constexpr int kCombineSplits = 32;  // splits whose weights the combine holds at once
  static_assert(GB * HD * 4 <= G::kRingBytes, "a warp's ring must hold its accumulator");
  static_assert((2 * G::kThreads + (kCombineSplits + 16) * GB) * 4 <= kRing,
                "the rings must hold the combine");
  static size_t bytes(int table_entries) { return kFixed + 4 * (size_t)table_entries; }
};

// Table entries a split of split_keys keys can touch.
__host__ __device__ inline int table_entries(int split_keys, int bs) {
  return (split_keys + bs - 1) / bs + 1;
}

template <typename TQ, typename TKV, int HD, int GB, bool PAGED>
__global__ void __launch_bounds__(Geometry<TKV, HD>::kThreads)
    decode_attention_core(const Params p) {
  using G = Geometry<TKV, HD>;
  using L = Layout<TQ, TKV, HD, GB>;
  constexpr int KT = G::kKeys;
  constexpr int D = G::kDims;
  constexpr int kOut = (GB * HD + G::kThreads - 1) / G::kThreads;  // outputs a thread merges
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = p.group;
  const int pair = b * p.kv + kvh;
  const int start = split * p.split_keys;
  const int len = p.lengths[b];

  unsigned char* ring_all = smem;
  float* q_s = reinterpret_cast<float*>(smem + L::kRing);
  float* s_all = reinterpret_cast<float*>(smem + L::kRing + L::kQ);
  float* p_all = s_all + G::kWarps * GB * KT;
  float* wm_s = p_all + G::kWarps * KT * GB;  // [warp][g] running max, then merge weights
  float* wl_s = wm_s + G::kWarps * GB;        // [warp][g] normaliser
  float* bm_s = wl_s + G::kWarps * GB;        // [g] block max
  float* bl_s = bm_s + GB;                    // [g] block normaliser, then its inverse
  int* flag_s = reinterpret_cast<int*>(bl_s + GB);
  int32_t* tbl_s = reinterpret_cast<int32_t*>(smem + L::kFixed);

  // The block-table entries this split can touch and q, loaded once and
  // independently of the length (whose load they overlap).
  const int first_blk = PAGED ? start / p.bs : 0;
  if constexpr (PAGED) {
    int n_tbl = table_entries(p.split_keys, p.bs);
    if (n_tbl > p.max_blk - first_blk) n_tbl = p.max_blk - first_blk;
    const int32_t* row = p.tables + (size_t)b * p.max_blk + first_blk;
    for (int i = threadIdx.x; i < n_tbl; i += G::kThreads) tbl_s[i] = row[i];
  }
  const size_t q_base = ((size_t)b * p.h + (size_t)kvh * group) * HD;
  // q: A fragments of m16n8k16 in registers (rows = the group's heads,
  // zero past the group), or f32 in smem (zero rows past the group)
  uint32_t qa[L::kMma ? HD / 16 : 1][4];
  if constexpr (L::kMma) {
    const uint16_t* qh = reinterpret_cast<const uint16_t*>(p.q) + q_base;
    const int gi = lane >> 2, ti = lane & 3;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c0 = ks * 16 + 2 * ti;
      auto word = [&](int g, int c) -> uint32_t {
        return g < group ? *reinterpret_cast<const uint32_t*>(qh + (size_t)g * HD + c) : 0u;
      };
      qa[ks][0] = word(gi, c0);
      qa[ks][1] = GB > 8 ? word(gi + 8, c0) : 0u;
      qa[ks][2] = word(gi, c0 + 8);
      qa[ks][3] = GB > 8 ? word(gi + 8, c0 + 8) : 0u;
    }
  } else {
    const TQ* qt = reinterpret_cast<const TQ*>(p.q) + q_base;
    for (int i = threadIdx.x; i < GB * HD; i += G::kThreads)
      q_s[i] = i < group * HD ? to_f32(qt[i]) : 0.0f;
  }
  const bool all_masked = len <= 0;
  const int active = active_keys(len, p.cap);
  const int n_live = (active + p.split_keys - 1) / p.split_keys;
  if (split >= n_live) return;  // every key of this split lies past the sequence
  const int end = start + p.split_keys < active ? start + p.split_keys : active;
  __syncthreads();

  // -- one warp's online softmax over tiles warp, warp + kWarps, ... -------
  // Every loop over heads runs all GB of them (rows past the group score 0
  // and are never written), so the heads' chains interleave.
  const int n_tiles = (end - start + KT - 1) / KT;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + G::kWarps - 1) / G::kWarps : 0;
  unsigned char* ring = ring_all + warp * G::kRingBytes;
  float* s_w = s_all + warp * GB * KT;
  float* p_w = p_all + warp * KT * GB;
  const char* kbase = static_cast<const char*>(p.k);
  const char* vbase = static_cast<const char*>(p.v);

  // K/V row index (in rows of HD elements) of key t of this sequence
  auto row_of = [&](int t) -> long long {
    if constexpr (PAGED) {
      const int blk = tbl_s[t / p.bs - first_blk];
      return ((long long)blk * p.bs + t % p.bs) * p.kv + kvh;
    } else {
      return ((long long)b * p.cap + t) * p.kv + kvh;
    }
  };
  auto fetch = [&](int i) {  // the i-th tile of this warp into stage i % kStages
    if (i < my_tiles) {
      const int t0 = start + (warp + i * G::kWarps) * KT;
      const int nt = end - t0 < KT ? end - t0 : KT;
      const long long my_row = lane < nt ? row_of(t0 + lane) : 0;
      unsigned char* st = ring + (i % G::kStages) * G::kStageBytes;
#pragma unroll
      for (int it = 0; it < KT * G::kChunks / 32; ++it) {
        const int c = it * 32 + lane;
        const int kk = c / G::kChunks, col = c % G::kChunks;
        const long long r = __shfl_sync(kFull, my_row, kk);
        const bool ok = kk < nt;
        const size_t off = ok ? (size_t)r * G::kRowBytes + col * 16 : 0;
        cp_async16(st + kk * G::kStride + col * 16, kbase + off, ok);
        cp_async16(st + (KT + kk) * G::kStride + col * 16, vbase + off, ok);
      }
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  };

  float m[GB], l[GB], acc[GB][D];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -1e30f;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc[g][j] = 0.0f;
  }
  const int kk_lane = lane & (KT - 1);  // softmax: a lane a key (lanes >= KT mirror)
  const int pv_row = lane / G::kLanesPerRow;
  const int pv_dim = (lane % G::kLanesPerRow) * D;

#pragma unroll 1
  for (int i = 0; i < G::kStages - 1; ++i) fetch(i);
#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    fetch(i + G::kStages - 1);
    cp_async_wait<G::kStages - 1>();
    __syncwarp();
    const int t0 = start + (warp + i * G::kWarps) * KT;
    const int nt = end - t0 < KT ? end - t0 : KT;
    const unsigned char* kst = ring + (i % G::kStages) * G::kStageBytes;
    const unsigned char* vst = kst + KT * G::kStride;

    // scores q.k * scale -> s_w[g][key]
    if constexpr (L::kMma) {
      const int gi = lane >> 2, ti = lane & 3;
      float c[KT / 8][4];
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb) c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb) {
          const unsigned char* krow = kst + (nb * 8 + gi) * G::kStride + 4 * ti + ks * 32;
          mma_bf16(c[nb], qa[ks], *reinterpret_cast<const uint32_t*>(krow),
                   *reinterpret_cast<const uint32_t*>(krow + 16));
        }
      }
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb) {
        const int key = nb * 8 + 2 * ti;
        *reinterpret_cast<float2*>(s_w + gi * KT + key) =
            make_float2(c[nb][0] * p.scale, c[nb][1] * p.scale);
        if (GB > 8)
          *reinterpret_cast<float2*>(s_w + (gi + 8) * KT + key) =
              make_float2(c[nb][2] * p.scale, c[nb][3] * p.scale);
      }
    } else if (lane < KT) {
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.0f;
      const unsigned char* krow = kst + lane * G::kStride;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float kx[4];
        load_f32<TKV, 4>(krow + d * (int)sizeof(TKV), kx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + g * HD + d);
          s[g] = fmaf(qv.x, kx[0], s[g]);
          s[g] = fmaf(qv.y, kx[1], s[g]);
          s[g] = fmaf(qv.z, kx[2], s[g]);
          s[g] = fmaf(qv.w, kx[3], s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) s_w[g * KT + lane] = s[g] * p.scale;
    }
    __syncwarp();

    // online softmax: new max, rescale c = exp(m_old - m_new), p -> p_w[key][g]
    float c[GB], s[GB], mx[GB];
    const bool in_tile = kk_lane < nt;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      s[g] = in_tile ? (all_masked ? -1e30f : s_w[g * KT + kk_lane]) : DECODE_ATTN_NEG_INF;
      mx[g] = s[g];
    }
#pragma unroll
    for (int o = KT / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(kFull, mx[g], o));
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      c[g] = expf(m[g] - m_new);
      const float pr = expf(s[g] - m_new);
      l[g] = l[g] * c[g] + pr;
      m[g] = m_new;
      s[g] = pr;
    }
    if (lane < KT) {
#pragma unroll
      for (int g = 0; g < GB; g += 4)
        *reinterpret_cast<float4*>(p_w + kk_lane * GB + g) =
            make_float4(s[g], s[g + 1], s[g + 2], s[g + 3]);
    }
    __syncwarp();

    // P.V: lanes over head dims
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < D; ++j) acc[g][j] *= c[g];
    }
#pragma unroll 2
    for (int kk = pv_row; kk < nt; kk += G::kRowsAtOnce) {
      float v[D];
      load_f32<TKV, D>(vst + kk * G::kStride + pv_dim * (int)sizeof(TKV), v);
      const float* pr = p_w + kk * GB;
#pragma unroll
      for (int g4 = 0; g4 < GB; g4 += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(pr + g4);
        const float pg[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < D; ++j) acc[g4 + u][j] = fmaf(pg[u], v[j], acc[g4 + u][j]);
        }
      }
    }
    __syncwarp();  // the next fetch() refills this stage
  }
  cp_async_wait<0>();
  __syncwarp();

  // -- merge the warps -----------------------------------------------------
#pragma unroll
  for (int o = KT / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) l[g] += __shfl_xor_sync(kFull, l[g], o);
  }
#pragma unroll
  for (int o = G::kLanesPerRow; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < D; ++j) acc[g][j] += __shfl_xor_sync(kFull, acc[g][j], o);
    }
  }
  float* acc_w = reinterpret_cast<float*>(ring);  // [g][HD], this warp's ring is drained
  if (pv_row == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < D; ++j) acc_w[g * HD + pv_dim + j] = acc[g][j];
    }
  }
  if (lane < GB) {
    float mg = m[0], lg = l[0];
#pragma unroll
    for (int g = 1; g < GB; ++g) {
      if (lane == g) mg = m[g], lg = l[g];
    }
    wm_s[warp * GB + lane] = mg;
    wl_s[warp * GB + lane] = lg;
  }
  __syncthreads();
  if (threadIdx.x < GB) {  // block max and normaliser; the warps' weights
    const int g = threadIdx.x;
    float mb = wm_s[g];
#pragma unroll
    for (int w = 1; w < G::kWarps; ++w) mb = fmaxf(mb, wm_s[w * GB + g]);
    float lb = 0.0f;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w) {
      const float e = expf(wm_s[w * GB + g] - mb);
      lb += wl_s[w * GB + g] * e;
      wm_s[w * GB + g] = e;
    }
    bm_s[g] = mb;
    bl_s[g] = lb;
  }
  __syncthreads();
  const bool direct = n_live == 1;
  const size_t rows = (size_t)p.n_splits * p.kv * gridDim.z * group;  // partial rows in all
  float* part_acc = p.partials;  // [pair][split][g][HD]
  float* part_m = p.partials + rows * HD;
  float* part_l = part_m + rows;
  const size_t part_row = ((size_t)pair * p.n_splits + split) * group;  // + g
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int idx = threadIdx.x + k * G::kThreads;
    if (idx >= group * HD) break;
    const int g = idx / HD, d = idx % HD;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w)
      a += reinterpret_cast<const float*>(ring_all + w * G::kRingBytes)[g * HD + d] *
           wm_s[w * GB + g];
    if (direct)
      store(reinterpret_cast<TQ*>(p.out) + q_base + idx, a / bl_s[g]);
    else
      part_acc[part_row * HD + idx] = a;
  }
  if (direct) return;
  if (threadIdx.x < group) {
    part_m[part_row + threadIdx.x] = bm_s[threadIdx.x];
    part_l[part_row + threadIdx.x] = bl_s[threadIdx.x];
  }

  // -- the last split of this (sequence, kv head) to finish combines --------
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag_s = atomicAdd(p.counters + pair, 1) == n_live - 1;
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  const size_t row0 = (size_t)pair * p.n_splits * group;  // split 0, head 0
  // Each thread folds (m, l) of splits c = t / GB, t / GB + kThreads / GB,
  // ... of head g = t % GB into a running (max, sum), keeping the maxima of
  // the first kMCache splits in smem for the weights; the rings are free.
  constexpr int kStep = G::kThreads / GB;
  constexpr int kMCache = (L::kRing / 4 - 2 * G::kThreads - L::kCombineSplits * GB) / GB;
  float* red_m = reinterpret_cast<float*>(ring_all);  // [kThreads]
  float* red_l = red_m + G::kThreads;                 // [kThreads]
  float* w_s = red_l + G::kThreads;                   // [kCombineSplits][GB]
  float* m_all = w_s + L::kCombineSplits * GB;        // [kMCache][GB]
  const int tg = threadIdx.x % GB, tc = threadIdx.x / GB;
  float mx_t = DECODE_ATTN_NEG_INF, sum_t = 0.0f;
  if (tg < group) {
    for (int c = tc; c < n_live; c += kStep) {
      const size_t r = row0 + (size_t)c * group + tg;
      const float mc = __ldcg(part_m + r), lc = __ldcg(part_l + r);
      if (c < kMCache) m_all[c * GB + tg] = mc;
      const float nm = fmaxf(mx_t, mc);
      sum_t = sum_t * expf(mx_t - nm) + lc * expf(mc - nm);
      mx_t = nm;
    }
  }
  red_m[threadIdx.x] = mx_t;
  red_l[threadIdx.x] = sum_t;
  __syncthreads();
  if (threadIdx.x < group) {
    float mb = DECODE_ATTN_NEG_INF;
    for (int j = 0; j < kStep; ++j) mb = fmaxf(mb, red_m[threadIdx.x + j * GB]);
    float lb = 0.0f;
    for (int j = 0; j < kStep; ++j)
      lb += red_l[threadIdx.x + j * GB] * expf(red_m[threadIdx.x + j * GB] - mb);
    bm_s[threadIdx.x] = mb;
    bl_s[threadIdx.x] = 1.0f / lb;
  }
  float a[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) a[k] = 0.0f;
  for (int c0 = 0; c0 < n_live; c0 += L::kCombineSplits) {
    const int nc = n_live - c0 < L::kCombineSplits ? n_live - c0 : L::kCombineSplits;
    __syncthreads();  // bl_s is written; the previous chunk's weights are used up
    for (int t = threadIdx.x; t < nc * GB; t += G::kThreads) {
      const int c = c0 + t / GB, g = t % GB;
      if (g < group) {
        const float mc = c < kMCache ? m_all[c * GB + g]
                                     : __ldcg(part_m + row0 + (size_t)c * group + g);
        w_s[t] = expf(mc - bm_s[g]) * bl_s[g];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < nc; ++c) {
      const float* src = part_acc + (row0 + (size_t)(c0 + c) * group) * HD;
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int idx = threadIdx.x + k * G::kThreads;
        if (idx < group * HD) a[k] += __ldcg(src + idx) * w_s[c * GB + idx / HD];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int idx = threadIdx.x + k * G::kThreads;
    if (idx < group * HD) store(reinterpret_cast<TQ*>(p.out) + q_base + idx, a[k]);
  }
  if (threadIdx.x == 0) p.counters[pair] = 0;  // ready for the next call
}

template <typename TQ, typename TKV, int HD, int GB, bool PAGED>
int launch_one(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<TQ, TKV, HD, GB>;
  const size_t smem = L::bytes(PAGED ? table_entries(p.split_keys, p.bs) : 0);
  auto kernel = decode_attention_core<TQ, TKV, HD, GB, PAGED>;
  static size_t attr = 0;  // the largest dynamic shared memory set so far
  if (smem > attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  kernel<<<dim3(p.n_splits, p.kv, batch), Geometry<TKV, HD>::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The head dims compiled in, and the register bucket of the group.
template <typename TQ, typename TKV, bool PAGED>
int launch(const Params& p, int batch, int hd, cudaStream_t s) {
  const bool small = p.group <= 8;
#define DECODE_ATTN_HD(HD)                                                        \
  if (hd == HD)                                                                   \
    return small ? launch_one<TQ, TKV, HD, 8, PAGED>(p, batch, s)                 \
                 : launch_one<TQ, TKV, HD, 16, PAGED>(p, batch, s);
  DECODE_ATTN_HD(16)
  DECODE_ATTN_HD(32)
  DECODE_ATTN_HD(64)
  DECODE_ATTN_HD(128)
  DECODE_ATTN_HD(256)
#undef DECODE_ATTN_HD
  return (int)cudaErrorInvalidValue;
}

// Shape checks common to both entry points.
inline bool valid_shape(int batch, int h, int kv, int hd, int n_splits, int split_keys,
                        const void* partials, const void* counters) {
  if (batch <= 0 || batch > 65535 || kv <= 0 || kv > 65535 || h % kv != 0 ||
      h / kv > kMaxGroup || n_splits <= 0 || split_keys <= 0)
    return false;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256) return false;
  return n_splits == 1 || (partials != nullptr && counters != nullptr);
}

}  // namespace decode_attn
