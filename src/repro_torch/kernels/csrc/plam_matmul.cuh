// PLAM matmul on Hopper: C[M,N] = sum_k PLAM(A[m,k], B[k,n]), f32 sums.
//
// Replaces the Pallas TPU kernel repro/kernels/plam_matmul.py::plam_matmul
// (_plam_matmul_kernel, _log_words).  Each product is one 32-bit integer
// add of two pre-decoded log words (posit.cuh::log_word) and a bitcast;
// zero and NaR lanes contribute +0.0.
//
// Two entry points share these kernels: plam_matmul.cu takes A as int32
// posit patterns (kPatternA), plam_dense.cu takes A as the float
// activations themselves (kFloatA: f32, or bf16 as the serving path
// gives them) and encodes them where the pattern kernel decodes A's
// patterns, with posit.cuh::a_word: log_word(encode(x)) in one step, and
// for a bf16 value at a scale the posit holds exactly just x's own bits.
// So a plam_sim projection is one launch and no int32 pattern tensor
// passes through device memory.  Each entry instantiates only its own A.
//
// Bit identity with the sequential reference (kernels/ref.py::
// plam_matmul_seqref) rules the design: every output is owned by one
// thread that walks k strictly ascending in one f32 accumulator, starting
// at +0.0.  So there is no split-K, no tree sum and no atomics: each
// would change the order of the f32 adds.  Ragged M, N and K read as zero
// patterns, whose products add +0.0 and leave a sum unchanged (a sum of
// products is never -0.0: every valid product is a normal f32).  Tensor
// cores (wgmma) cannot help: a PLAM product is an integer add of log
// words, not a multiply.  TMA is not used either: its tensor maps are
// made by cuTensorMapEncodeTiled in libcuda, which this library (plain
// nvcc, bound with ctypes) does not link, and cp.async already keeps
// the loads in flight here.
//
// What bounds it on an H100: decoding B.  A decode call (M <= 16) reads
// each int16 weight once and uses it M times, so its bytes are few
// (K*N*2) and its work is the decode of K*N patterns into log words.
// Operations of one log_word, counted by hand as posit_mul.cu counts
// K4's (one per operator, comparison, select or clz on a lane's values;
// values of the spec alone are hoisted and not counted):
//
//                     ALU-only   add-like   clz
//   decode_fields        16          8       1
//   log_word glue         3          5       -   (mantissa shift, +127,
//                                                  <<23, sign<<31, add;
//                                                  or, valid, select)
//   log_word             19         13       1   = 33
//   product, per row      2          1       -   + one f32 add (two
//                                                  compares, one add)
//
// The ALU pipe (64 lanes per SM per clock) binds: a B pattern costs at
// least 19 + 2*M ALU-only operations, 27 at M = 4, against 2 bytes.
// At M = 4, K = 4096, N = 4096 that is 0.027 ms on 132 SMs at 1980 MHz,
// against 0.010 ms for the bytes.  chip_smoke.py reads the two counts
// below for this "design floor"; the bound it reports stays the true
// floor (one add per product, or the bytes).
//
// What the decode path (M <= 16) does about it:
// - Decoding is parted from owning outputs, in separate warps.  256
//   decoder threads copy and decode a [BK, BN] tile of B (2048 patterns,
//   8 a thread) and the [BK, MT] tile of A into uint32 log words in
//   shared memory, word 0 meaning zero or NaR, while 4*BN owner threads
//   (four per column, MT/4 rows each) add the previous tile's products
//   in k order.  A B word is decoded once and used M times, and the
//   owners load 16 k steps of words before adding them, so that a
//   shared-memory latency is paid per batch and not per step.
// - The strip width BN (8 to 64 columns) is chosen from N and the SM
//   count (strip_width) so that the grid's last wave is not a tail:
//   8 columns at N = 512, 32 at 4096 and 11008, 64 at 64000.
// - Loads stay in flight: a ring of kStages tiles of raw patterns is
//   filled with cp.async, tiles t+2 .. t+kStages landing while tile t+1
//   is decoded and tile t summed, and the decoded words are
//   double-buffered, so that each tile costs one barrier.  Each decoder
//   decodes exactly the patterns it copied, so it waits only for its own
//   copies.  B rows that start on 16 bytes (N % 8 == 0 for int16,
//   N % 4 == 0 for int32, an aligned base) are copied 16 bytes a thread;
//   other shapes read B with guarded scalar loads at decode time.
// - Float A (kFloatA): f32 is staged as the patterns are; bf16 rows that
//   start on 4 bytes (even K, an aligned base) are staged two elements a
//   4-byte cp.async, k-major, and decoded by the thread that copied them;
//   other bf16 shapes read A with guarded 2-byte loads at decode time, so
//   that no load crosses a row's end.  a_word takes a bf16 in its exact
//   range in a range check and a copy, cheaper than A's log_word.
// - int16 B at Posit<16,1>, the prequantized weights of the serving
//   path, runs with the spec compiled in (plam::FixedSpec), so that
//   decode_fields' masks, shifts and branches fold into immediates.
//
// The prefill path (M > 16): a decoded B word serves up to 64 rows, so the
// decode is amortised and the products bind.  One fixed register-tiled
// kernel:
// - 256 threads own a 64-row x BN-column block, each TM = 4 rows x TN =
//   BN/16 columns (16, 8 or 4 independent f32 chains), k ascending.
// - Each k-tile (BK = 32) is decoded once into uint32 words in shared
//   memory, word 0 meaning zero or NaR as in the decode path: A k-major
//   [BK][64], B [BK][BN], so that a thread reads its 4 A words and its TN
//   B words with one 16-byte and one 4- to 16-byte load per k step.  It
//   loads 8 k steps of words before adding them.
// - A tile with no 0 word where an output is kept (the decoders OR their
//   notes into the barrier that ends the iteration, __syncthreads_or) runs
//   the fast loop: per product one integer add (the A word's bias comes off
//   once per k step) and one f32 add, no branch and no select.  Otherwise,
//   and at a ragged K tail, the slow loop skips the products of 0 words.
//   Random posit weights hold no zero pattern and posits never round to
//   zero, so on the serve path every full tile is fast.
// - Loads stay in flight: a 3-stage cp.async ring of raw tiles; iteration
//   t copies tile t + 2, decodes tile t + 1 and adds tile t, behind one
//   barrier.  Every thread copies one 4-, 8- or 16-byte piece of B (BN =
//   16, 32, 64 over int16) and 16 bytes a copy of A, and decodes what it
//   copied.  Rows that do not start on 16 bytes (K % 4 != 0 for 4-byte A,
//   K % 8 != 0 for bf16, N % 8 != 0 for int16 B, N % 4 != 0 for int32 B)
//   are read with guarded scalar loads at decode time.
// - int16 B at Posit<16,1> runs with the spec compiled in, and BN from
//   prefill_width (waves of blocks over the SMs, times BN): 32 at N =
//   4096 and 11008, 16 at N = 512.  Other (B type, spec) pairs run the
//   run-time spec at BN = 32.
//
// Grouped over experts: the reference runs the expert projections of its
// MoE layer as jax.vmap over [E, C, K] x [E, K, N] (repro/models/moe.py),
// which batches the Pallas kernel over an expert axis.  Here both paths
// put the expert in blockIdx.z: a block offsets A, B and C by its
// expert's strides (Group) and then runs the tile above unchanged, so
// that one launch covers all E experts, each bit-identical to a launch
// of its own.  The strip widths count the E * blocks of the whole grid.
// E = 1 is the ungrouped launch.
//
// Its instructions, counted by hand as above (one per operator, compare,
// select, load or store on a lane's values; spec and address constants
// hoisted and not counted):
//
//   fast loop, a thread's k step   1 A load (4 words), 1 B load (TN
//                                  words), 4 bias subtracts         = 6
//   fast loop, a product           1 integer add, 1 f32 add         = 2
//   decode, an element             log_word 33 (a B or an A pattern),
//                                  a_word 8 (a bf16 in the exact
//                                  range: unpack, exponent 2,
//                                  range 2, low half 2, select)
//                                  + 4 (unpack or address, the zero
//                                  note 2, store)                   = 37 | 12
//
// A thread adds 128 * TN products a tile and decodes 8 A elements and
// BN / 8 B patterns, so a product costs, over bf16 A in range:
//
//                   BN = 16   BN = 32   BN = 64
//   fast loop         3.50      2.75      2.38   (2 + 6 / (4 TN))
//   A decode          0.75      0.38      0.19   (8 * 12 / (128 TN))
//   B decode          0.58      0.58      0.58   (37 / 64)
//   total             4.83      3.71      3.14   instructions
//
// chip_smoke.py reads these counts for K1's prefill floor, at 4 warp
// instructions started per SM and clock.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "posit.cuh"

// the hand counts above, which chip_smoke.py reads for K1's decode floor
constexpr int kLogWordAluOps = 19;
constexpr int kProductAluOpsPerRow = 2;
// ... and for its prefill floor: instructions of a fast-loop product, of a
// thread's k step, and of a decoded element (a pattern, or a bf16 in the
// exact range)
constexpr int kPrefillProductInstr = 2;
constexpr int kPrefillStepInstr = 6;
constexpr int kPrefillPatternInstr = 37;
constexpr int kPrefillExactBf16Instr = 12;

namespace plam_mm {

// What A holds: posit patterns (int32), or float activations
enum AKind { kPatternA = 0, kFloatA = 1 };
// How a kFloatA kernel reads A, chosen per call by the entry point
enum AMode {
  kAF32 = 0,         // f32, one 4-byte cp.async an element
  kABf16Pairs = 1,   // bf16 with even K and a 4-byte aligned base: two
                     // elements of a row a 4-byte cp.async
  kABf16Scalar = 2,  // other bf16: guarded 2-byte loads while decoding
};

// An expert axis: the grid's z index picks the expert, whose A, B and C
// start sa, sb and sc elements after the previous expert's
struct Group {
  long long sa, sb, sc;
};

// A at the block's expert: 4-byte elements (patterns, f32) or bf16
__device__ __forceinline__ const void* expert_a(const void* a, bool a4, const Group& g) {
  return (const unsigned char*)a + (size_t)blockIdx.z * (size_t)g.sa * (a4 ? 4 : 2);
}

__device__ __forceinline__ uint32_t bf16_bits(uint16_t h) { return (uint32_t)h << 16; }

__device__ __forceinline__ uint32_t load_bits(int32_t b) { return (uint32_t)b; }
__device__ __forceinline__ uint32_t load_bits(int16_t b) { return (uint32_t)(uint16_t)b; }

// -- the decode path (M <= 16) ---------------------------------------------

constexpr int kDecoders = 256;   // threads of a block that copy and decode
constexpr int kTileElems = 2048; // B patterns in a [BK, BN] tile: 8 a thread
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kSumBatch = 16;    // k steps whose words an owner loads before adding

// cp.async of 16 or 4 bytes; with `full` false nothing is read and the
// destination is zero-filled (a zero pattern)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int MT, int BN, typename TB, bool VEC>
struct DecodeTile {
  static constexpr int BK = kTileElems / BN;             // k-tile depth
  static constexpr int EPC = 16 / (int)sizeof(TB);       // patterns per 16-byte chunk
  static constexpr int CPR = BN / EPC;                   // chunks per tile row
  static constexpr int CPT = kTileElems / EPC / kDecoders;  // chunks per decoder
  static constexpr int APT = (MT * BK + kDecoders - 1) / kDecoders;  // A elements per decoder
  static constexpr int PPT = (MT * BK / 2 + kDecoders - 1) / kDecoders;  // bf16 A pairs per decoder
  static constexpr int RM = MT / 4;                      // rows per owner thread
  static constexpr int OWNERS = 4 * BN;                  // four per column: whole warps
  static constexpr int THREADS = OWNERS + kDecoders;
  // shared memory: decoded B [2][BK][BN], decoded A [2][BK][MT] (uint32),
  // raw A [kStages][BK][MT] (int32 patterns or f32; bf16 pairs fill half),
  // raw B [kStages][BK][BN] (VEC only)
  static constexpr size_t kWb = 2 * kTileElems * 4;
  static constexpr size_t kWa = 2 * BK * MT * 4;
  static constexpr size_t kRawA = kStages * BK * MT * 4;
  static constexpr size_t kRawB = VEC ? kStages * kTileElems * sizeof(TB) : 0;
  static constexpr size_t kSmem = kWb + kWa + kRawA + kRawB;
  static_assert(BN % EPC == 0 && CPT >= 1 && BK % kSumBatch == 0, "tile shape");
};

template <int MT, int BN, typename TB, bool VEC, class SP, int AK>
__global__ void __launch_bounds__(DecodeTile<MT, BN, TB, VEC>::THREADS)
plam_matmul_decode_kernel(const void* __restrict__ A_, int a_mode, const TB* __restrict__ B,
                          float* __restrict__ C, int M, int N, int K, Group grp, SP sp) {
  using D = DecodeTile<MT, BN, TB, VEC>;
  constexpr int BK = D::BK, EPC = D::EPC, CPR = D::CPR, RM = D::RM;
  // 4-byte A elements (patterns or f32) are staged one a cp.async; bf16
  // pairs k-major (pair p: row p % MT, k 2 (p / MT) and one more)
  const bool a_words = AK == kPatternA || a_mode == kAF32;
  A_ = expert_a(A_, a_words, grp);
  B += (size_t)blockIdx.z * (size_t)grp.sb;
  C += (size_t)blockIdx.z * (size_t)grp.sc;
  const uint32_t* const A = (const uint32_t*)A_;
  const uint16_t* const A16 = (const uint16_t*)A_;
  constexpr uint32_t kBias = 127u << 23;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* const wb = (uint32_t*)smem;
  uint32_t* const wa = (uint32_t*)(smem + D::kWb);
  int32_t* const raw_a = (int32_t*)(smem + D::kWb + D::kWa);
  TB* const raw_b = (TB*)(smem + D::kWb + D::kWa + D::kRawA);

  // the first OWNERS threads own outputs, the other kDecoders threads
  // copy and decode
  const int tid = threadIdx.x;
  const int dec = tid - D::OWNERS;
  const int n0 = blockIdx.x * BN;
  const int tiles = (K + BK - 1) / BK;

  // Start tile t's copies into ring slot t % kStages, one commit group
  // per call (empty past the last tile, so the group count stays uniform).
  auto load = [&](int t) {
    if (t < tiles) {
      const int k0 = t * BK;
      const int slot = t % kStages;
      if (a_words) {
#pragma unroll
        for (int j = 0; j < D::APT; ++j) {
          const int i = dec + j * kDecoders;
          if ((MT * BK) % kDecoders != 0 && i >= MT * BK) break;
          const int mm = i % MT, kk = i / MT;
          const bool in = mm < M && k0 + kk < K;
          cp_async_4(&raw_a[(slot * BK + kk) * MT + mm], in ? A + (size_t)mm * K + k0 + kk : A,
                     in);
        }
      } else if (AK == kFloatA && a_mode == kABf16Pairs) {
#pragma unroll
        for (int j = 0; j < D::PPT; ++j) {
          const int p = dec + j * kDecoders;
          if ((MT * BK / 2) % kDecoders != 0 && p >= MT * BK / 2) break;
          const int mm = p % MT, kk = 2 * (p / MT);
          const bool in = mm < M && k0 + kk < K;  // K is even: both elements or none
          cp_async_4(&raw_a[slot * BK * MT + p], in ? A16 + (size_t)mm * K + k0 + kk : A16, in);
        }
      }
      if constexpr (VEC) {
#pragma unroll
        for (int c = 0; c < D::CPT; ++c) {
          const int chunk = dec + c * kDecoders;
          const int kk = chunk / CPR, nn = (chunk % CPR) * EPC;
          const bool in = k0 + kk < K && n0 + nn < N;  // N % EPC == 0: all or none
          cp_async_16(&raw_b[(slot * BK + kk) * BN + nn],
                      in ? B + (size_t)(k0 + kk) * N + n0 + nn : B, in);
        }
      }
    }
    cp_async_commit();
  };

  // Decode tile t (the patterns this thread copied) into buffer t & 1.
  auto decode = [&](int t) {
    const int k0 = t * BK;
    const int slot = t % kStages;
    uint32_t* const wa_t = wa + (t & 1) * BK * MT;
    uint32_t* const wb_t = wb + (t & 1) * kTileElems;
    bool ok;
    if (AK == kFloatA && a_mode == kABf16Pairs) {
#pragma unroll
      for (int j = 0; j < D::PPT; ++j) {
        const int p = dec + j * kDecoders;
        if ((MT * BK / 2) % kDecoders != 0 && p >= MT * BK / 2) break;
        const int mm = p % MT, kk = 2 * (p / MT);
        const uint32_t two = (uint32_t)raw_a[slot * BK * MT + p];  // k in the low half
        wa_t[kk * MT + mm] = plam::a_word(two << 16, sp);
        wa_t[(kk + 1) * MT + mm] = plam::a_word(two & 0xFFFF0000u, sp);
      }
    } else {
#pragma unroll
      for (int j = 0; j < D::APT; ++j) {
        const int i = dec + j * kDecoders;
        if ((MT * BK) % kDecoders != 0 && i >= MT * BK) break;
        if constexpr (AK == kPatternA) {
          wa_t[i] = plam::log_word((uint32_t)raw_a[slot * BK * MT + i], sp, ok);
        } else if (a_mode == kAF32) {
          wa_t[i] = plam::a_word((uint32_t)raw_a[slot * BK * MT + i], sp);
        } else {  // kABf16Scalar: read here, guarded, nothing staged
          const int mm = i % MT, gk = k0 + i / MT;
          wa_t[i] = plam::a_word(mm < M && gk < K ? bf16_bits(A16[(size_t)mm * K + gk]) : 0u, sp);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < D::CPT; ++c) {
      const int chunk = dec + c * kDecoders;
      const int kk = chunk / CPR, nn = (chunk % CPR) * EPC;
      uint32_t bits[EPC];
      if constexpr (VEC) {
        const uint4 v = *reinterpret_cast<const uint4*>(&raw_b[(slot * BK + kk) * BN + nn]);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          if constexpr (sizeof(TB) == 2) {
            bits[e] = (w4[e / 2] >> (16 * (e % 2))) & 0xFFFFu;
          } else {
            bits[e] = w4[e];
          }
        }
      } else {
        const int gk = k0 + kk;
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const int gn = n0 + nn + e;
          bits[e] = (gk < K && gn < N) ? load_bits(B[(size_t)gk * N + gn]) : 0u;
        }
      }
      uint32_t w[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) w[e] = plam::log_word(bits[e], sp, ok);
#pragma unroll
      for (int q = 0; q < EPC / 4; ++q) {
        *reinterpret_cast<uint4*>(&wb_t[kk * BN + nn + 4 * q]) =
            make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      }
    }
  };

  // Owner threads add tile t's products in k order.
  const int col = tid % BN;
  const int row0 = (tid / BN) * RM;
  float acc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i] = 0.0f;
  auto sum = [&](int t) {
    const uint32_t* const wa_t = wa + (t & 1) * BK * MT + row0;
    const uint32_t* const wb_t = wb + (t & 1) * kTileElems + col;
    // the words of kSumBatch k steps are loaded first, so that one
    // shared-memory latency is paid per batch and not per step
    for (int k0 = 0; k0 < BK; k0 += kSumBatch) {
      uint32_t b[kSumBatch], a[kSumBatch][RM];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        const int kk = k0 + u;
        b[u] = wb_t[kk * BN];
        if constexpr (RM % 4 == 0) {
#pragma unroll
          for (int q = 0; q < RM / 4; ++q) {
            const uint4 v = *reinterpret_cast<const uint4*>(&wa_t[kk * MT + 4 * q]);
            a[u][4 * q] = v.x, a[u][4 * q + 1] = v.y, a[u][4 * q + 2] = v.z,
                     a[u][4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < RM; ++i) a[u][i] = wa_t[kk * MT + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          // A's word keeps its bias: a word of 0 marks zero or NaR, and every
          // valid word is at least 64 << 23 (|scale| <= 63).  A zero or NaR
          // product is +0.0, and adding it leaves the sum's bits as they
          // are (the sum is never -0.0 or NaN: every product is a finite
          // normal f32), so it is skipped.
          if (a[u][i] != 0u && b[u] != 0u) {
            acc[i] = acc[i] + __uint_as_float(a[u][i] + b[u] - kBias);
          }
        }
      }
    }
  };

  // While the owners add tile t, the decoders decode tile t + 1 and
  // copy tile t + kStages; one barrier per tile hands the words over.
  const bool owner = dec < 0;
  if (!owner) {
    for (int s = 0; s < kStages; ++s) load(s);
    cp_async_wait<kStages - 1>();  // tile 0 has landed
    decode(0);
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    if (owner) {
      sum(t);
    } else {
      load(t + kStages);  // into tile t's slot, decoded before the last barrier
      cp_async_wait<kStages - 1>();  // tile t + 1 has landed
      if (t + 1 < tiles) decode(t + 1);
    }
    __syncthreads();
  }

  const int gn = n0 + col;
  if (owner && gn < N) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (row0 + i < M) C[(size_t)(row0 + i) * N + gn] = acc[i];
    }
  }
}

template <int MT, int BN, typename TB, bool VEC, class SP, int AK>
cudaError_t launch_decode(const void* a, int a_mode, const TB* b, float* c, int m, int n, int k,
                          int e, Group grp, SP sp, cudaStream_t stream) {
  constexpr size_t smem = DecodeTile<MT, BN, TB, VEC>::kSmem;
  auto kernel = plam_matmul_decode_kernel<MT, BN, TB, VEC, SP, AK>;
  // set once per instantiation, at its first launch
  static const cudaError_t attr =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + BN - 1) / BN, 1, e);
  kernel<<<grid, DecodeTile<MT, BN, TB, VEC>::THREADS, smem, stream>>>(a, a_mode, b, c, m, n,
                                                                      k, grp, sp);
  return cudaSuccess;
}

template <int MT, int BN, typename TB, int AK, class SP>
cudaError_t launch_strip(bool vec, const void* a, int a_mode, const TB* b, float* c, int m,
                         int n, int k, int e, Group grp, SP sp, cudaStream_t stream) {
  return vec ? launch_decode<MT, BN, TB, true, SP, AK>(a, a_mode, b, c, m, n, k, e, grp, sp,
                                                       stream)
             : launch_decode<MT, BN, TB, false, SP, AK>(a, a_mode, b, c, m, n, k, e, grp, sp,
                                                        stream);
}

// The strip width (8 to 64 columns, at least min_bn) whose grid finishes
// first: a block's work grows as BN + MT (its B columns and the A rows it
// decodes again), and the e * ceil(n / BN) blocks run in waves over the
// card's SMs, so the cost is waves * (BN + MT).  Ties go to the wider strip.
inline int strip_width(int n, int e, int mt, int min_bn, int sms) {
  int best_bn = min_bn;
  long best = -1;
  for (int bn = 64; bn >= min_bn; bn /= 2) {
    const long waves = ((long)e * ((n + bn - 1) / bn) + sms - 1) / sms;
    const long cost = waves * (bn + mt);
    if (best < 0 || cost < best) best = cost, best_bn = bn;
  }
  return best_bn;
}

// The card's SM count, read once
inline cudaError_t card_sms(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, count = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached = count;
  }
  *sms = cached;
  return cudaSuccess;
}

template <int MT, typename TB, int AK, class SP>
cudaError_t dispatch_decode(const void* a, int a_mode, const TB* b, float* c, int m, int n,
                            int k, int e, Group grp, SP sp, cudaStream_t stream) {
  constexpr int kEpc = 16 / (int)sizeof(TB);
  // every expert's B rows start on 16 bytes
  const bool vec = n % kEpc == 0 && grp.sb % kEpc == 0 &&
                   (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
  int sms = 0;
  const cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return err;
  switch (strip_width(n, e, MT, MT == 4 ? 8 : 16, sms)) {
    case 64: return launch_strip<MT, 64, TB, AK>(vec, a, a_mode, b, c, m, n, k, e, grp, sp, stream);
    case 32: return launch_strip<MT, 32, TB, AK>(vec, a, a_mode, b, c, m, n, k, e, grp, sp, stream);
    case 16: return launch_strip<MT, 16, TB, AK>(vec, a, a_mode, b, c, m, n, k, e, grp, sp, stream);
    default:
      if constexpr (MT == 4) {
        return launch_strip<MT, 8, TB, AK>(vec, a, a_mode, b, c, m, n, k, e, grp, sp, stream);
      }
      return cudaErrorInvalidValue;
  }
}

// -- the prefill path (M > 16) ---------------------------------------------

constexpr int kPrefillThreads = 256;  // 16 row groups x 16 column groups
constexpr int kPrefillBM = 64;        // rows of a block
constexpr int kPrefillBK = 32;        // k-tile depth
constexpr int kPrefillTM = 4;         // rows a thread owns
constexpr int kPrefillStages = 3;     // cp.async ring depth
constexpr int kPrefillBatch = 8;      // k steps whose words a thread loads before adding

// cp.async of BYTES (4, 8 or 16); with `full` false the destination is
// zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool full) {
  if constexpr (BYTES == 16) {
    cp_async_16(dst, src, full);
  } else if constexpr (BYTES == 8) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 8 : 0)
                 : "memory");
  } else {
    static_assert(BYTES == 4, "cp.async copies 4, 8 or 16 bytes");
    cp_async_4(dst, src, full);
  }
}

template <int BN, typename TB>
struct PrefillTile {
  static constexpr int BM = kPrefillBM, BK = kPrefillBK, TM = kPrefillTM;
  static constexpr int TN = BN / 16;                            // columns a thread owns
  static constexpr int BPT = BK * BN / kPrefillThreads;         // B patterns a thread copies
  static constexpr int BCOPY = BPT * (int)sizeof(TB);           // ... in one copy of 4-16 bytes
  static constexpr int CPR = BN / BPT;                          // copies per B tile row
  static constexpr int APT = BM * BK / kPrefillThreads;         // A elements a thread decodes
  // shared memory: A words [2][BK][BM] and B words [2][BK][BN] (uint32);
  // raw A [kStages][512 copies of 16 bytes] (bf16 fills half); raw B
  // [kStages][256 copies of BCOPY bytes], each in the order of the copies
  static constexpr size_t kWa = 2 * BK * BM * 4;
  static constexpr size_t kWb = 2 * BK * BN * 4;
  static constexpr size_t kRawAStage = BM * BK * 4;
  static constexpr size_t kRawA = kPrefillStages * kRawAStage;
  static constexpr size_t kRawBStage = (size_t)kPrefillThreads * BCOPY;
  static constexpr size_t kSmem = kWa + kWb + kRawA + kPrefillStages * kRawBStage;
  static_assert(BN % 16 == 0 && (BCOPY == 4 || BCOPY == 8 || BCOPY == 16), "tile shape");
  static_assert(APT == 8 && BK % kPrefillBatch == 0, "tile shape");
};

// C[m0.., n0..] for one 64-row block and one BN-column strip.  a_vec: A
// rows are staged with 16-byte cp.async (K % 4 == 0 for 4-byte elements,
// K % 8 == 0 for bf16, an aligned base); b_vec: B rows likewise (N % 8 ==
// 0 for int16, N % 4 == 0 for int32).  Otherwise the decode reads them
// with guarded scalar loads.
template <int BN, typename TB, class SP, int AK>
__global__ void __launch_bounds__(kPrefillThreads)
plam_matmul_prefill_kernel(const void* __restrict__ A_, int a_mode, bool a_vec,
                           const TB* __restrict__ B, bool b_vec, float* __restrict__ C, int M,
                           int N, int K, Group grp, SP sp) {
  using T = PrefillTile<BN, TB>;
  constexpr int BM = T::BM, BK = T::BK, TM = T::TM, TN = T::TN, BPT = T::BPT, CPR = T::CPR;
  constexpr uint32_t kBias = 127u << 23;
  const bool a4 = AK == kPatternA || a_mode == kAF32;  // 4-byte A elements, else bf16
  A_ = expert_a(A_, a4, grp);
  B += (size_t)blockIdx.z * (size_t)grp.sb;
  C += (size_t)blockIdx.z * (size_t)grp.sc;
  const uint32_t* const A = (const uint32_t*)A_;
  const uint16_t* const A16 = (const uint16_t*)A_;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* const wa = (uint32_t*)smem;
  uint32_t* const wb = (uint32_t*)(smem + T::kWa);
  unsigned char* const raw_a = smem + T::kWa + T::kWb;
  unsigned char* const raw_b = raw_a + T::kRawA;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tiles = (K + BK - 1) / BK;
  // A: every thread decodes 8 elements of row r; B: BPT patterns of row
  // bk, columns bn.., the ones it copied
  const int r = tid % BM, q = tid / BM;  // q in [0, 4)
  const bool row_in = m0 + r < M;
  const int bk = tid / CPR, bn = (tid % CPR) * BPT;

  // Start tile t's copies into ring slot t % kStages: one commit group per
  // call, empty past the last tile, so that the group count stays uniform.
  auto start_copies = [&](int t) {
    if (t < tiles) {
      const int k0 = t * BK;
      const int slot = t % kPrefillStages;
      unsigned char* const ra = raw_a + slot * T::kRawAStage;
      if (a_vec) {
        if (a4) {  // two copies of 4 elements: k 4q.. and 16 + 4q..
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int gk = k0 + 4 * (q + 4 * j);
            const bool in = row_in && gk < K;  // K % 4 == 0: all four or none
            cp_async_16(ra + (tid + j * kPrefillThreads) * 16,
                        in ? A + (size_t)(m0 + r) * K + gk : A, in);
          }
        } else {  // one copy of 8 bf16: k 8q..
          const int gk = k0 + 8 * q;
          const bool in = row_in && gk < K;  // K % 8 == 0
          cp_async_16(ra + tid * 16, in ? A16 + (size_t)(m0 + r) * K + gk : A16, in);
        }
      }
      if (b_vec) {
        const int gk = k0 + bk, gn = n0 + bn;
        const bool in = gk < K && gn < N;  // N % BPT == 0: all or none
        cp_async_n<T::BCOPY>(raw_b + slot * T::kRawBStage + tid * T::BCOPY,
                             in ? B + (size_t)gk * N + gn : B, in);
      }
    }
    cp_async_commit();
  };

  // Decode tile t (what this thread copied) into word buffer t & 1, word 0
  // meaning zero or NaR.  Returns whether it wrote a 0 word where a row, a
  // column and k are in range: a slow tile.
  auto decode = [&](int t) {
    const int k0 = t * BK;
    const int slot = t % kPrefillStages;
    uint32_t* const wa_t = wa + (t & 1) * BK * BM;
    uint32_t* const wb_t = wb + (t & 1) * BK * BN;
    bool zero = false;
    // the element's k in the tile: k-major words, conflict-free (a warp
    // writes 32 consecutive rows)
    uint32_t x[8];
    int kk[8];
    if (a_vec && a4) {
      const uint4* const ra = (const uint4*)(raw_a + slot * T::kRawAStage);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint4 v = ra[tid + j * kPrefillThreads];
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * j + e] = w4[e], kk[4 * j + e] = 4 * (q + 4 * j) + e;
      }
    } else if (a_vec) {
      const uint4 v = ((const uint4*)(raw_a + slot * T::kRawAStage))[tid];
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = e % 2 ? w4[e / 2] & 0xFFFF0000u : w4[e / 2] << 16;
        kk[e] = 8 * q + e;
      }
    } else {  // guarded scalar loads, nothing staged: k q, q + 4, ...
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kk[e] = q + 4 * e;
        const int gk = k0 + kk[e];
        const size_t at = (size_t)(m0 + r) * K + gk;
        x[e] = !(row_in && gk < K) ? 0u : a4 ? A[at] : bf16_bits(A16[at]);
      }
    }
    // float A: the exact case of all 8 first, with no branch, then the full
    // encode where one needs it (rare on the serve path), so that the 8
    // range checks run side by side
    uint32_t aw[8];
    bool full[8], any_full = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (AK == kPatternA) {
        bool ok;
        aw[e] = plam::log_word(x[e], sp, ok);
      } else {
        aw[e] = plam::a_word_exact(x[e], sp, full[e]);
        any_full |= full[e];
      }
    }
    if (AK == kFloatA && any_full) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (full[e]) aw[e] = plam::a_word_full(x[e], sp);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wa_t[kk[e] * BM + r] = aw[e];
      zero |= aw[e] == 0u && row_in && k0 + kk[e] < K;
    }

    const int gk = k0 + bk;
    uint32_t bits[BPT];
    if (b_vec) {
      uint32_t raw[T::BCOPY / 4];
      const unsigned char* const rb = raw_b + slot * T::kRawBStage + tid * T::BCOPY;
      if constexpr (T::BCOPY == 16) {
        const uint4 v = *(const uint4*)rb;
        raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
      } else if constexpr (T::BCOPY == 8) {
        const uint2 v = *(const uint2*)rb;
        raw[0] = v.x, raw[1] = v.y;
      } else {
        raw[0] = *(const uint32_t*)rb;
      }
#pragma unroll
      for (int e = 0; e < BPT; ++e) {
        if constexpr (sizeof(TB) == 2) {
          bits[e] = (raw[e / 2] >> (16 * (e % 2))) & 0xFFFFu;
        } else {
          bits[e] = raw[e];
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < BPT; ++e) {
        const int gn = n0 + bn + e;
        bits[e] = gk < K && gn < N ? load_bits(B[(size_t)gk * N + gn]) : 0u;
      }
    }
    uint32_t w[BPT];
#pragma unroll
    for (int e = 0; e < BPT; ++e) {
      bool ok;
      w[e] = plam::log_word(bits[e], sp, ok);
      zero |= w[e] == 0u && gk < K && n0 + bn + e < N;
    }
    uint32_t* const dst = wb_t + bk * BN + bn;
    if constexpr (BPT % 4 == 0) {
#pragma unroll
      for (int v = 0; v < BPT / 4; ++v) {
        *(uint4*)(dst + 4 * v) = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
      }
    } else {
      static_assert(BPT == 2, "B words a thread");
      *(uint2*)dst = make_uint2(w[0], w[1]);
    }
    return zero;
  };

  // Add tile t's products in k order: rows ty*TM.., columns tx*TN...  A
  // word keeps its bias, and every valid word is at least 64 << 23, so a
  // word of 0 marks zero or NaR.  A fast tile has no such word where an
  // output is kept: each product is one integer add and one f32 add.  A
  // slow tile skips the products of a 0 word, which are +0.0 and would
  // leave the sum's bits as they are (the sum is never -0.0 or NaN).
  // Rows and columns out of range may sum anything: they are not stored.
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  auto sum = [&](int t, bool slow) {
    const uint32_t* const wa_t = wa + (t & 1) * BK * BM + ty * TM;
    const uint32_t* const wb_t = wb + (t & 1) * BK * BN + tx * TN;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += kPrefillBatch) {
      uint32_t a[kPrefillBatch][TM], b[kPrefillBatch][TN];
#pragma unroll
      for (int u = 0; u < kPrefillBatch; ++u) {
        const uint4 v = *(const uint4*)(wa_t + (k8 + u) * BM);
        a[u][0] = v.x, a[u][1] = v.y, a[u][2] = v.z, a[u][3] = v.w;
        const uint32_t* const bp = wb_t + (k8 + u) * BN;
        if constexpr (TN == 4) {
          const uint4 w4 = *(const uint4*)bp;
          b[u][0] = w4.x, b[u][1] = w4.y, b[u][2] = w4.z, b[u][3] = w4.w;
        } else if constexpr (TN == 2) {
          const uint2 w2 = *(const uint2*)bp;
          b[u][0] = w2.x, b[u][1] = w2.y;
        } else {
          b[u][0] = *bp;
        }
      }
      if (!slow) {
#pragma unroll
        for (int u = 0; u < kPrefillBatch; ++u)
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const uint32_t ap = a[u][i] - kBias;
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = acc[i][j] + __uint_as_float(ap + b[u][j]);
          }
      } else {
#pragma unroll
        for (int u = 0; u < kPrefillBatch; ++u)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              if (a[u][i] != 0u && b[u][j] != 0u) {
                acc[i][j] = acc[i][j] + __uint_as_float(a[u][i] + b[u][j] - kBias);
              }
      }
    }
  };

  // Iteration t: copy tile t + 2, decode tile t + 1, add tile t, then one
  // barrier, which also ORs the decoders' notes into tile t + 1's flag.  A
  // ragged K tail is always slow: its padding must add +0.0.
  const auto tail = [&](int t) { return (t + 1) * BK > K; };
  start_copies(0);
  start_copies(1);
  cp_async_wait<1>();  // tile 0 has landed
  bool slow = __syncthreads_or(decode(0) || tail(0));
  for (int t = 0; t < tiles; ++t) {
    start_copies(t + 2);  // into the slot of tile t - 1, decoded two barriers ago
    cp_async_wait<1>();  // tile t + 1 has landed
    const bool next = t + 1 < tiles && (decode(t + 1) || tail(t + 1));
    sum(t, slow);
    slow = __syncthreads_or(next);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int BN, typename TB, int AK, class SP>
cudaError_t launch_prefill(const void* a, int a_mode, bool a_vec, const TB* b, bool b_vec,
                           float* c, int m, int n, int k, int e, Group grp, SP sp,
                           cudaStream_t stream) {
  constexpr size_t smem = PrefillTile<BN, TB>::kSmem;
  auto kernel = plam_matmul_prefill_kernel<BN, TB, SP, AK>;
  // set once per instantiation, at its first launch
  static const cudaError_t attr =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + BN - 1) / BN, (m + kPrefillBM - 1) / kPrefillBM, e);
  kernel<<<grid, kPrefillThreads, smem, stream>>>(a, a_mode, a_vec, b, b_vec, c, m, n, k, grp,
                                                  sp);
  return cudaSuccess;
}

// The prefill strip width whose grid finishes first: a block's work grows
// as BN, and the e * ceil(N / BN) * ceil(M / 64) blocks run in waves over
// the card's SMs, so the cost is waves * BN.  Ties go to the wider strip.
// Only the compiled Posit<16,1> spec over int16 B has the three widths;
// every other (B type, spec) runs at 32 columns.
inline int prefill_width(bool fixed, int m, int n, int e, int sms) {
  if (!fixed) return 32;
  int best_bn = 64;
  long best = -1;
  for (int bn = 64; bn >= 16; bn /= 2) {
    const long blocks =
        (long)e * ((n + bn - 1) / bn) * ((m + kPrefillBM - 1) / kPrefillBM);
    const long cost = (blocks + sms - 1) / sms * bn;
    if (best < 0 || cost < best) best = cost, best_bn = bn;
  }
  return best_bn;
}

template <typename TB, int AK, class SP>
cudaError_t dispatch_prefill(const void* a, int a_mode, const TB* b, float* c, int m, int n,
                             int k, int e, Group grp, SP sp, cudaStream_t stream) {
  const bool a4 = AK == kPatternA || a_mode == kAF32;
  // every expert's A and B rows start on 16 bytes
  const int a_epc = a4 ? 4 : 8, b_epc = 16 / (int)sizeof(TB);
  const bool a_vec = k % a_epc == 0 && grp.sa % a_epc == 0 &&
                     (reinterpret_cast<uintptr_t>(a) & 15u) == 0;
  const bool b_vec = n % b_epc == 0 && grp.sb % b_epc == 0 &&
                     (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
  if constexpr (std::is_same<SP, plam::Spec>::value) {
    return launch_prefill<32, TB, AK>(a, a_mode, a_vec, b, b_vec, c, m, n, k, e, grp, sp, stream);
  } else {
    int sms = 0;
    const cudaError_t err = card_sms(&sms);
    if (err != cudaSuccess) return err;
    switch (prefill_width(true, m, n, e, sms)) {
      case 64:
        return launch_prefill<64, TB, AK>(a, a_mode, a_vec, b, b_vec, c, m, n, k, e, grp, sp,
                                          stream);
      case 32:
        return launch_prefill<32, TB, AK>(a, a_mode, a_vec, b, b_vec, c, m, n, k, e, grp, sp,
                                          stream);
      default:
        return launch_prefill<16, TB, AK>(a, a_mode, a_vec, b, b_vec, c, m, n, k, e, grp, sp,
                                          stream);
    }
  }
}

template <typename TB, int AK, class SP>
cudaError_t dispatch_rows(const void* a, int a_mode, const TB* b, float* c, int m, int n, int k,
                          int e, Group grp, SP sp, cudaStream_t stream) {
  if (m > 16) return dispatch_prefill<TB, AK>(a, a_mode, b, c, m, n, k, e, grp, sp, stream);
  return m <= 4 ? dispatch_decode<4, TB, AK>(a, a_mode, b, c, m, n, k, e, grp, sp, stream)
                : dispatch_decode<16, TB, AK>(a, a_mode, b, c, m, n, k, e, grp, sp, stream);
}

// Whether a call runs with the spec compiled in: int16 B at Posit<16,1>,
// the prequantized weights of the serving path
inline bool fixed_spec(bool b_is_int16, const plam::Spec& sp) {
  return b_is_int16 && sp.n == 16 && sp.es == 1;
}

template <typename TB, int AK>
cudaError_t dispatch(const void* a, int a_mode, const TB* b, float* c, int m, int n, int k,
                     int e, Group grp, plam::Spec sp, cudaStream_t stream) {
  if constexpr (sizeof(TB) == 2) {
    if (fixed_spec(true, sp)) {
      return dispatch_rows<TB, AK>(a, a_mode, b, c, m, n, k, e, grp, plam::FixedSpec<16, 1>{},
                                   stream);
    }
  }
  return dispatch_rows<TB, AK>(a, a_mode, b, c, m, n, k, e, grp, sp, stream);
}

// One launch of either entry point over e experts: expert z's b, int32
// (b_is_int16 == 0) or int16 [k, n], starts sb elements after expert z-1's,
// its a [m, k] sa elements and its f32 c [m, n] sc elements after, each
// contiguous on the device (e = 1: one plain [m, k] x [k, n] call).
// Returns the cudaError_t of the launch.
template <int AK>
inline int launch_matmul(const void* a, int a_mode, const void* b, int b_is_int16, void* c, int m,
                         int n, int k, int e, long long sa, long long sb, long long sc,
                         int posit_n, int posit_es, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || e <= 0 || e > 65535) return (int)cudaErrorInvalidValue;
  if (sa < 0 || sb < 0 || sc < 0) return (int)cudaErrorInvalidValue;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  const cudaStream_t s = (cudaStream_t)stream;
  const Group grp{sa, sb, sc};
  const cudaError_t err =
      b_is_int16
          ? dispatch<int16_t, AK>(a, a_mode, (const int16_t*)b, (float*)c, m, n, k, e, grp, sp, s)
          : dispatch<int32_t, AK>(a, a_mode, (const int32_t*)b, (float*)c, m, n, k, e, grp, sp,
                                  s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace plam_mm
