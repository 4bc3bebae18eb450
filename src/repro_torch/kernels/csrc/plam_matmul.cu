// PLAM matmul on Hopper: C[M,N] = sum_k PLAM(A[m,k], B[k,n]), f32 sums.
//
// Replaces the Pallas TPU kernel repro/kernels/plam_matmul.py::plam_matmul
// (_plam_matmul_kernel, _log_words).  Each product is one 32-bit integer
// add of two pre-decoded log words (posit.cuh::log_word) and a bitcast;
// zero and NaR lanes contribute +0.0.
//
// Bit identity with the sequential reference (kernels/ref.py::
// plam_matmul_seqref) rules the design: every output is owned by one
// thread that walks k strictly ascending in one f32 accumulator, starting
// at +0.0.  No split-K, no tree reduction, no atomics.  Ragged M, N and K
// read as zero patterns, which add exactly +0.0.
//
// What bounds it on an H100: integer work, not bytes.  Every product is
// an add, a select and an f32 add on the CUDA cores (no tensor cores can
// do a PLAM product), and every operand tile is decoded once per block
// (~30 integer ops per posit).  At decode (M = 4) each weight is decoded
// once and used four times, so the per-call decode of B is the likely
// limiter; the byte bound (int16 weights read once) is below it.  The
// design does three things about it: A and B tiles are decoded once
// into shared memory by all threads of a block (the bias pre-subtracted
// on A) and reused by every output of the block; B is read as int16
// patterns directly, so the prequantized weight is never widened in
// device memory; and the tile shape follows M, so that a small M keeps
// one output per thread and as many blocks in flight as N allows.
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

__device__ __forceinline__ uint32_t load_bits(int32_t b) { return (uint32_t)b; }
__device__ __forceinline__ uint32_t load_bits(int16_t b) { return (uint32_t)(uint16_t)b; }

template <int BM, int BN, int BK, int TM, int TN, typename TB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
plam_matmul_kernel(const int32_t* __restrict__ A, const TB* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, plam::Spec sp) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;  // threads along N
  constexpr uint32_t kBias = 127u << 23;
  // A is stored k-major with one pad column: the decode loop writes it
  // with consecutive threads on consecutive k, conflict-free
  __shared__ uint32_t a_word[BK][BM + 1];
  __shared__ uint32_t b_word[BK][BN];
  __shared__ bool a_ok[BK][BM + 1];
  __shared__ bool b_ok[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // decode the A tile once; consecutive threads walk k (A is row-major)
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int mm = idx / BK, kk = idx % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      const uint32_t bits = (gm < M && gk < K) ? (uint32_t)A[(size_t)gm * K + gk] : 0u;
      bool ok;
      const uint32_t w = plam::log_word(bits, sp, ok);
      a_word[kk][mm] = w - kBias;  // bias pre-subtracted once per A element
      a_ok[kk][mm] = ok;
    }
    // decode the B tile once; consecutive threads walk n (B is row-major)
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, nn = idx % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      const uint32_t bits = (gk < K && gn < N) ? load_bits(B[(size_t)gk * N + gn]) : 0u;
      bool ok;
      b_word[kk][nn] = plam::log_word(bits, sp, ok);
      b_ok[kk][nn] = ok;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t aw[TM], bw[TN];
      bool av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        aw[i] = a_word[kk][ty * TM + i];
        av[i] = a_ok[kk][ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bw[j] = b_word[kk][tx + j * TX];
        bv[j] = b_ok[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          // one integer add is the whole multiplier; always add, so that
          // the accumulator sees the same +0.0 terms as the reference
          const float v = (av[i] && bv[j]) ? __uint_as_float(aw[i] + bw[j]) : 0.0f;
          acc[i][j] = acc[i][j] + v;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, typename TB>
void launch(const int32_t* a, const TB* b, float* c, int m, int n, int k, plam::Spec sp,
            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  plam_matmul_kernel<BM, BN, BK, TM, TN, TB>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a, b, c, m, n, k, sp);
}

template <typename TB>
void dispatch(const int32_t* a, const TB* b, float* c, int m, int n, int k, plam::Spec sp,
              cudaStream_t stream) {
  if (m <= 4) {
    launch<4, 32, 32, 1, 1, TB>(a, b, c, m, n, k, sp, stream);  // decode batches
  } else if (m <= 16) {
    launch<16, 32, 32, 4, 1, TB>(a, b, c, m, n, k, sp, stream);
  } else {
    launch<64, 32, 32, 4, 2, TB>(a, b, c, m, n, k, sp, stream);  // prefill
  }
}

}  // namespace

// a: int32 [m, k]; b: int32 (b_is_int16 == 0) or int16 [k, n]; c: f32 [m, n],
// all contiguous on the device.  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int plam_matmul_launch(const void* a, const void* b, int b_is_int16, void* c,
                                  int m, int n, int k, int posit_n, int posit_es,
                                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  const cudaStream_t s = (cudaStream_t)stream;
  if (b_is_int16) {
    dispatch<int16_t>((const int32_t*)a, (const int16_t*)b, (float*)c, m, n, k, sp, s);
  } else {
    dispatch<int32_t>((const int32_t*)a, (const int32_t*)b, (float*)c, m, n, k, sp, s);
  }
  return (int)cudaGetLastError();
}
