// K1's entry point over float activations: C = encode(x) (x)_PLAM B in
// one launch, the activations encoded inside the kernel's A loader
// (plam_matmul.cuh, kFloatA, posit.cuh::a_word).  Bit-identical to
// kernels/ref.py::plam_matmul_seqref(encode(x), B).  The wrapper is
// kernels/plam_matmul.py::plam_matmul_float, which every plam_sim
// projection reaches through kernels/ops.py::plam_dense (over a stack of
// experts, [E, C, K] x [E, K, N], in one launch).
#include <cstdint>

#include "plam_matmul.cuh"

namespace {
enum Dtype { kF32 = 0, kBF16 = 1 };
}  // namespace

// x: f32 (x_dtype 0) or bf16 (x_dtype 1) [m, k]; b: int32 (b_is_int16 == 0)
// or int16 [k, n]; c: f32 [m, n], all contiguous on the device, for each
// of e experts, expert z's x, b and c starting sx, sb and sc elements
// after expert z-1's (e = 1: one call).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int plam_dense_launch(const void* x, int x_dtype, const void* b, int b_is_int16,
                                 void* c, int m, int n, int k, int e, long long sx,
                                 long long sb, long long sc, int posit_n, int posit_es,
                                 void* stream) {
  int a_mode;
  if (x_dtype == kF32) {
    a_mode = plam_mm::kAF32;
  } else if (x_dtype == kBF16) {
    // two bf16 a cp.async where every row of every expert starts on 4 bytes
    const bool pairs =
        k % 2 == 0 && sx % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 3u) == 0;
    a_mode = pairs ? plam_mm::kABf16Pairs : plam_mm::kABf16Scalar;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return plam_mm::launch_matmul<plam_mm::kFloatA>(x, a_mode, b, b_is_int16, c, m, n, k, e, sx,
                                                  sb, sc, posit_n, posit_es, stream);
}
