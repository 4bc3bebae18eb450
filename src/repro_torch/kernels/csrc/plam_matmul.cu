// K1's entry point over posit patterns: C = A (x)_PLAM B with A int32
// patterns.  The kernels are plam_matmul.cuh's (kPatternA); the wrapper
// is kernels/plam_matmul.py::plam_matmul (ops.plam_matmul_bits), which
// the conformance path and the tests call.
#include "plam_matmul.cuh"

// a: int32 [m, k]; b: int32 (b_is_int16 == 0) or int16 [k, n]; c: f32 [m, n],
// all contiguous on the device.  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int plam_matmul_launch(const void* a, const void* b, int b_is_int16, void* c,
                                  int m, int n, int k, int posit_n, int posit_es,
                                  void* stream) {
  return plam_mm::launch_matmul<plam_mm::kPatternA>(a, 0, b, b_is_int16, c, m, n, k, posit_n,
                                                    posit_es, stream);
}
