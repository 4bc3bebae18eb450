// K1's entry point over posit patterns: C = A (x)_PLAM B with A int32
// patterns.  The kernels are plam_matmul.cuh's (kPatternA); the wrapper
// is kernels/plam_matmul.py::plam_matmul (ops.plam_matmul_bits), which
// the conformance path and the tests call.
#include "plam_matmul.cuh"

// a: int32 [m, k]; b: int32 (b_is_int16 == 0) or int16 [k, n]; c: f32 [m, n],
// all contiguous on the device, for each of e experts, expert z's a, b and
// c starting sa, sb and sc elements after expert z-1's (e = 1: one call).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int plam_matmul_launch(const void* a, const void* b, int b_is_int16, void* c,
                                  int m, int n, int k, int e, long long sa, long long sb,
                                  long long sc, int posit_n, int posit_es, void* stream) {
  return plam_mm::launch_matmul<plam_mm::kPatternA>(a, 0, b, b_is_int16, c, m, n, k, e, sa, sb,
                                                    sc, posit_n, posit_es, stream);
}

// The strip width (columns of a block) that a call with m > 16 runs at, as
// launch_matmul would choose it; 0 if the card's SM count cannot be read.
// chip_smoke.py logs it beside K1's prefill times.
extern "C" int plam_matmul_prefill_width(int m, int n, int b_is_int16, int posit_n,
                                         int posit_es) {
  int sms = 0;
  if (plam_mm::card_sms(&sms) != cudaSuccess) return 0;
  const plam::Spec sp = plam::make_spec(posit_n, posit_es);
  return plam_mm::prefill_width(plam_mm::fixed_spec(b_is_int16 != 0, sp), m, n, 1, sms);
}
