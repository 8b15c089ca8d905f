// Device helpers shared by the forward reweight kernels of this directory
// (reweight_shifted.cu, reweight_perchain.cu).
//
// A spline response is evaluated from its segment's 4 coefficient rows
// seg*4 + (0..3) of coeffs[p, :, e] — (y, b, c, d) — and one f32 Horner
// step, resp = y + t(b + t(c + t·d)); bf16 tables are upcast on load. seg is
// trusted to lie in [0, n_knots − 2], as find_segments clamps it.

#pragma once

#include <cuda_bf16.h>

#include <cstddef>

namespace m3 {

__device__ __forceinline__ float load_coef(const float* p) { return *p; }
__device__ __forceinline__ float load_coef(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// w · Π_p resp_p for event e of one chain; seg/t are that chain's [P] rows.
template <typename CoefT>
__device__ __forceinline__ float spline_weight(
    const CoefT* __restrict__ coeffs, const int* seg, const float* t, int P,
    int K4, size_t es, int e, float w) {
  for (int p = 0; p < P; ++p) {
    const float tp = t[p];
    const CoefT* co = coeffs +
        (static_cast<size_t>(p) * K4 + static_cast<size_t>(seg[p]) * 4) * es + e;
    const float y = load_coef(co);
    const float b = load_coef(co + es);
    const float c = load_coef(co + 2 * es);
    const float d = load_coef(co + 3 * es);
    w *= y + tp * (b + tp * (c + tp * d));
  }
  return w;
}

}  // namespace m3
