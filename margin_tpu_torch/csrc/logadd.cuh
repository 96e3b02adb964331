// Log-space addition shared by the kernels of this directory.
//
// lut_log_add is the reference's piecewise-cubic logAdd
// (pairwiseAligner.c:279-299) with the arithmetic of the JAX kernels
// (margin_tpu/ops/logmath.py:35-49 and :68-76 for the dense forward,
// margin_tpu/ops/pallas_banded.py:86-106 for the banded kernels; the two
// give the same values for the finite, LOG_ZERO-clamped DP inputs).
// Compiled with --fmad=false so a*b+c stays two roundings, as in the JAX
// kernels and native/, and the results agree bit for bit.
#pragma once

#define LOG_ZERO_F (-1.0e30f)

namespace margin {

// float64 coefficients (pairwiseAligner.c:282-293) rounded once to float32,
// as numpy's astype does; rows d<=1.0, <=2.5, <=4.5, <=7.5
#define MARGIN_C(v) static_cast<float>(v)

// Written without branches: the coefficients are selected and the cubic is
// computed whatever d, then d >= 7.5 selects hi. The chosen value is the
// one the branching form returns, bit for bit, and a kernel's independent
// logAdds (three states, several cells) can then be interleaved.
__device__ __forceinline__ float lut_log_add(float x, float y) {
  const float hi = fmaxf(x, y);
  const float lo = fminf(x, y);
  const float d = hi - lo;
  const bool r3 = d > 4.5f, r2 = d > 2.5f, r1 = d > 1.0f;
  const float c0 = r3   ? MARGIN_C(-0.000458661602210)
                   : r2 ? MARGIN_C(-0.004605031767994)
                   : r1 ? MARGIN_C(-0.014532321752540)
                        : MARGIN_C(-0.009350833524763);
  const float c1 = r3   ? MARGIN_C(0.009695946122598)
                   : r2 ? MARGIN_C(0.063427417320019)
                   : r1 ? MARGIN_C(0.139942324101744)
                        : MARGIN_C(0.130659527668286);
  const float c2 = r3   ? MARGIN_C(0.930734667215156)
                   : r2 ? MARGIN_C(0.695956496475118)
                   : r1 ? MARGIN_C(0.495635523139337)
                        : MARGIN_C(0.498799810682272);
  const float c3 = r3   ? MARGIN_C(0.168037164329057)
                   : r2 ? MARGIN_C(0.514272634594009)
                   : r1 ? MARGIN_C(0.692140569840976)
                        : MARGIN_C(0.693203116424741);
  float v = c0 * d + c1;
  v = v * d + c2;
  v = v * d + c3;
  v = v + lo;
  return d >= 7.5f ? hi : v;
}

// jnp.logaddexp / torch.logaddexp for finite inputs
__device__ __forceinline__ float exact_log_add(float x, float y) {
  const float m = fmaxf(x, y);
  return m + log1pf(expf(-fabsf(x - y)));
}

template <bool LUT>
__device__ __forceinline__ float log_add(float x, float y) {
  if (LUT) return lut_log_add(x, y);
  return exact_log_add(x, y);
}

template <bool LUT>
__device__ __forceinline__ float log_add3(float a, float b, float c) {
  return log_add<LUT>(log_add<LUT>(a, b), c);
}

// transition vector layout (margin_tpu/ops/pairhmm.py:45)
enum { T_MM = 0, T_M_FROM_GX, T_M_FROM_GY, T_OPEN_X, T_OPEN_Y, T_EXT_X,
       T_EXT_Y, T_SW_X, T_SW_Y };

constexpr int REP_N = 51;  // MAXIMUM_REPEAT_LENGTH (margin.h:133)

}  // namespace margin
