// jax.nn.gelu's default (approximate=True) tanh form in float32, shared by
// the standalone GELU kernel (forecaster.cu) and the GELU epilogue of the
// w1 product (products.cu), so that both give the same bits for the same
// bf16 input.

#pragma once

namespace chana_gelu {

// x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))
__device__ __forceinline__ float gelu_tanh_f(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

}  // namespace chana_gelu
