// Host stand-ins for what a lowered voice body (knaster_tpu_torch/kernels/
// lower.py) takes from csrc/generic_harness.cuh, so that
// tests/test_torch_lower_body.py compiles the emitted source with the host
// C++ compiler: the CUDA qualifiers, as_f/as_u, the policy bases and a
// param view that reads a row the test fills.
#pragma once

#include <math.h>

#include <cstdint>
#include <cstring>

#define __device__
#define __forceinline__ inline

struct float4 {
  float x, y, z, w;
};

inline float as_f(uint32_t x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}

inline uint32_t as_u(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}

struct NoHoist {};
struct NoTable {};

// P(k): float param k at this sample; i_f the sample index
template <bool EVENTFUL>
struct HostParams {
  static constexpr bool kEventful = EVENTFUL;
  const float* row;
  float i_f;
  float operator()(int k) const { return row[k]; }
};
