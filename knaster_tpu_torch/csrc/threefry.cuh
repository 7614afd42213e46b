// jax.random's Threefry-2x32 in u32 arithmetic (knaster_tpu_torch/ugens/
// noise.py threefry2x32), shared by the kernels that draw the noise stream:
// csrc/chain_kernel.cu (the WhiteNoise body) and csrc/pink_noise.cu.

#pragma once

#include <cstdint>

namespace ktt {

constexpr uint32_t kThreefryParity = 0x1BD11BDAu;

__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = (x1 << r) | (x1 >> (32 - r));
  x1 ^= x0;
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key (k0, k1),
// in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kThreefryParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      threefry_mix(x0, x1, 13); threefry_mix(x0, x1, 15);
      threefry_mix(x0, x1, 26); threefry_mix(x0, x1, 6);
    } else {
      threefry_mix(x0, x1, 17); threefry_mix(x0, x1, 29);
      threefry_mix(x0, x1, 16); threefry_mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

}  // namespace ktt
