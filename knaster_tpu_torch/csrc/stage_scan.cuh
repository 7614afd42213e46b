// Device pieces the two stage-loop kernels share (csrc/fm_cascade.cu and
// csrc/chain_kernel.cu): the block-wide u32 prefix sum of one oscillator
// stage's phase increments, and the float -> u32 increment conversions.
//
// Layout both kernels use. One CTA runs one stage loop (a cascade or a
// collapsed chain) over one block of B samples, one thread per sample; a
// thread takes samples t = tid, tid + blockDim, ... when B > blockDim, and
// blockDim is a whole number of warps (threads past B add 0 to the scan).
//
// Numerics. Built with --fmad=false and no fast math: every multiply and
// add rounds on its own, as in the plain torch versions, and sinf is the
// accurate library sine. The scan adds u32 with wrap-around, so any order of
// summation gives the same words as the plain versions' int64 cumsum mod 2^32.
//
// Each kernel library is one translation unit that includes this header
// once, so the extern "C" ktt_error_string below is defined once per library.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace ktt {

constexpr uint32_t kTableHighMask = 16383u;  // TABLE_SIZE - 1
constexpr float kFractionalPart = 65536.0f;
constexpr float kToIncMax = 0x1.fffffep+30f;  // 2^31 - 128: exact as int32
constexpr float kTwo31 = 2147483648.0f;       // np.float32(2.0**31 - 1)

// SinWt's increment (osc.py _f32_to_u32): clamp to [0, 2^31 - 128], then
// truncate; negative and NaN give 0.
__device__ __forceinline__ uint32_t inc_u32(float x) {
  x = fminf(fmaxf(x, 0.0f), kToIncMax);
  return static_cast<uint32_t>(static_cast<int>(x));
}

// FMCascade's Pallas increment (voices.py:665): clip to [0, np.float32(2^31
// - 1)] = [0, 2^31], then XLA's saturating f32 -> int32 convert, which maps
// 2^31 to 2^31 - 1 (checked on XLA:CPU, the JAX interpret path). Written out
// so that the saturation does not rest on an out-of-range cast.
__device__ __forceinline__ uint32_t inc_i32_sat(float x) {
  x = fminf(fmaxf(x, 0.0f), kTwo31);
  return x >= kTwo31 ? 0x7fffffffu : static_cast<uint32_t>(static_cast<int>(x));
}

// Inclusive prefix sum of one u32 per thread over the whole block, adding
// with wrap-around. Every thread of the block must call it; `scratch` is 32
// words of shared memory. Returns the thread's inclusive prefix and writes
// the block's total to *total.
__device__ __forceinline__ uint32_t block_scan_u32(uint32_t v, uint32_t* scratch,
                                                   uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < n_warps ? scratch[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    scratch[lane] = w;  // inclusive prefix over the warps' totals
  }
  __syncthreads();
  if (warp > 0) v += scratch[warp - 1];
  *total = scratch[n_warps - 1];
  __syncthreads();  // scratch is free again for the next scan
  return v;
}

// The table-quantized sine of a u32 phase (SinWt: sin of the 16384-grid
// index times 2*pi/16384).
__device__ __forceinline__ float sin_quant(uint32_t phase, float scale) {
  const uint32_t idx = (phase >> 16) & kTableHighMask;
  return sinf(__fmul_rn(static_cast<float>(idx), scale));
}

// Threads for a block of B samples: whole warps, at most 1024.
inline int stage_threads(int B) {
  const int t = (B + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

}  // namespace ktt

extern "C" const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
