// The fused N-stage FM cascade for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/fm_cascade.py.
//
// Replaces knaster_tpu/models/voices.py::FMCascade._process_pallas (kernel
// :661). Stage 0 runs at `freq`; stage k at base + depth * out[k-1]. Each
// stage turns its frequency row into u32 phase increments, takes their
// prefix sum from the stage's carried phase, and outputs the sine of the
// 16384-grid table index; the last stage's row times `amp` is the block.
// The four params arrive at block rate (params[0..3] = freq, base, depth,
// amp, as the Pallas kernel reads params[...][0] into SMEM); the N phases
// are read and written in place.
//
// Design. One CTA runs the whole cascade, one thread per sample. A stage's
// output row stays in shared memory as the next stage's modulator, so the
// stage loop never leaves the SM; each stage is one block scan of the
// increments (warp shuffles plus one shared-memory pass over the warp
// totals) and one sinf per sample. The Pallas kernel's Hillis-Steele lane
// cumsum is the TPU's form of that scan and is not carried over.
//
// What bounds it: the N dependent stages, each a scan (three __syncthreads)
// and a sinf; one SM of the card's 132 does all the work, which is what a
// serial 256-deep cascade at B = 64 is. Memory is N phase words per block.

#include "stage_scan.cuh"

namespace {

using namespace ktt;

__global__ void fm_cascade_kernel(const float* __restrict__ params,
                                  uint32_t* __restrict__ phases,
                                  float* __restrict__ out, int N, int B, float f2pi,
                                  float scale) {
  extern __shared__ float mod[];  // [B]: the previous stage's output row
  __shared__ uint32_t scratch[32];
  const float freq = params[0], base = params[1], depth = params[2], amp = params[3];
  for (int k = 0; k < N; ++k) {
    const uint32_t ph0 = phases[k];
    uint32_t running = 0u;  // the sum of the increments of earlier chunks
    for (int t0 = 0; t0 < B; t0 += blockDim.x) {
      const int t = t0 + threadIdx.x;
      const bool live = t < B;
      uint32_t inc = 0u;
      if (live) {
        const float f = k == 0 ? freq : __fadd_rn(base, __fmul_rn(depth, mod[t]));
        inc = inc_i32_sat(__fmul_rn(f, f2pi));
      }
      uint32_t total;
      const uint32_t incl = block_scan_u32(inc, scratch, &total);
      if (live) mod[t] = sin_quant(ph0 + running + incl - inc, scale);
      running += total;
    }
    if (threadIdx.x == 0) phases[k] = ph0 + running;
  }
  for (int t = threadIdx.x; t < B; t += blockDim.x) out[t] = __fmul_rn(mod[t], amp);
}

}  // namespace

extern "C" {

// Runs the cascade over one block on `stream`; returns cudaGetLastError().
int ktt_fm_cascade(const float* params, uint32_t* phases, float* out, int N, int B,
                   float f2pi, float scale, void* stream) {
  if (N < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(B) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fm_cascade_kernel<<<1, stage_threads(B), smem, static_cast<cudaStream_t>(stream)>>>(
      params, phases, out, N, B, f2pi, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
