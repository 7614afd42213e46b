// BufferReader's block for Hopper (sm_90a), called through ctypes from
// knaster_tpu_torch/kernels/buffer_reader.py.
//
// No TPU kernel precedes it: the JAX package renders BufferReader as a
// lax.scan in XLA (knaster_tpu/ugens/buffer.py:109 BufferReader.process).
// The port's plain version (ugens/buffer.py buffer_reader_block) walks the
// block in Python, ~25 small torch operations a sample, so on the card the
// host spends a block launching them (~1,600 at B = 64). This kernel is one
// launch a block.
//
// Work split: one thread per instance (the leading batch axes, flattened)
// walks the block's B samples in order (csrc/buffer_reader.cuh walk): the
// pointer recurrence is sequential and its reads are gathers at
// data-dependent frames, so there is nothing to spread over a warp within
// one instance. The buffer stays in global memory; a block reads at most
// 2 B frames of it a channel. The window arithmetic (start, end, the
// start's int and fraction, the step) stays on the host as torch
// operations and comes in as [n][B] planes.
//
// Numerics: built with --fmad=false, so every add and multiply rounds on
// its own in the plain version's order: the output, the done flags and the
// state are bit-equal to it, f32 and f64.

#include <cuda_runtime.h>

#include <cstdint>

#include "buffer_reader.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
buffer_reader_kernel(const T* __restrict__ buf, const int32_t* __restrict__ ptr_int,
                     const T* __restrict__ ptr_frac, const uint8_t* __restrict__ finished,
                     const int32_t* __restrict__ s_int, const T* __restrict__ s_frac,
                     const T* __restrict__ end, const T* __restrict__ step,
                     const uint8_t* __restrict__ looping, const uint8_t* __restrict__ restart,
                     T* __restrict__ out, uint8_t* __restrict__ done,
                     int32_t* __restrict__ ptr_int_out, T* __restrict__ ptr_frac_out,
                     uint8_t* __restrict__ finished_out, int n, int B, int C, int frames) {
  const int inst = blockIdx.x * blockDim.x + threadIdx.x;
  if (inst >= n) return;
  const int64_t row = static_cast<int64_t>(inst) * B;
  int32_t pi = ptr_int[inst];
  T pf = ptr_frac[inst];
  bool fin = finished[inst] != 0;
  reader::walk<T>(buf, C, frames, B, pi, pf, fin, s_int + row, s_frac + row, end + row,
                  step + row, looping + row, restart + row, out + row * C, done + row);
  ptr_int_out[inst] = pi;
  ptr_frac_out[inst] = pf;
  finished_out[inst] = fin ? 1 : 0;
}

template <typename T>
int launch(const void* buf, const int32_t* ptr_int, const void* ptr_frac,
           const uint8_t* finished, const int32_t* s_int, const void* s_frac, const void* end,
           const void* step, const uint8_t* looping, const uint8_t* restart, void* out,
           uint8_t* done, int32_t* ptr_int_out, void* ptr_frac_out, uint8_t* finished_out,
           int n, int B, int C, int frames, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  buffer_reader_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(buf), ptr_int, static_cast<const T*>(ptr_frac), finished, s_int,
      static_cast<const T*>(s_frac), static_cast<const T*>(end), static_cast<const T*>(step),
      looping, restart, static_cast<T*>(out), done, ptr_int_out, static_cast<T*>(ptr_frac_out),
      finished_out, n, B, C, frames);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block of n BufferReader instances on `stream`; returns
// cudaGetLastError(). buf [C][frames]; ptr_int, ptr_frac, finished and
// their outputs [n]; s_int, s_frac, end, step, looping, restart and done
// [n][B]; out [n][C][B]. The float tensors f32, or f64 where is_double is
// non-zero; the flags one byte each (0 or 1).
int ktt_buffer_reader(const void* buf, const int32_t* ptr_int, const void* ptr_frac,
                      const uint8_t* finished, const int32_t* s_int, const void* s_frac,
                      const void* end, const void* step, const uint8_t* looping,
                      const uint8_t* restart, void* out, uint8_t* done, int32_t* ptr_int_out,
                      void* ptr_frac_out, uint8_t* finished_out, int n, int B, int C,
                      int frames, int is_double, void* stream) {
  if (n < 1 || B < 1 || C < 1 || frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(buf, ptr_int, ptr_frac, finished, s_int, s_frac, end, step,
                              looping, restart, out, done, ptr_int_out, ptr_frac_out,
                              finished_out, n, B, C, frames, s)
             : launch<float>(buf, ptr_int, ptr_frac, finished, s_int, s_frac, end, step,
                             looping, restart, out, done, ptr_int_out, ptr_frac_out,
                             finished_out, n, B, C, frames, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
