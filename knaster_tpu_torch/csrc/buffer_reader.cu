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
// Work split (csrc/buffer_reader.cuh cta): up to kInstances instances a CTA
// of kThreads threads, the block in tiles of TS samples staged through
// shared memory. A tile's planes are read by the whole CTA, coalesced; one
// thread an instance walks the pointer recurrence over the tile in shared
// memory, its only sequential part; then the whole CTA gathers the frames
// and writes the outputs, coalesced. The buffer stays in global memory; a
// block reads at most 2 B frames of it a channel. The window arithmetic
// (start, end, the start's int and fraction, the step) stays on the host
// as torch operations and comes in as [n][B] planes.
//
// Numerics: built with --fmad=false, so every add and multiply rounds on
// its own in the plain version's order: the output, the done flags and the
// state are bit-equal to it, f32 and f64.

#include <cuda_runtime.h>

#include <cstdint>

#include "buffer_reader.cuh"

namespace {

using reader::Io;

constexpr int kThreads = 128;
constexpr int kInstances = 32;  // several CTAs an SM overlap their phases
constexpr int kTileSmem = 96 * 1024;  // a CTA's tile budget
constexpr int kSmemLimit = 227 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) buffer_reader_kernel(Io<T> io, int I, int TS) {
  extern __shared__ __align__(16) unsigned char smem[];
  reader::cta<T>(io, blockIdx.x * I, I, TS, smem, threadIdx.x, blockDim.x);
}

// The samples a tile: the whole block where it fits the budget, else the
// most (a multiple of 16) that do.
template <typename T>
int tile_of(int I, int B) {
  if (reader::Tile<T>::bytes(I, B) <= kTileSmem) return B;
  int TS = 16;
  while (TS + 16 < B && reader::Tile<T>::bytes(I, TS + 16) <= kTileSmem) TS += 16;
  return TS;
}

template <typename T>
int launch(const Io<T>& io, cudaStream_t stream) {
  static bool smem_ok = false;
  const int I = io.n < kInstances ? io.n : kInstances;
  const int TS = tile_of<T>(I, io.B);
  const int64_t smem = reader::Tile<T>::bytes(I, TS);
  if (smem > 48 * 1024 && !smem_ok) {
    const cudaError_t err = cudaFuncSetAttribute(
        buffer_reader_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_ok = true;
  }
  buffer_reader_kernel<T><<<(io.n + I - 1) / I, kThreads, smem, stream>>>(io, I, TS);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_of(const void* buf, const int32_t* ptr_int, const void* ptr_frac,
              const uint8_t* finished, const int32_t* s_int, const void* s_frac,
              const void* end, const void* step, const uint8_t* looping, const uint8_t* restart,
              void* out, uint8_t* done, int32_t* ptr_int_out, void* ptr_frac_out,
              uint8_t* finished_out, int n, int B, int C, int frames, cudaStream_t stream) {
  const Io<T> io{static_cast<const T*>(buf), ptr_int, static_cast<const T*>(ptr_frac),
                 finished, s_int, static_cast<const T*>(s_frac), static_cast<const T*>(end),
                 static_cast<const T*>(step), looping, restart, static_cast<T*>(out), done,
                 ptr_int_out, static_cast<T*>(ptr_frac_out), finished_out, n, B, C, frames};
  return launch<T>(io, stream);
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
             ? launch_of<double>(buf, ptr_int, ptr_frac, finished, s_int, s_frac, end, step,
                                 looping, restart, out, done, ptr_int_out, ptr_frac_out,
                                 finished_out, n, B, C, frames, s)
             : launch_of<float>(buf, ptr_int, ptr_frac, finished, s_int, s_frac, end, step,
                                looping, restart, out, done, ptr_int_out, ptr_frac_out,
                                finished_out, n, B, C, frames, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
