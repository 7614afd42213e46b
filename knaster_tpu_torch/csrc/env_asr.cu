// EnvAsr's block for Hopper (sm_90a), called through ctypes from
// knaster_tpu_torch/kernels/env_asr.py.
//
// No Pallas kernel precedes it: the JAX package renders EnvAsr.process in
// XLA (knaster_tpu/ugens/envelopes.py:157), a lax.scan of the state machine
// or, event-free, a closed form. The port's plain versions (ugens/
// envelopes.py) take ~20 small torch operations a sample on the eventful
// path (the loop over the block, also every block of a voice bank) and
// ~190 a block on the closed form's, so on the card the host spends a block
// launching them. This kernel is one launch a block, on either path.
//
// Work split (csrc/env_asr.cuh holds each CTA's phases):
// - the state machine: one thread an instance, up to kStepInstances
//   instances a CTA of kStepThreads, the block staged through shared
//   memory in tiles of TS samples (read and written coalesced by the whole
//   CTA; each instance walks its tile row there);
// - the closed form: P threads an instance (a multiple of 64, up to 1024,
//   about a quarter of the rows' 2 B values each), G instances a CTA where
//   P is small. The rows A and R live in shared memory: the Hillis-Steele
//   steps in place (each thread holds its lanes' x[t - s] over a barrier),
//   or the base-16 scans, both at once on half the threads each
//   (csrc/scan_base16.cuh). Where the rows outgrow shared memory (B past
//   kMaxInPlace for Hillis-Steele, or past the opt-in for base-16) or the
//   caller forces it, they live in a global workspace ([n][closed_row_len]
//   values, one instance a CTA; Hillis-Steele then steps between two rows).
//
// Numerics: the element steps of csrc/env_asr.cuh, built with --fmad=false:
// the outputs, the done flags and the state are bit-equal to the plain
// version, f32 and f64.

#include <cuda_runtime.h>

#include <cstdint>

#include "env_asr.cuh"

namespace {

using asr::Io;

constexpr int kStepThreads = 128;  // the state machine's threads a CTA
constexpr int kStepInstances = 32;  // and its instances: several CTAs an SM overlap phases
constexpr int kClosedThreads = 256;  // the closed form's threads a CTA where G > 1
constexpr int kMaxThreads = 1024;
constexpr int kMaxInPlace = 8192;  // the Hillis-Steele rows held in place: K <= 16
constexpr int kStepSmem = 96 * 1024;  // the state machine's tile budget
constexpr int kSmemLimit = 227 * 1024;  // the opt-in per CTA

template <typename T>
__global__ void __launch_bounds__(kStepThreads) env_step_kernel(Io<T> io, int I, int TS) {
  extern __shared__ __align__(16) unsigned char smem[];
  asr::step_cta<T>(io, blockIdx.x * I, I, TS, smem, threadIdx.x, blockDim.x);
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
env_closed_kernel(Io<T> io, int G, int P, int mode, T* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t stride = asr::closed_row_len(mode, io.B, ws != nullptr);
  const int first = blockIdx.x * G;
  T* rows = ws != nullptr ? ws + first * stride : reinterpret_cast<T*>(smem);
  asr::closed_cta<T, K>(io, first, G, P, mode, ws != nullptr, rows, stride, threadIdx.x);
}

// Lets a kernel take up to kSmemLimit bytes of dynamic shared memory, once.
template <typename F>
cudaError_t allow_smem(F kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  *done = err == cudaSuccess;
  return err;
}

// The state machine's samples a tile: the whole block where it fits the
// budget, else the most (a multiple of 16) that do.
template <typename T>
int step_tile(int I, int B) {
  if (asr::StepTile<T>::bytes(I, B) <= kStepSmem) return B;
  int TS = 16;
  while (TS + 16 < B && asr::StepTile<T>::bytes(I, TS + 16) <= kStepSmem) TS += 16;
  return TS;
}

// The closed form's threads an instance: 2 B / 4 rounded up to 64, 64 to 1024.
int closed_threads(int B) {
  int P = (2 * B / 4 + 63) / 64 * 64;
  return P < 64 ? 64 : (P > kMaxThreads ? kMaxThreads : P);
}

// Whether the closed form's rows of an instance fit shared memory.
template <typename T>
bool closed_in_shared(int B, int mode) {
  if (mode == asr::kHillisSteele && B > kMaxInPlace) return false;
  return asr::closed_row_len(mode, B, false) * static_cast<int64_t>(sizeof(T)) <= kSmemLimit;
}

template <typename T, int K>
int launch_closed(const Io<T>& io, int mode, T* ws, cudaStream_t stream) {
  static bool smem_ok = false;
  const int P = closed_threads(io.B);
  int G = 1;
  int64_t smem = 0;
  if (ws == nullptr) {
    const int64_t per = asr::closed_row_len(mode, io.B, false) * static_cast<int64_t>(sizeof(T));
    G = kClosedThreads / P > 1 ? kClosedThreads / P : 1;
    G = G < io.n ? G : io.n;
    while (G > 1 && G * per > kSmemLimit) --G;
    smem = G * per;
    if (smem > 48 * 1024) {
      const cudaError_t err = allow_smem(env_closed_kernel<T, K>, &smem_ok);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int grid = (io.n + G - 1) / G;
  env_closed_kernel<T, K><<<grid, G * P, smem, stream>>>(io, G, P, mode, ws);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Io<T>& io, int mode, T* ws, cudaStream_t stream) {
  if (mode == asr::kStep) {
    static bool smem_ok = false;
    const int I = io.n < kStepInstances ? io.n : kStepInstances;
    const int TS = step_tile<T>(I, io.B);
    const int64_t smem = asr::StepTile<T>::bytes(I, TS);
    if (smem > 48 * 1024) {
      const cudaError_t err = allow_smem(env_step_kernel<T>, &smem_ok);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    env_step_kernel<T><<<(io.n + I - 1) / I, kStepThreads, smem, stream>>>(io, I, TS);
    return static_cast<int>(cudaGetLastError());
  }
  if (ws == nullptr && !closed_in_shared<T>(io.B, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == asr::kBase16 || ws != nullptr) return launch_closed<T, 1>(io, mode, ws, stream);
  // the lanes a thread holds over a barrier: 2 B <= K * P
  const int P = closed_threads(io.B);
  const int K = (2 * io.B + P - 1) / P;
  if (K <= 1) return launch_closed<T, 1>(io, mode, ws, stream);
  if (K <= 2) return launch_closed<T, 2>(io, mode, ws, stream);
  if (K <= 4) return launch_closed<T, 4>(io, mode, ws, stream);
  if (K <= 8) return launch_closed<T, 8>(io, mode, ws, stream);
  return launch_closed<T, 16>(io, mode, ws, stream);
}

template <typename T>
int launch_of(const int32_t* stage, const void* t, const void* rscale, const void* atk,
              const void* rel, const uint8_t* restart, const uint8_t* release, void* out,
              uint8_t* done, int32_t* stage_out, void* t_out, void* rscale_out, void* ws, int n,
              int B, int mode, cudaStream_t stream) {
  const Io<T> io{stage, static_cast<const T*>(t), static_cast<const T*>(rscale),
                 static_cast<const T*>(atk), static_cast<const T*>(rel), restart, release,
                 static_cast<T*>(out), done, stage_out, static_cast<T*>(t_out),
                 static_cast<T*>(rscale_out), n, B};
  return launch<T>(io, mode, static_cast<T*>(ws), stream);
}

}  // namespace

extern "C" {

// The workspace values an instance the closed form takes at B (0: its rows
// fit shared memory), or where global_rows is non-zero the workspace layout
// regardless; 0 for the state machine, which stages tiles in shared memory.
long long ktt_env_asr_workspace(int B, int mode, int is_double, int global_rows) {
  if (mode == asr::kStep || B < 1) return 0;
  const bool shared = is_double ? closed_in_shared<double>(B, mode)
                                : closed_in_shared<float>(B, mode);
  return shared && !global_rows ? 0 : asr::closed_row_len(mode, B, true);
}

// One block of n EnvAsr instances on `stream`; returns cudaGetLastError().
// stage (int32), t, rscale and their outputs [n]; atk, rel (the rates),
// restart, release (bytes), out and done (bytes) [n][B]; ws null (the rows
// in shared memory) or [n][ktt_env_asr_workspace] values (the rows in
// global memory); mode 0 the state machine, 1 the closed form over
// Hillis-Steele prefix sums, 2 over base-16 ones. f32, or f64 where
// is_double is non-zero.
int ktt_env_asr(const int32_t* stage, const void* t, const void* rscale, const void* atk,
                const void* rel, const uint8_t* restart, const uint8_t* release, void* out,
                uint8_t* done, int32_t* stage_out, void* t_out, void* rscale_out, void* ws,
                int n, int B, int mode, int is_double, void* stream) {
  if (n < 1 || B < 1 || mode < asr::kStep || mode > asr::kBase16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch_of<double>(stage, t, rscale, atk, rel, restart, release, out, done,
                                       stage_out, t_out, rscale_out, ws, n, B, mode, s)
                   : launch_of<float>(stage, t, rscale, atk, rel, restart, release, out, done,
                                      stage_out, t_out, rscale_out, ws, n, B, mode, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
