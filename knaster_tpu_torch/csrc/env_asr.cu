// EnvAsr's block for Hopper (sm_90a), called through ctypes from
// knaster_tpu_torch/kernels/env_asr.py.
//
// No Pallas kernel precedes it: the JAX package renders EnvAsr.process in
// XLA (knaster_tpu/ugens/envelopes.py:157), a lax.scan of the state machine
// or, event-free, a closed form. The port's plain versions (ugens/
// envelopes.py) take ~20 small torch operations a sample on the eventful
// path (the loop over the block, also every block of a voice bank) and
// ~190 a block on the closed form's, so on the card the host spends a block
// launching them: inside a SubtractiveVoice node an eventful 32-block chunk
// of the live stream took ~6,100. This kernel is one launch a block, on
// either path.
//
// Work split: one CTA per instance (the leading batch axes, flattened).
// The state machine is sequential: thread 0 walks the block's samples. The
// closed form's two prefix sums: the Hillis-Steele steps with every thread
// over the samples and a __syncthreads between steps, or the base-16 scan
// on thread 0 (a few operations a sample); then every thread writes its
// samples' outputs and done flags, and thread 0 the state. The rows live in
// a workspace in global memory ([n][4][B]).
//
// Numerics: the element steps of csrc/env_asr.cuh, built with --fmad=false:
// the outputs, the done flags and the state are bit-equal to the plain
// version, f32 and f64.

#include <cuda_runtime.h>

#include <cstdint>

#include "env_asr.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStep = 0, kHillisSteele = 1, kBase16 = 2;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
env_asr_kernel(const int32_t* __restrict__ stage, const T* __restrict__ t,
               const T* __restrict__ rscale, const T* __restrict__ atk,
               const T* __restrict__ rel, const uint8_t* __restrict__ restart,
               const uint8_t* __restrict__ release, T* __restrict__ out,
               uint8_t* __restrict__ done, int32_t* __restrict__ stage_out,
               T* __restrict__ t_out, T* __restrict__ rscale_out, T* __restrict__ ws, int B,
               int mode) {
  const int inst = blockIdx.x;
  const int64_t row = static_cast<int64_t>(inst) * B;
  if (mode == kStep) {
    if (threadIdx.x != 0) return;
    int32_t s = stage[inst];
    T tt = t[inst], rs = rscale[inst];
    for (int i = 0; i < B; ++i) {
      bool d = false;
      out[row + i] = asr::step<T>(restart[row + i] != 0, release[row + i] != 0,
                                      atk[row + i], rel[row + i], &s, &tt, &rs, &d);
      done[row + i] = d ? 1 : 0;
    }
    stage_out[inst] = s;
    t_out[inst] = tt;
    rscale_out[inst] = rs;
    return;
  }
  // the two prefix sums: A (attack) and R (release), ping-pong buffers
  T* w = ws + static_cast<int64_t>(inst) * 4 * B;
  T* A = w;
  T* R = w + B;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    A[i] = atk[row + i];
    R[i] = rel[row + i];
  }
  __syncthreads();
  if (mode == kHillisSteele) {
    T* nA = w + 2 * B;
    T* nR = w + 3 * B;
    for (int s = 1; s < B; s <<= 1) {
      for (int i = threadIdx.x; i < B; i += blockDim.x) {
        asr::hs_step<T>(A, nA, i, s);
        asr::hs_step<T>(R, nR, i, s);
      }
      __syncthreads();
      T* a = A;
      A = nA;
      nA = a;
      T* r = R;
      R = nR;
      nR = r;
    }
  } else {
    if (threadIdx.x == 0) {
      asr::scan_base16<T>(A, B, w + 2 * B);
      asr::scan_base16<T>(R, B, w + 2 * B);
    }
    __syncthreads();
  }
  const int32_t s0 = stage[inst];
  const T t0 = t[inst], rs = rscale[inst];
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    bool d = false;
    asr::closed_lane<T>(A, R, i, s0, t0, rs, &out[row + i], &d);
    done[row + i] = d ? 1 : 0;
  }
  if (threadIdx.x == 0) {
    int32_t s = s0;
    T tt = t0;
    asr::closed_state<T>(A[B - 1], R[B - 1], &s, &tt);
    stage_out[inst] = s;
    t_out[inst] = tt;
    rscale_out[inst] = rs;
  }
}

template <typename T>
int launch(const int32_t* stage, const void* t, const void* rscale, const void* atk,
           const void* rel, const uint8_t* restart, const uint8_t* release, void* out,
           uint8_t* done, int32_t* stage_out, void* t_out, void* rscale_out, void* ws, int n,
           int B, int mode, cudaStream_t stream) {
  int threads = mode == kHillisSteele ? ((B + 31) / 32) * 32 : 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  env_asr_kernel<T><<<n, threads, 0, stream>>>(
      stage, static_cast<const T*>(t), static_cast<const T*>(rscale),
      static_cast<const T*>(atk), static_cast<const T*>(rel), restart, release,
      static_cast<T*>(out), done, stage_out, static_cast<T*>(t_out),
      static_cast<T*>(rscale_out), static_cast<T*>(ws), B, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block of n EnvAsr instances on `stream`; returns cudaGetLastError().
// stage (int32), t, rscale and their outputs [n]; atk, rel (the rates),
// restart, release (bytes), out and done (bytes) [n][B]; ws [n][4][B]
// scratch; mode 0 the state machine, 1 the closed form over Hillis-Steele
// prefix sums, 2 over base-16 ones. f32, or f64 where is_double is non-zero.
int ktt_env_asr(const int32_t* stage, const void* t, const void* rscale, const void* atk,
                const void* rel, const uint8_t* restart, const uint8_t* release, void* out,
                uint8_t* done, int32_t* stage_out, void* t_out, void* rscale_out, void* ws,
                int n, int B, int mode, int is_double, void* stream) {
  if (n < 1 || B < 1 || mode < kStep || mode > kBase16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(stage, t, rscale, atk, rel, restart, release, out, done,
                                    stage_out, t_out, rscale_out, ws, n, B, mode, s)
                   : launch<float>(stage, t, rscale, atk, rel, restart, release, out, done,
                                   stage_out, t_out, rscale_out, ws, n, B, mode, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
