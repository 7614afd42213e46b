// SvfFilter's block for Hopper (sm_90a), called through ctypes from
// knaster_tpu_torch/kernels/svf_filter.py.
//
// No Pallas kernel precedes it: the JAX package renders SvfFilter.process
// in XLA (knaster_tpu/ugens/filters.py:158), as a prefix scan of the SVF's
// affine maps. The port's plain version (ugens/filters.py svf_rows) runs
// that scan as ~30 small torch operations a Hillis-Steele step, ~400 a
// 704-sample block, so on the card the host spends a block launching them;
// an SvfFilter inside a voice (SubtractiveVoice) or before a Galactic, whose
// superblocks are at most 704 samples, pays it on every one of them, and
// ~140 more for the coefficients. This kernel computes the coefficients,
// the scan and the outputs in one launch from the params' [n][B] rows.
//
// Work split: one CTA per instance (the leading batch axes, flattened),
// its threads over the block's samples. The six scan rows ping-pong between
// two halves of a workspace in global memory ([n][2][6][B], f64 included),
// a __syncthreads between steps; then each thread writes the outputs of its
// samples and the thread of the last sample the final state.
//
// Numerics: the element steps of csrc/svf_filter.cuh, built with
// --fmad=false: the output and the state are bit-equal to the plain
// version on the card, f32 and f64 (pow, sqrt and, at f64, tan are the
// CUDA math library's, as torch's on the card).

#include <cuda_runtime.h>

#include <cstdint>

#include "svf_filter.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
svf_filter_kernel(const T* __restrict__ ic, const T* __restrict__ x,
                  const int32_t* __restrict__ ty, const T* __restrict__ cutoff,
                  const T* __restrict__ q, const T* __restrict__ gain, T* __restrict__ y,
                  T* __restrict__ ic_out, T* __restrict__ ws, int B, T sr) {
  const int inst = blockIdx.x;
  const int64_t row = static_cast<int64_t>(inst) * B;
  T* buf = ws + static_cast<int64_t>(inst) * 12 * B;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    const int64_t i = row + t;
    const svf::Coefs<T> c = svf::coefs<T>(ty[i], cutoff[i], q[i], gain[i], sr);
    svf::rows<T>(buf, B, t, c.a1, c.a2, c.a3, x[i]);
  }
  __syncthreads();
  int cur = 0;
  for (int s = 1; s < B; s <<= 1) {
    const T* r = buf + cur * 6 * B;
    T* n = buf + (cur ^ 1) * 6 * B;
    for (int t = threadIdx.x; t < B; t += blockDim.x) svf::step<T>(r, n, B, t, s);
    __syncthreads();
    cur ^= 1;
  }
  const T* m = buf + cur * 6 * B;
  const T x0 = ic[2 * inst], x1 = ic[2 * inst + 1];
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    const int64_t i = row + t;
    const svf::Coefs<T> c = svf::coefs<T>(ty[i], cutoff[i], q[i], gain[i], sr);
    T s0 = x0, s1 = x1;
    if (t > 0) svf::after<T>(m, B, t - 1, x0, x1, &s0, &s1);
    y[i] = svf::out<T>(s0, s1, c.a1, c.a2, c.a3, c.m0, c.m1, c.m2, x[i]);
    if (t == B - 1) svf::after<T>(m, B, t, x0, x1, &ic_out[2 * inst], &ic_out[2 * inst + 1]);
  }
}

template <typename T>
int launch(const void* ic, const void* x, const int32_t* ty, const void* cutoff, const void* q,
           const void* gain, void* y, void* ic_out, void* ws, int n, int B, double sr,
           cudaStream_t stream) {
  int threads = ((B + 31) / 32) * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  svf_filter_kernel<T><<<n, threads, 0, stream>>>(
      static_cast<const T*>(ic), static_cast<const T*>(x), ty, static_cast<const T*>(cutoff),
      static_cast<const T*>(q), static_cast<const T*>(gain), static_cast<T*>(y),
      static_cast<T*>(ic_out), static_cast<T*>(ws), B, static_cast<T>(sr));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block of n SvfFilter instances on `stream`; returns
// cudaGetLastError(). ic and ic_out [n][2]; x, the params' rows (ty int32,
// cutoff, q, gain) and y [n][B]; ws [n][2][6][B] scratch; sr the sample
// rate (a whole number, exact in f32). f32, or f64 where is_double is
// non-zero.
int ktt_svf_filter(const void* ic, const void* x, const int32_t* ty, const void* cutoff,
                   const void* q, const void* gain, void* y, void* ic_out, void* ws, int n,
                   int B, int sample_rate, int is_double, void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(ic, x, ty, cutoff, q, gain, y, ic_out, ws, n, B, sample_rate, s)
             : launch<float>(ic, x, ty, cutoff, q, gain, y, ic_out, ws, n, B, sample_rate, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
