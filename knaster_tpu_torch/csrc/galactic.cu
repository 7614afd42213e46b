// Galactic's blockwise block for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/galactic.py.
//
// No Pallas kernel precedes it: the JAX package renders Galactic in XLA
// (knaster_tpu/airwindows/galactic.py:113 Galactic.process). The port's plain
// blockwise path (airwindows/galactic.py blockwise_rest) is ~350 small torch
// operations a block of at most 740 samples (the shortest line), so on the
// card the host spends a block launching them, on every superblock of every
// graph with a Galactic (the examples' live edit, voice pool, grain texture
// and buffer player, the FDN). This kernel runs the block after its rates,
// line lengths and vibrato and dither streams (torch operations on the
// host) in one launch.
//
// Work split: one CTA of 256 threads for the one instance; the phases of
// csrc/galactic.cuh, the threads over the samples (or samples and lines)
// of each, a __syncthreads between; the two lowpasses as Hillis-Steele
// scans over both channels' rows; the intermediate rows in a workspace in
// global memory ([48 B + 512] values). The new delay lines are a copy of the
// old ones (made by the wrapper) into which the block's writes land, so
// every read sees the old lines.
//
// Numerics: built with --fmad=false, in the plain version's association;
// the output and the state are bit-equal to it, f32 and f64.

#include <cuda_runtime.h>

#include <cstdint>

#include "galactic.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) galactic_kernel(galactic::Block<T> k) {
  galactic::run<T>(k);
}

template <typename T>
int launch(const void* x, const void* attenuate, const void* lowpass, const void* regen,
           const void* wet, const void* off, const void* tiny, const uint32_t* fpd,
           const int64_t* eff, const void* dbuf, const int32_t* dpos, const void* vib_buf,
           const int32_t* vib_pos, const void* feedback, const void* iir_a, const void* iir_b,
           void* out, void* dbuf_out, int32_t* dpos_out, void* vib_buf_out,
           int32_t* vib_pos_out, void* feedback_out, void* iir_a_out, void* iir_b_out,
           void* ws, int B, int lmax, cudaStream_t stream) {
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  const auto at = [](void* p) { return static_cast<T*>(p); };
  const galactic::Block<T> k{B, lmax, in(x), in(attenuate), in(lowpass), in(regen), in(wet),
                             in(off), in(tiny), fpd, eff, in(dbuf), dpos, in(vib_buf), vib_pos,
                             in(feedback), in(iir_a), in(iir_b), at(out), at(dbuf_out),
                             dpos_out, at(vib_buf_out), vib_pos_out, at(feedback_out),
                             at(iir_a_out), at(iir_b_out), at(ws)};
  galactic_kernel<T><<<1, kThreads, 0, stream>>>(k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One blockwise Galactic block on `stream`; returns cudaGetLastError(). x
// and out [2][B]; attenuate, lowpass, regen, wet [B]; off, tiny [B][2];
// fpd [B][2] u32; eff [12] int64, each above B; dbuf and dbuf_out
// [2][12][lmax] (dbuf_out a copy of dbuf); dpos [2][12] and vib_pos [2]
// int32; vib_buf [2][256]; feedback [2][4]; iir_a, iir_b [2]; the outputs
// alike; ws [48 B + 512]. f32, or f64 where is_double is non-zero.
int ktt_galactic(const void* x, const void* attenuate, const void* lowpass, const void* regen,
                 const void* wet, const void* off, const void* tiny, const uint32_t* fpd,
                 const int64_t* eff, const void* dbuf, const int32_t* dpos,
                 const void* vib_buf, const int32_t* vib_pos, const void* feedback,
                 const void* iir_a, const void* iir_b, void* out, void* dbuf_out,
                 int32_t* dpos_out, void* vib_buf_out, int32_t* vib_pos_out,
                 void* feedback_out, void* iir_a_out, void* iir_b_out, void* ws, int B,
                 int is_double, int lmax, void* stream) {
  if (B < 1 || lmax <= B) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(x, attenuate, lowpass, regen, wet, off, tiny, fpd, eff, dbuf, dpos,
                              vib_buf, vib_pos, feedback, iir_a, iir_b, out, dbuf_out, dpos_out,
                              vib_buf_out, vib_pos_out, feedback_out, iir_a_out, iir_b_out, ws,
                              B, lmax, s)
             : launch<float>(x, attenuate, lowpass, regen, wet, off, tiny, fpd, eff, dbuf, dpos,
                             vib_buf, vib_pos, feedback, iir_a, iir_b, out, dbuf_out, dpos_out,
                             vib_buf_out, vib_pos_out, feedback_out, iir_a_out, iir_b_out, ws,
                             B, lmax, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
