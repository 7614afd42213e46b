// BufferReader's per-instance walk over one block, shared by the kernel
// (csrc/buffer_reader.cu) and, compiled by the host C++ compiler, by
// tests/test_torch_buffer_reader.py, which holds it bit-equal to the plain
// version (knaster_tpu_torch/ugens/buffer.py buffer_reader_block).
//
// Per sample t, in the plain version's order and association:
// - a restart loads the window's start (s_int, s_frac) and clears
//   `finished`;
// - the output of channel c is a + (b - a) * pf from the frames at the
//   clamped pi and pi + 1, or +0 once finished;
// - pf steps, its floor carries into pi, and the pointer (pi as a float
//   plus pf) at or past the end sets `hit` unless finished: a looping
//   reader goes back to the start, a one-shot one is done and finished.
// The int32 adds wrap as torch's do. Built with --fmad=false (and
// -ffp-contract=off on the host), every add and multiply rounds on its own.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define KTT_BR_FN __host__ __device__ __forceinline__
#else
#define KTT_BR_FN inline
#endif

namespace reader {

KTT_BR_FN float floor_of(float x) { return floorf(x); }
KTT_BR_FN double floor_of(double x) { return floor(x); }

KTT_BR_FN int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

KTT_BR_FN int32_t clamp_frame(int32_t i, int32_t frames) {
  return i < 0 ? 0 : (i > frames - 1 ? frames - 1 : i);
}

// One instance's block. buf: [C][frames]; the planes s_int, s_frac, end,
// step, looping and restart: [B]; out: [C][B]; done: [B]. pi, pf and
// finished are the carried state, read and written in place.
template <typename T>
KTT_BR_FN void walk(const T* buf, int C, int32_t frames, int B, int32_t& pi, T& pf,
                    bool& finished, const int32_t* s_int, const T* s_frac, const T* end,
                    const T* step, const uint8_t* looping, const uint8_t* restart, T* out,
                    uint8_t* done) {
  for (int t = 0; t < B; ++t) {
    const bool r = restart[t] != 0;
    if (r) {
      pi = s_int[t];
      pf = s_frac[t];
    }
    finished = finished && !r;
    const int32_t idx = clamp_frame(pi, frames);
    const int32_t idx1 = clamp_frame(add_wrap(pi, 1), frames);
    for (int c = 0; c < C; ++c) {
      const T* row = buf + static_cast<int64_t>(c) * frames;
      const T a = row[idx];
      const T b = row[idx1];
      const T v = a + (b - a) * pf;
      out[static_cast<int64_t>(c) * B + t] = finished ? T(0) : v;
    }
    pf = pf + step[t];
    const int32_t adv = static_cast<int32_t>(floor_of(pf));
    pi = add_wrap(pi, adv);
    pf = pf - static_cast<T>(adv);
    const bool hit = (static_cast<T>(pi) + pf >= end[t]) && !finished;
    const bool loop = looping[t] != 0;
    if (hit && loop) {
      pi = s_int[t];
      pf = s_frac[t];
    }
    const bool d = hit && !loop;
    finished = finished || d;
    done[t] = d ? 1 : 0;
  }
}

}  // namespace reader
