// BufferReader's block over a CTA, shared by the kernel
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
//
// Only the pointer (pi, pf, finished) carries from sample to sample; the
// frames it reads never feed back. So the CTA works through the block in
// tiles of TS samples, each in three phases split by barriers:
// 1. the CTA copies the tile's six planes of its I instances into shared
//    memory, coalesced;
// 2. one thread an instance walks the pointer over the tile in shared
//    memory (walk_row) and records, for each sample, the clamped frames idx
//    and idx1, pf after the restart and before the step, and `finished`
//    after the restart and before the sample's hit, with the done flag;
// 3. the CTA's threads gather the two frames of every (sample, channel)
//    and write the output and the done flags, coalesced.
// The pointer carries from tile to tile in shared memory. Within a phase
// the threads split the work (KTT_BR_FOR, this thread `lane` of `lanes`);
// on the host each phase runs every thread's share, thread by thread,
// before the next, and the barriers are empty.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define KTT_BR_FN __host__ __device__ __forceinline__
#define KTT_BR_CTA __device__ __forceinline__
#define KTT_BR_FOR(i, n) for (int i = lane; i < (n); i += lanes)
#define KTT_BR_SYNC() __syncthreads()
#else
#define KTT_BR_FN inline
#define KTT_BR_CTA inline
#define KTT_BR_FOR(i, n)                                              \
  for (int ktt_br_lane_ = 0; ktt_br_lane_ < lanes; ++ktt_br_lane_) \
    for (int i = ktt_br_lane_; i < (n); i += lanes)
#define KTT_BR_SYNC()
#endif

namespace reader {

// a sample's flag byte: the planes' flags in, the walk's records out
constexpr uint8_t kLooping = 1, kRestart = 2, kFinished = 4, kDone = 8;

KTT_BR_FN float floor_of(float x) { return floorf(x); }
KTT_BR_FN double floor_of(double x) { return floor(x); }

KTT_BR_FN int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

KTT_BR_FN int32_t clamp_frame(int32_t i, int32_t frames) {
  return i < 0 ? 0 : (i > frames - 1 ? frames - 1 : i);
}

// One sample of the walk from its inputs (the flag byte f: kLooping,
// kRestart; s_int, s_frac, end, step); the pointer carried in pi, pf and
// finished. Records the clamped frames idx and idx1, pf before the step
// and, in f, kFinished | kDone.
template <typename T>
KTT_BR_FN void walk_sample(uint8_t& f, int32_t si, T sf, T en, T st, int32_t frames,
                           int32_t& pi, T& pf, bool& finished, int32_t& idx, int32_t& idx1,
                           T& pf_at) {
  const bool r = (f & kRestart) != 0;
  if (r) {
    pi = si;
    pf = sf;
  }
  finished = finished && !r;
  idx = clamp_frame(pi, frames);
  idx1 = clamp_frame(add_wrap(pi, 1), frames);
  pf_at = pf;
  const bool finished_at = finished;
  pf = pf + st;
  const int32_t adv = static_cast<int32_t>(floor_of(pf));
  pi = add_wrap(pi, adv);
  pf = pf - static_cast<T>(adv);
  const bool hit = (static_cast<T>(pi) + pf >= en) && !finished;
  const bool loop = (f & kLooping) != 0;
  if (hit && loop) {
    pi = si;
    pf = sf;
  }
  const bool d = hit && !loop;
  finished = finished || d;
  f = static_cast<uint8_t>((finished_at ? kFinished : 0) | (d ? kDone : 0));
}

// One instance's walk over len samples of its tile row. In: s_int,
// s_frac, end, step and the flag bytes. Out, in the slots of the sample's
// own inputs: idx into s_int, pf into s_frac, idx1, and the flag byte. pi,
// pf and finished are the carried state, read and written in place. Whole
// chunks of kChunk samples read their inputs into registers before their
// steps and write their records after, so that no shared-memory access
// waits on the carried chain; the tail goes sample by sample.
constexpr int kChunk = 8;

template <typename T>
KTT_BR_FN void walk_row(int len, int32_t frames, int32_t& pi, T& pf, bool& finished,
                        int32_t* __restrict__ s_int, T* __restrict__ s_frac,
                        const T* __restrict__ end, const T* __restrict__ step,
                        uint8_t* __restrict__ flags, int32_t* __restrict__ idx1) {
  int t0 = 0;
  for (; t0 + kChunk <= len; t0 += kChunk) {
    uint8_t f[kChunk];
    int32_t si[kChunk], ix[kChunk], i1[kChunk];
    T sf[kChunk], en[kChunk], st[kChunk], pf_at[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      f[k] = flags[t0 + k];
      si[k] = s_int[t0 + k];
      sf[k] = s_frac[t0 + k];
      en[k] = end[t0 + k];
      st[k] = step[t0 + k];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      walk_sample<T>(f[k], si[k], sf[k], en[k], st[k], frames, pi, pf, finished, ix[k], i1[k],
                     pf_at[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      s_int[t0 + k] = ix[k];
      s_frac[t0 + k] = pf_at[k];
      idx1[t0 + k] = i1[k];
      flags[t0 + k] = f[k];
    }
  }
  for (; t0 < len; ++t0) {
    uint8_t f = flags[t0];
    int32_t ix, i1;
    T pf_at;
    walk_sample<T>(f, s_int[t0], s_frac[t0], end[t0], step[t0], frames, pi, pf, finished, ix,
                   i1, pf_at);
    s_int[t0] = ix;
    s_frac[t0] = pf_at;
    idx1[t0] = i1;
    flags[t0] = f;
  }
}

// One channel's output at a sample from the walk's records; row: the
// channel's frames.
template <typename T>
KTT_BR_FN T gather(const T* row, int32_t idx, int32_t idx1, T pf, bool finished) {
  if (finished) return T(0);
  const T a = row[idx];
  const T b = row[idx1];
  return a + (b - a) * pf;
}

// One launch's tensors: buf [C][frames]; the state and the state after [n];
// the planes and done [n][B]; out [n][C][B].
template <typename T>
struct Io {
  const T* buf;
  const int32_t* ptr_int;
  const T* ptr_frac;
  const uint8_t* finished;
  const int32_t* s_int;
  const T* s_frac;
  const T* end;
  const T* step;
  const uint8_t* looping;
  const uint8_t* restart;
  T* out;
  uint8_t* done;
  int32_t* ptr_int_out;
  T* ptr_frac_out;
  uint8_t* finished_out;
  int n, B, C, frames;
};

// A CTA's tile in shared memory: I instances' planes and records for TS
// samples, rows padded to an odd word stride so that thread j walking row
// j meets no bank conflict, and the carried pointer.
template <typename T>
struct Tile {
  int pitch, fpitch;  // row strides: 4- or 8-byte values, bytes
  T* s_frac;          // [I][pitch]: s_frac in, pf out
  T* end;             // [I][pitch]
  T* step;            // [I][pitch]
  T* pf;              // [I] carried
  int32_t* s_int;     // [I][pitch]: s_int in, idx out
  int32_t* idx1;      // [I][pitch]
  int32_t* pi;        // [I] carried
  uint8_t* flags;     // [I][fpitch]
  uint8_t* fin;       // [I] carried

  KTT_BR_FN static int pitch_of(int TS) { return TS + 1; }
  KTT_BR_FN static int fpitch_of(int TS) { return (TS + 7) / 8 * 8 + 4; }
  KTT_BR_FN static int64_t bytes(int I, int TS) {
    const int64_t p = pitch_of(TS);
    return static_cast<int64_t>(I) * ((3 * p + 1) * sizeof(T) + (2 * p + 1) * 4 +
                                      fpitch_of(TS) + 1);
  }
  KTT_BR_FN Tile(void* base, int I, int TS) {
    pitch = pitch_of(TS);
    fpitch = fpitch_of(TS);
    const int64_t rows = static_cast<int64_t>(I) * pitch;
    s_frac = static_cast<T*>(base);
    end = s_frac + rows;
    step = end + rows;
    pf = step + rows;
    s_int = reinterpret_cast<int32_t*>(pf + I);
    idx1 = s_int + rows;
    pi = idx1 + rows;
    flags = reinterpret_cast<uint8_t*>(pi + I);
    fin = flags + static_cast<int64_t>(I) * fpitch;
  }
};

// The block of instances [first, first + I) of the launch, TS samples a
// tile, in `smem` (Tile::bytes(I, TS)). Instances past n (the last CTA's)
// are skipped.
template <typename T>
KTT_BR_CTA void cta(const Io<T>& io, int first, int I, int TS, void* smem, int lane, int lanes) {
  Tile<T> m(smem, I, TS);
  const int B = io.B, C = io.C;
  const int live = io.n - first < I ? io.n - first : I;
  KTT_BR_FOR(j, live) {
    m.pi[j] = io.ptr_int[first + j];
    m.pf[j] = io.ptr_frac[first + j];
    m.fin[j] = io.finished[first + j];
  }
  for (int t0 = 0; t0 < B; t0 += TS) {
    const int len = B - t0 < TS ? B - t0 : TS;
    KTT_BR_FOR(e, live * len) {  // 1. the planes
      const int j = e / len, k = e - j * len;
      const int64_t g = static_cast<int64_t>(first + j) * B + t0 + k;
      const int at = j * m.pitch + k;
      m.s_int[at] = io.s_int[g];
      m.s_frac[at] = io.s_frac[g];
      m.end[at] = io.end[g];
      m.step[at] = io.step[g];
      m.flags[j * m.fpitch + k] = static_cast<uint8_t>((io.looping[g] != 0 ? kLooping : 0) |
                                                       (io.restart[g] != 0 ? kRestart : 0));
    }
    KTT_BR_SYNC();
    KTT_BR_FOR(j, live) {  // 2. the walk
      const int at = j * m.pitch;
      int32_t pi = m.pi[j];
      T pf = m.pf[j];
      bool fin = m.fin[j] != 0;
      walk_row<T>(len, io.frames, pi, pf, fin, m.s_int + at, m.s_frac + at, m.end + at,
                  m.step + at, m.flags + j * m.fpitch, m.idx1 + at);
      m.pi[j] = pi;
      m.pf[j] = pf;
      m.fin[j] = fin ? 1 : 0;
    }
    KTT_BR_SYNC();
    KTT_BR_FOR(e, live * C * len) {  // 3. the gather
      const int j = e / (C * len), ck = e - j * C * len;
      const int c = ck / len, k = ck - c * len;
      const int at = j * m.pitch + k;
      io.out[(static_cast<int64_t>(first + j) * C + c) * B + t0 + k] =
          gather<T>(io.buf + static_cast<int64_t>(c) * io.frames, m.s_int[at], m.idx1[at],
                    m.s_frac[at], (m.flags[j * m.fpitch + k] & kFinished) != 0);
    }
    KTT_BR_FOR(e, live * len) {
      const int j = e / len, k = e - j * len;
      io.done[static_cast<int64_t>(first + j) * B + t0 + k] =
          (m.flags[j * m.fpitch + k] & kDone) != 0 ? 1 : 0;
    }
    KTT_BR_SYNC();
  }
  KTT_BR_FOR(j, live) {
    io.ptr_int_out[first + j] = m.pi[j];
    io.ptr_frac_out[first + j] = m.pf[j];
    io.finished_out[first + j] = m.fin[j];
  }
}

}  // namespace reader
