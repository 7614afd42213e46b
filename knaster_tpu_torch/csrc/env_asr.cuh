// EnvAsr's block: its element steps, the one copy of its arithmetic in the
// CUDA sources, and the block kernel's work over a CTA. The block kernel
// (csrc/env_asr.cu), the fused banks' state machine (csrc/bank_common.cuh
// env_asr) and the chain kernel's EnvAsr body (csrc/chain_kernel.cu
// body_env) include it; compiled by the host C++ compiler,
// tests/test_torch_env_asr.py holds it bit-equal to the plain version
// (knaster_tpu_torch/ugens/envelopes.py: EnvAsr._step sample by sample,
// asr_closed_form).
//
// Two paths, as the plain version takes them:
// - the state machine sample by sample (envelopes.rs:52-80), where the
//   block has events or the envelope runs inside a voice bank: a restart
//   before the sample, a release from attack or sustain, the output, the
//   next t, attack -> sustain at 1 (t pinned to 1), release -> stopped at 0
//   (done);
// - the event-free closed form over the rates' prefix sums: the attack's
//   t0 + A[t] and t0 + A[t - 1], the release's t0 - R[t] and t0 - R[t - 1]
//   cubed and scaled, the last lane deciding the transition. The prefix sum
//   is the plain version's: core/dsp.py cumsum (Hillis-Steele steps s = 1,
//   2, 4, ... < B, lane t adding lane t - s or +0) for graph nodes, or
//   cumsum_base16 (csrc/scan_base16.cuh) for the voice models.
//
// The block kernel's phases (step_cta, closed_cta) run on every thread of a
// CTA: within a phase the threads split the work (KTT_ENV_FOR, this thread
// `lane` of `lanes`) and meet at a barrier (KTT_ENV_SYNC) before the next.
// On the host each phase runs every thread's share, thread by thread,
// before the next, and the barriers are empty; what a thread holds across
// a barrier (the Hillis-Steele step's x[t - s]) is held per thread there
// too.
// Built with --fmad=false (-ffp-contract=off on the host), every add and
// multiply rounds on its own.

#pragma once

#include <stdint.h>

#include "scan_base16.cuh"

#ifdef __CUDACC__
#define KTT_ENV_FN __host__ __device__ __forceinline__
#define KTT_ENV_CTA __device__ __forceinline__
#define KTT_ENV_FOR(i, n) for (int i = lane; i < (n); i += lanes)
#define KTT_ENV_SYNC() __syncthreads()
#define KTT_ENV_LEADER (lane == 0)
#else
#include <vector>
#define KTT_ENV_FN inline
#define KTT_ENV_CTA inline
#define KTT_ENV_FOR(i, n)                                               \
  for (int ktt_env_lane_ = 0; ktt_env_lane_ < lanes; ++ktt_env_lane_) \
    for (int i = ktt_env_lane_; i < (n); i += lanes)
#define KTT_ENV_SYNC()
#define KTT_ENV_LEADER true
#endif

namespace asr {

constexpr int kStopped = 0, kAttacking = 1, kSustaining = 2, kReleasing = 3;

// one sample of the state machine (EnvAsr._step): the triggers before it;
// returns the output, advances stage, t and rscale, sets *done. The stage is
// an int (the block kernel) or a float (the fused banks' carried words).
template <typename T, typename S>
KTT_ENV_FN T step(bool restart, bool release, T atk, T rel, S* stage, T* t, T* rscale,
                  bool* done) {
  S s = restart ? S(kAttacking) : *stage;
  const bool from_atk = release && s == S(kAttacking);
  const bool from_sus = release && s == S(kSustaining);
  T rs = from_atk ? *t : (from_sus ? T(1) : *rscale);
  T tt = (from_atk || from_sus) ? T(1) : *t;
  s = (from_atk || from_sus) ? S(kReleasing) : s;
  const T out = s == S(kAttacking) ? tt
              : s == S(kSustaining) ? T(1)
              : s == S(kReleasing) ? tt * tt * tt * rs
              : T(0);
  T next = s == S(kAttacking) ? tt + atk : (s == S(kReleasing) ? tt - rel : tt);
  const bool to_sustain = s == S(kAttacking) && next >= T(1);
  next = to_sustain ? T(1) : next;
  const bool d = s == S(kReleasing) && next <= T(0);
  s = to_sustain ? S(kSustaining) : s;
  s = d ? S(kStopped) : s;
  next = d ? T(0) : next;
  *stage = s;
  *t = next;
  *rscale = rs;
  *done = d;
  return out;
}

// lane t of the closed form from the inclusive prefix sums before it (A[t -
// 1] and R[t - 1], 0 at t = 0) and at it (R[t]); the state before the block
template <typename T>
KTT_ENV_FN void closed_lane_of(T a_pre, T r_pre, T r_at, int t, int32_t stage0, T t0, T rs,
                               T* out, bool* done) {
  const T e_atk = t0 + a_pre;
  const T out_atk = e_atk >= T(1) ? T(1) : e_atk;
  const T inc_rel = t0 - r_at;
  const T e_rel = t0 - r_pre;
  const bool alive = t == 0 || e_rel > T(0);
  const T out_rel = alive ? e_rel * e_rel * e_rel * rs : T(0);
  const bool done_rel = alive && inc_rel <= T(0);
  *out = stage0 == kAttacking ? out_atk
       : stage0 == kSustaining ? T(1)
       : stage0 == kReleasing ? out_rel
       : T(0);
  *done = stage0 == kReleasing && done_rel;
}

// lane t of the closed form from the inclusive prefix sums A (attack) and
// R (release)
template <typename T>
KTT_ENV_FN void closed_lane(const T* A, const T* R, int t, int32_t stage0, T t0, T rs, T* out,
                            bool* done) {
  closed_lane_of<T>(t > 0 ? A[t - 1] : T(0), t > 0 ? R[t - 1] : T(0), R[t], t, stage0, t0, rs,
                    out, done);
}

// the state after the closed-form block from the last lanes of A and R
template <typename T>
KTT_ENV_FN void closed_state(T a_last, T r_last, int32_t* stage, T* t) {
  const T inc_atk = *t + a_last;
  const bool atk_any = inc_atk >= T(1);
  const T inc_rel = *t - r_last;
  const bool rel_done = inc_rel <= T(0);
  if (*stage == kAttacking) {
    *t = atk_any ? T(1) : inc_atk;
    *stage = atk_any ? kSustaining : kAttacking;
  } else if (*stage == kReleasing) {
    *t = rel_done ? T(0) : inc_rel;
    *stage = rel_done ? kStopped : kReleasing;
  }
}

// ------------------------------------------------------------ the CTA's work

// the block kernel's modes: the state machine, the closed form over either
// scan
constexpr int kStep = 0, kHillisSteele = 1, kBase16 = 2;
// the state machine's flag bytes: the triggers in, the done flag out
constexpr uint8_t kRestartBit = 1, kReleaseBit = 2;

// One launch's tensors: the state [n], the rates and the triggers [n][B],
// the outputs [n][B] and the state after [n].
template <typename T>
struct Io {
  const int32_t* stage;
  const T* t;
  const T* rscale;
  const T* atk;
  const T* rel;
  const uint8_t* restart;
  const uint8_t* release;
  T* out;
  uint8_t* done;
  int32_t* stage_out;
  T* t_out;
  T* rscale_out;
  int n, B;
};

// The state machine's tile in shared memory: I instances' rates and flag
// bytes for TS samples, rows padded to an odd word stride so that thread j
// walking row j meets no bank conflict, and the carried state.
template <typename T>
struct StepTile {
  int pitch, fpitch;  // row strides: T values, bytes
  T* atk;             // [I][pitch]: the attack rate in, the output out
  T* rel;             // [I][pitch]
  T* t;               // [I] carried
  T* rs;              // [I]
  int32_t* stage;     // [I]
  uint8_t* flags;     // [I][fpitch]: kRestartBit | kReleaseBit in, done out

  KTT_ENV_FN static int pitch_of(int TS) { return TS + 1; }
  KTT_ENV_FN static int fpitch_of(int TS) { return (TS + 7) / 8 * 8 + 4; }
  KTT_ENV_FN static int64_t bytes(int I, int TS) {
    return static_cast<int64_t>(I) * ((2 * pitch_of(TS) + 2) * sizeof(T) + 4 + fpitch_of(TS));
  }
  KTT_ENV_FN StepTile(void* base, int I, int TS) {
    pitch = pitch_of(TS);
    fpitch = fpitch_of(TS);
    atk = static_cast<T*>(base);
    rel = atk + static_cast<int64_t>(I) * pitch;
    t = rel + static_cast<int64_t>(I) * pitch;
    rs = t + I;
    stage = reinterpret_cast<int32_t*>(rs + I);
    flags = reinterpret_cast<uint8_t*>(stage + I);
  }
};

// One instance's walk over len samples of its tile row: each sample's
// output into its attack rate's slot and done flag into its flag byte.
// Whole chunks of kChunk samples read their inputs into registers before
// their steps and write their outputs after, so that no shared-memory
// access waits on the carried chain; the tail goes sample by sample.
constexpr int kChunk = 8;

template <typename T>
KTT_ENV_FN void step_row(T* __restrict__ atk, const T* __restrict__ rel,
                         uint8_t* __restrict__ flags, int len, int32_t* stage, T* t, T* rscale) {
  int32_t s = *stage;
  T tt = *t, rs = *rscale;
  int t0 = 0;
  for (; t0 + kChunk <= len; t0 += kChunk) {
    uint8_t f[kChunk];
    T a[kChunk], r[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      f[k] = flags[t0 + k];
      a[k] = atk[t0 + k];
      r[k] = rel[t0 + k];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      bool d = false;
      a[k] = step<T>((f[k] & kRestartBit) != 0, (f[k] & kReleaseBit) != 0, a[k], r[k], &s, &tt,
                     &rs, &d);
      f[k] = d ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      atk[t0 + k] = a[k];
      flags[t0 + k] = f[k];
    }
  }
  for (; t0 < len; ++t0) {
    const uint8_t f = flags[t0];
    bool d = false;
    atk[t0] = step<T>((f & kRestartBit) != 0, (f & kReleaseBit) != 0, atk[t0], rel[t0], &s, &tt,
                      &rs, &d);
    flags[t0] = d ? 1 : 0;
  }
  *stage = s;
  *t = tt;
  *rscale = rs;
}

// The state machine over instances [first, first + I) of the launch: one
// thread an instance walks the block, TS samples at a time staged through
// shared memory (`smem`, StepTile::bytes(I, TS)): the CTA reads the tile's
// rates and triggers coalesced, every instance walks its row, the CTA
// writes the outputs and done flags coalesced. The state carries from tile
// to tile in shared memory. Instances past n (the last CTA's) are skipped.
template <typename T>
KTT_ENV_CTA void step_cta(const Io<T>& io, int first, int I, int TS, void* smem, int lane,
                          int lanes) {
  StepTile<T> m(smem, I, TS);
  const int B = io.B;
  const int live = io.n - first < I ? io.n - first : I;
  KTT_ENV_FOR(j, live) {
    m.stage[j] = io.stage[first + j];
    m.t[j] = io.t[first + j];
    m.rs[j] = io.rscale[first + j];
  }
  for (int t0 = 0; t0 < B; t0 += TS) {
    const int len = B - t0 < TS ? B - t0 : TS;
    KTT_ENV_FOR(e, live * len) {
      const int j = e / len, k = e - j * len;
      const int64_t g = static_cast<int64_t>(first + j) * B + t0 + k;
      m.atk[j * m.pitch + k] = io.atk[g];
      m.rel[j * m.pitch + k] = io.rel[g];
      m.flags[j * m.fpitch + k] = static_cast<uint8_t>((io.restart[g] != 0 ? kRestartBit : 0) |
                                                       (io.release[g] != 0 ? kReleaseBit : 0));
    }
    KTT_ENV_SYNC();
    KTT_ENV_FOR(j, live) {
      step_row<T>(m.atk + j * m.pitch, m.rel + j * m.pitch, m.flags + j * m.fpitch, len,
                  &m.stage[j], &m.t[j], &m.rs[j]);
    }
    KTT_ENV_SYNC();
    KTT_ENV_FOR(e, live * len) {
      const int j = e / len, k = e - j * len;
      const int64_t g = static_cast<int64_t>(first + j) * B + t0 + k;
      io.out[g] = m.atk[j * m.pitch + k];
      io.done[g] = m.flags[j * m.fpitch + k];
    }
    KTT_ENV_SYNC();
  }
  KTT_ENV_FOR(j, live) {
    io.stage_out[first + j] = m.stage[j];
    io.t_out[first + j] = m.t[j];
    io.rscale_out[first + j] = m.rs[j];
  }
}

// An instance's rows for the closed form: A and R ([2][B]) and, for the
// base-16 scan, its work for each ([2][scan_work(B)]); for the Hillis-Steele
// steps in the global workspace, a second [2][B] to step into.
KTT_ENV_FN int64_t closed_row_len(int mode, int B, bool global) {
  if (mode == kBase16) return 2 * static_cast<int64_t>(B) + 2 * ktt::scan_work(B);
  return (global ? 4 : 2) * static_cast<int64_t>(B);
}

// The value lane i of the rows x [2][B] adds at stride s: x[i - s] within
// its row, or +0.
template <typename T>
KTT_ENV_FN T hs_addend(const T* x, int i, int B, int s) {
  const int t = i < B ? i : i - B;
  return t >= s ? x[i - s] : T(0);
}

// The Hillis-Steele steps over the rows x [2][B] in place in shared
// memory. Each thread keeps its K lanes (this thread + k * lanes, 2 B <= K
// * lanes) in registers; at each stride it reads their addends from x, a
// barrier, then adds them and writes its lanes back, a barrier.
template <typename T, int K>
KTT_ENV_CTA void hs_in_place(T* x, int B, int lane, int lanes) {
  const int n = 2 * B;
#ifdef __CUDACC__
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + k * lanes;
    v[k] = i < n ? x[i] : T(0);
  }
  for (int s = 1; s < B; s <<= 1) {
    T add[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + k * lanes;
      add[k] = i < n ? hs_addend<T>(x, i, B, s) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + k * lanes;
      v[k] = v[k] + add[k];
      if (i < n) x[i] = v[k];
    }
    __syncthreads();
  }
#else
  // each thread's K registers, every thread's reads before any write
  std::vector<T> v(static_cast<size_t>(lanes) * K), add(v.size());
  for (int u = 0; u < lanes; ++u) {
    for (int k = 0; k < K; ++k) {
      const int i = u + k * lanes;
      v[u * K + k] = i < n ? x[i] : T(0);
    }
  }
  for (int s = 1; s < B; s <<= 1) {
    for (int u = 0; u < lanes; ++u) {
      for (int k = 0; k < K; ++k) {
        const int i = u + k * lanes;
        add[u * K + k] = i < n ? hs_addend<T>(x, i, B, s) : T(0);
      }
    }
    for (int u = 0; u < lanes; ++u) {
      for (int k = 0; k < K; ++k) {
        const int i = u + k * lanes;
        v[u * K + k] = v[u * K + k] + add[u * K + k];
        if (i < n) x[i] = v[u * K + k];
      }
    }
  }
#endif
}

// The Hillis-Steele steps over the rows x [2][B] in the global workspace,
// stepping into y [2][B] and back; returns the rows that hold the sums.
template <typename T>
KTT_ENV_CTA T* hs_ping_pong(T* x, T* y, int B, int lane, int lanes) {
  for (int s = 1; s < B; s <<= 1) {
    KTT_ENV_FOR(i, 2 * B) { y[i] = x[i] + hs_addend<T>(x, i, B, s); }
    KTT_ENV_SYNC();
    T* z = x;
    x = y;
    y = z;
  }
  return x;
}

// The closed form of instance `inst` on `lanes` threads (this one `lane`,
// lanes a multiple of 64) over its rows (closed_row_len, in shared memory
// or, where `global`, in the workspace): the two prefix sums, then every
// lane's output and done flag, then the state after. Every group of a CTA
// takes the same barriers; a group past n (the last CTA's) works on the
// last instance's rows and writes nothing.
template <typename T, int K>
KTT_ENV_CTA void closed_block(const Io<T>& io, int inst, int mode, bool global, T* rows,
                              int lane, int lanes) {
  const int B = io.B;
  const bool live = inst < io.n;
  const int src = live ? inst : io.n - 1;
  const int64_t row = static_cast<int64_t>(src) * B;
  T* A = rows;
  if (mode == kBase16) {
    // the two sums at once, each on half the lanes, from the rates in
    // device memory
    const int half = lanes / 2, work = ktt::scan_work(B);
#ifdef __CUDACC__
    const int w = lane < half ? 0 : 1;
    ktt::scan_sum_base16<T>((w ? io.rel : io.atk) + row, rows + w * B, rows + 2 * B + w * work,
                            B, lane - w * half, half);
#else
    for (int w = 0; w < 2; ++w) {
      ktt::scan_sum_base16<T>((w ? io.rel : io.atk) + row, rows + w * B,
                              rows + 2 * B + w * work, B, 0, half);
    }
#endif
  } else {
    KTT_ENV_FOR(i, 2 * B) { rows[i] = i < B ? io.atk[row + i] : io.rel[row + i - B]; }
    KTT_ENV_SYNC();
    if (global) {
      A = hs_ping_pong<T>(rows, rows + 2 * B, B, lane, lanes);
    } else {
      hs_in_place<T, K>(rows, B, lane, lanes);
    }
  }
  const T* R = A + B;
  const int32_t s0 = io.stage[src];
  const T t0 = io.t[src], rs = io.rscale[src];
  KTT_ENV_FOR(i, B) {
    T o;
    bool d;
    closed_lane<T>(A, R, i, s0, t0, rs, &o, &d);
    if (live) {
      io.out[row + i] = o;
      io.done[row + i] = d ? 1 : 0;
    }
  }
  if (KTT_ENV_LEADER && live) {
    int32_t s = s0;
    T tt = t0;
    closed_state<T>(A[B - 1], R[B - 1], &s, &tt);
    io.stage_out[src] = s;
    io.t_out[src] = tt;
    io.rscale_out[src] = rs;
  }
}

// A CTA of G groups of P threads, group g the closed form of instance
// first + g over rows + g * stride (this thread `tid` of the CTA).
template <typename T, int K>
KTT_ENV_CTA void closed_cta(const Io<T>& io, int first, int G, int P, int mode, bool global,
                            T* rows, int64_t stride, int tid) {
#ifdef __CUDACC__
  const int g = tid / P;
  closed_block<T, K>(io, first + g, mode, global, rows + g * stride, tid - g * P, P);
#else
  for (int g = 0; g < G; ++g) {
    closed_block<T, K>(io, first + g, mode, global, rows + g * stride, 0, P);
  }
#endif
}

}  // namespace asr
