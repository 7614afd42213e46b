// EnvAsr's block as element steps, the one copy of its arithmetic in the
// CUDA sources: the block kernel (csrc/env_asr.cu), the fused banks' state
// machine (csrc/bank_common.cuh env_asr) and the chain kernel's EnvAsr
// body (csrc/chain_kernel.cu body_env) include it; compiled by the host C++
// compiler, tests/test_torch_env_asr.py holds it bit-equal to the plain
// version (knaster_tpu_torch/ugens/envelopes.py: EnvAsr._step sample by
// sample, asr_closed_form).
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
//   cumsum_base16 (rows of 16 from 0, the row totals scanned alike, each
//   row plus the totals before it) for the voice models.
// Built with --fmad=false (-ffp-contract=off on the host), every add and
// multiply rounds on its own.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define KTT_ENV_FN __host__ __device__ __forceinline__
#else
#define KTT_ENV_FN inline
#endif

namespace asr {

constexpr int kStopped = 0, kAttacking = 1, kSustaining = 2, kReleasing = 3;
constexpr int kScanBase = 16;

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

// one Hillis-Steele step of lane t at stride s: x -> y
template <typename T>
KTT_ENV_FN void hs_step(const T* x, T* y, int t, int s) {
  y[t] = x[t] + (t >= s ? x[t - s] : T(0));
}

// x[0, n) -> its inclusive prefix sum in cumsum_base16's association, in
// place; `work` holds ceil(n/16) + ceil(n/256) + ... values
template <typename T>
KTT_ENV_FN void scan_base16(T* x, int n, T* work) {
  if (n <= kScanBase) {
    T acc = x[0] + T(0);
    x[0] = acc;
    for (int c = 1; c < n; ++c) {
      acc = acc + x[c];
      x[c] = acc;
    }
    return;
  }
  const int rows = (n + kScanBase - 1) / kScanBase;
  for (int r = 0; r < rows; ++r) {  // each row from 0, the tail padded with +0
    const int c0 = r * kScanBase;
    T acc = x[c0] + T(0);
    x[c0] = acc;
    for (int c = c0 + 1; c < c0 + kScanBase; ++c) {
      acc = acc + (c < n ? x[c] : T(0));
      if (c < n) x[c] = acc;
    }
    work[r] = acc;
  }
  scan_base16(work, rows, work + rows);
  for (int r = 0; r < rows; ++r) {  // each row plus the totals before it
    const T before = r > 0 ? work[r - 1] : T(0);
    const int end = (r + 1) * kScanBase < n ? (r + 1) * kScanBase : n;
    for (int c = r * kScanBase; c < end; ++c) x[c] = x[c] + before;
  }
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

}  // namespace asr
