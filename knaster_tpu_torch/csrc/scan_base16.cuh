// The inclusive float prefix sum in the association of core/dsp.py
// cumsum_base16 (jnp.cumsum on XLA's CPU backend), spread over a group of
// threads: the one copy of it, for the chain kernel's SinNumeric and Phasor
// bodies (csrc/chain_kernel.cu) and EnvAsr's base-16 closed form
// (csrc/env_asr.cuh). Compiled by the host C++ compiler,
// tests/test_torch_env_asr.py holds it bit-equal to cumsum_base16.
//
// Step for step: rows of 16, the last one padded with +0, summed left to
// right from +0; the row totals scanned the same way, level by level, until
// a level is one row; then, level by level downwards, each lane's in-row
// sum plus the scanned total of the rows before its own (+0 for the
// first). The +0 adds are the plain version's: they turn -0 into +0.
//
// Within a phase every row or lane is independent, so the group's `lanes`
// threads split them (KTT_SCAN_FOR, this thread `lane`) and meet at a
// barrier (KTT_SCAN_SYNC, the whole CTA's: every group of the CTA scans the
// same length, so all take the same barriers) before the next. On the host
// the loops run every thread's share of a phase, thread by thread, before
// the next phase, and the barriers are empty. Built with --fmad=false
// (-ffp-contract=off on the host): every add rounds on its own.

#pragma once

#ifdef __CUDACC__
#define KTT_SCAN_FN __device__ inline
#define KTT_SCAN_HD __host__ __device__ inline
#define KTT_SCAN_FOR(i, n) for (int i = lane; i < (n); i += lanes)
#define KTT_SCAN_SYNC() __syncthreads()
#define KTT_SCAN_LEADER (lane == 0)
#else
#define KTT_SCAN_FN inline
#define KTT_SCAN_HD inline
#define KTT_SCAN_FOR(i, n)                                    \
  for (int ktt_scan_lane_ = 0; ktt_scan_lane_ < lanes; ++ktt_scan_lane_) \
    for (int i = ktt_scan_lane_; i < (n); i += lanes)
#define KTT_SCAN_SYNC()
#define KTT_SCAN_LEADER true
#endif

namespace ktt {

constexpr int kScanBase = 16;
constexpr int kMaxLevels = 8;  // n up to 16^8

// The work scan_sum_base16 takes for n values: every upper level's totals
// and their prefixes, 2 * (ceil(n/16) + ceil(n/256) + ...) down to one row;
// at most n for n > 16, none for n <= 16.
KTT_SCAN_HD int scan_work(int n) {
  int w = 0;
  while (n > kScanBase) {
    n = (n + kScanBase - 1) / kScanBase;
    w += 2 * n;
  }
  return w;
}

// x[0, n) -> r[0, n); x and r distinct (x may lie in global memory), `work`
// holds scan_work(n) values. Every thread of the group calls it after x is
// written and synchronised; r is complete and synchronised when it returns.
template <typename T>
KTT_SCAN_FN void scan_sum_base16(const T* x, T* r, T* work, int n, int lane, int lanes) {
  int size[kMaxLevels];
  const T* in[kMaxLevels];
  T* res[kMaxLevels];
  size[0] = n;
  in[0] = x;
  res[0] = r;
  int top = 0;
  while (size[top] > kScanBase) {
    const int rows = (size[top] + kScanBase - 1) / kScanBase;
    T* tot = work;
    res[top + 1] = work + rows;
    work += 2 * rows;
    const T* v = in[top];
    const int len = size[top];
    KTT_SCAN_FOR(i, rows) {
      const int c0 = i * kScanBase;
      T acc = T(0) + v[c0];
      for (int c = c0 + 1; c < c0 + kScanBase; ++c) acc = acc + (c < len ? v[c] : T(0));
      tot[i] = acc;
    }
    KTT_SCAN_SYNC();
    ++top;
    size[top] = rows;
    in[top] = tot;
  }
  if (KTT_SCAN_LEADER) {  // the top level: one row
    T acc = T(0) + in[top][0];
    res[top][0] = acc;
    for (int i = 1; i < size[top]; ++i) {
      acc = acc + in[top][i];
      res[top][i] = acc;
    }
  }
  KTT_SCAN_SYNC();
  for (int l = top - 1; l >= 0; --l) {
    const T* v = in[l];
    const T* above = res[l + 1];
    T* out = res[l];
    KTT_SCAN_FOR(i, size[l]) {
      const int row = i / kScanBase, c0 = row * kScanBase;
      T acc = T(0) + v[c0];
      for (int c = c0 + 1; c <= i; ++c) acc = acc + v[c];
      out[i] = acc + (row > 0 ? above[row - 1] : T(0));
    }
    KTT_SCAN_SYNC();
  }
}

}  // namespace ktt
