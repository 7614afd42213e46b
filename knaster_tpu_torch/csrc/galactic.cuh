// Galactic's blockwise block after its vibrato and dither streams: the body
// of the kernel (csrc/galactic.cu), written once for the card and, compiled
// by the host C++ compiler, for tests/test_torch_galactic_kernel.py, which
// holds it bit-equal to the plain version (knaster_tpu_torch/airwindows/
// galactic.py blockwise_rest).
//
// One instance, one CTA. The phases run in order; within a phase every
// sample (or sample and line) is independent, so the CTA's threads split
// them (KTT_GAL_FOR) and meet at a barrier (KTT_GAL_SYNC) before the next;
// on the host the loops run in order and the barriers are empty. Per
// channel, as the plain version:
// 1. silence replaced by the dither's tiny values (the dry signal), the
//    detune delay's history (its ring oldest-first, then this block's
//    writes, input x attenuate) and its next ring;
// 2. the vibrato read: linear interpolation at t + 1 + floor(offset);
// 3. the pre lowpass (iirA) as core/dsp.py affine_scan_1d scans it: the
//    rows A = 1 - lowpass, C = sig x lowpass, Hillis-Steele steps s = 1, 2,
//    4, ... < B, the state before each sample, the final state;
// 4. the three banks of four lines: every read at (pos + 1 + t) mod the
//    line's length, before any write (lengths exceed B); the Householder
//    mixes 2 b - (b0 + b1 + b2 + b3); the feedback of the other channel's
//    last bank one sample late into the first bank; the writes at (pos + t)
//    mod the length into the new lines; the last bank's sum x 0.125;
// 5. the post lowpass (iirB), the wet/dry mix and the airwindows dither
//    (frexp, exp2 of a whole number: exact on both).
// Built with --fmad=false (-ffp-contract=off on the host): every add and
// multiply rounds on its own, in the plain version's association.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define KTT_GAL_FN __device__ __forceinline__
#define KTT_GAL_FOR(i, n) for (int i = threadIdx.x; i < (n); i += blockDim.x)
#define KTT_GAL_SYNC() __syncthreads()
#define KTT_GAL_LEADER (threadIdx.x == 0)
#else
#define KTT_GAL_FN inline
#define KTT_GAL_FOR(i, n) for (int i = 0; i < (n); ++i)
#define KTT_GAL_SYNC()
#define KTT_GAL_LEADER true
#endif

namespace galactic {

constexpr int kLines = 12;
constexpr int kVibLen = 256;

template <typename T>
struct Block {
  int B;
  int64_t lmax;
  // inputs
  const T* x;          // [2][B] the block's input
  const T* attenuate;  // [B]
  const T* lowpass;    // [B]
  const T* regen;      // [B]
  const T* wet;        // [B]
  const T* off;        // [B][2] the vibrato offsets
  const T* tiny;       // [B][2] the dither's tiny values
  const uint32_t* fpd;  // [B][2] the dither's u32 stream
  const int64_t* eff;  // [12] the lines' lengths this block
  const T* dbuf;       // [2][12][lmax]
  const int32_t* dpos;  // [2][12]
  const T* vib_buf;    // [2][256]
  const int32_t* vib_pos;  // [2]
  const T* feedback;   // [2][4]
  const T* iir_a;      // [2]
  const T* iir_b;      // [2]
  // outputs (dbuf_out holds a copy of dbuf: only the writes land)
  T* out;              // [2][B]
  T* dbuf_out;
  int32_t* dpos_out;
  T* vib_buf_out;
  int32_t* vib_pos_out;
  T* feedback_out;
  T* iir_a_out;
  T* iir_b_out;
  // workspace, ws_size(B) values
  T* ws;
};

KTT_GAL_FN int64_t ws_size(int B) { return 48 * static_cast<int64_t>(B) + 2 * kVibLen; }

KTT_GAL_FN float floor_of(float v) { return floorf(v); }
KTT_GAL_FN double floor_of(double v) { return floor(v); }
KTT_GAL_FN float exp2_of(float v) { return exp2f(v); }
KTT_GAL_FN double exp2_of(double v) { return exp2(v); }
KTT_GAL_FN float frexp_of(float v, int* e) { return frexpf(v, e); }
KTT_GAL_FN double frexp_of(double v, int* e) { return frexp(v, e); }

// the airwindows dither of s from the stream value f (galactic.py _dither):
// the f32 product scaled by 2^(clamp(exponent, 0, 64) + 62), in T
template <typename T>
KTT_GAL_FN T dither(T s, uint32_t f) {
  int e = 0;
  frexp_of(s, &e);
  e = e < 0 ? 0 : (e > 64 ? 64 : e);
  const float d = (static_cast<float>(f) - 2147483648.0f) * 5.5e-36f;
  return s + static_cast<T>(static_cast<T>(d) * exp2_of(static_cast<T>(e) + T(62)));
}

// the Hillis-Steele scan of rows (A, C) in place of core/dsp.py
// affine_scan_1d for both channels at once: rows [2 channels][2 buffers][2
// rows][B]; returns the buffer that holds the result
template <typename T>
KTT_GAL_FN int scan(T* rows, int B) {
  int cur = 0;
  for (int s = 1; s < B; s <<= 1) {
    KTT_GAL_FOR(i, 2 * B) {
      const int c = i / B, t = i - c * B;
      const T* A = rows + (c * 2 + cur) * 2 * B;
      const T* C = A + B;
      T* nA = rows + (c * 2 + (cur ^ 1)) * 2 * B;
      T* nC = nA + B;
      const bool has = t >= s;
      const T al = has ? A[t - s] : T(1);
      const T cl = has ? C[t - s] : T(0);
      nC[t] = A[t] * cl + C[t];
      nA[t] = al * A[t];
    }
    KTT_GAL_SYNC();
    cur ^= 1;
  }
  return cur;
}

// the Householder mix 2 b[j] - (b0 + b1 + b2 + b3) of four line values
template <typename T>
KTT_GAL_FN T mix4(const T* b, int j) {
  const T total = b[0] + b[1] + b[2] + b[3];
  return T(2) * b[j] - total;
}

// the lowpass over both channels' rows (buffer 0 of `rows`: A = 1 -
// lowpass, C = b, with b kept in `b`): sig = a * (the state before each
// sample) + b, in place of b; the final states into s_out
template <typename T>
KTT_GAL_FN void lowpass(const Block<T>& k, T* rows, T* b, const T* s_in, T* s_out) {
  const int B = k.B;
  const int cur = scan(rows, B);
  KTT_GAL_FOR(i, 2 * B) {
    const int c = i / B, t = i - c * B;
    const T* m = rows + (c * 2 + cur) * 2 * B;
    const T s0 = s_in[c];
    const T pre = t > 0 ? m[t - 1] * s0 + m[B + t - 1] : s0;
    const T a = T(1) - k.lowpass[t];
    b[i] = a * pre + b[i];
    if (t == B - 1) s_out[c] = m[t] * s0 + m[B + t];
  }
  KTT_GAL_SYNC();
}

template <typename T>
KTT_GAL_FN void run(const Block<T>& k) {
  const int B = k.B;
  const int H = kVibLen + B;
  T* dry = k.ws;            // [2][B]
  T* hist = dry + 2 * B;    // [2][256 + B]
  T* sig = hist + 2 * H;    // [2][B]
  T* rows = sig + 2 * B;    // [2 channels][2 buffers][A, C][B]
  T* reads = rows + 8 * B;  // [2][12][B]
  T* fb = reads + 24 * B;   // [2][4][B] the last bank's mixes

  // 1. the dry signal, the detune delay's history and its next ring
  KTT_GAL_FOR(i, 2 * B) {
    const int c = i / B, t = i - c * B;
    const T in = k.x[i];
    const T d = (in < T(0) ? -in : in) < T(1.18e-23) ? k.tiny[2 * t + c] : in;
    dry[i] = d;
    hist[c * H + kVibLen + t] = d * k.attenuate[t];
  }
  KTT_GAL_FOR(i, 2 * kVibLen) {
    const int c = i / kVibLen, j = i - c * kVibLen;
    hist[c * H + j] = k.vib_buf[c * kVibLen + (k.vib_pos[c] + j) % kVibLen];
  }
  KTT_GAL_SYNC();
  KTT_GAL_FOR(i, 2 * kVibLen) {
    const int c = i / kVibLen, s = i - c * kVibLen;
    const int pos = (k.vib_pos[c] + B) % kVibLen;
    k.vib_buf_out[i] = hist[c * H + B + ((s - pos) % kVibLen + kVibLen) % kVibLen];
  }
  if (KTT_GAL_LEADER) {
    for (int c = 0; c < 2; ++c) k.vib_pos_out[c] = (k.vib_pos[c] + B) % kVibLen;
  }

  // 2. the vibrato read, into the pre lowpass's rows
  KTT_GAL_FOR(i, 2 * B) {
    const int c = i / B, t = i - c * B;
    const T o = k.off[2 * t + c];
    const T fl = floor_of(o);
    const int64_t q = static_cast<int64_t>(fl);
    const T low = hist[c * H + t + 1 + q];
    const T high = hist[c * H + t + 2 + q];
    const T v = low + (high - low) * (o - fl);
    T* r = rows + c * 4 * B;
    r[t] = T(1) - k.lowpass[t];
    sig[i] = v * k.lowpass[t];
    r[B + t] = sig[i];
  }
  KTT_GAL_SYNC();

  // 3. the pre lowpass (iirA)
  lowpass(k, rows, sig, k.iir_a, k.iir_a_out);

  // 4. the banks: every read first, the last bank's mixes, then the writes
  KTT_GAL_FOR(i, 2 * kLines * B) {
    const int cl = i / B, t = i - cl * B;
    const int line = cl % kLines;
    const int64_t at = (static_cast<int64_t>(k.dpos[cl]) + 1 + t) % k.eff[line];
    reads[i] = k.dbuf[cl * k.lmax + at];
  }
  KTT_GAL_SYNC();
  KTT_GAL_FOR(i, 2 * 4 * B) {
    const int cj = i / B, t = i - cj * B;
    const int c = cj / 4, j = cj - c * 4;
    T b2[4];
    for (int q = 0; q < 4; ++q) b2[q] = reads[(c * kLines + 8 + q) * B + t];
    fb[i] = mix4(b2, j);
  }
  KTT_GAL_SYNC();
  KTT_GAL_FOR(i, 2 * B) {
    const int c = i / B, t = i - c * B;
    T b[kLines];
    for (int q = 0; q < kLines; ++q) b[q] = reads[(c * kLines + q) * B + t];
    for (int j = 0; j < 4; ++j) {
      const int o = 1 - c;  // the feedback crosses to the other channel
      const T prev = t > 0 ? fb[(o * 4 + j) * B + t - 1] : k.feedback[o * 4 + j];
      const T w[3] = {prev * k.regen[t] + sig[i], mix4(b, j), mix4(b + 4, j)};
      for (int bank = 0; bank < 3; ++bank) {
        const int cl = c * kLines + bank * 4 + j;
        const int64_t at = (static_cast<int64_t>(k.dpos[cl]) + t) % k.eff[bank * 4 + j];
        k.dbuf_out[cl * k.lmax + at] = w[bank];
      }
    }
    const T s2 = (b[8] + b[9] + b[10] + b[11]) * T(0.125);
    sig[i] = s2 * k.lowpass[t];  // the post lowpass's b
    T* r = rows + c * 4 * B;
    r[t] = T(1) - k.lowpass[t];
    r[B + t] = sig[i];
    if (t == B - 1) {
      for (int j = 0; j < 4; ++j) k.feedback_out[c * 4 + j] = fb[(c * 4 + j) * B + t];
    }
  }
  KTT_GAL_FOR(i, 2 * kLines) {
    k.dpos_out[i] = static_cast<int32_t>((static_cast<int64_t>(k.dpos[i]) + B) %
                                         k.eff[i % kLines]);
  }
  KTT_GAL_SYNC();

  // 5. the post lowpass (iirB), the wet/dry mix and the dither
  lowpass(k, rows, sig, k.iir_b, k.iir_b_out);
  KTT_GAL_FOR(i, 2 * B) {
    const int c = i / B, t = i - c * B;
    const T w = k.wet[t];
    const T v = w < T(1) ? sig[i] * w + dry[i] * (T(1) - w) : sig[i];
    k.out[i] = dither(v, k.fpd[2 * t + c]);
  }
}

}  // namespace galactic
