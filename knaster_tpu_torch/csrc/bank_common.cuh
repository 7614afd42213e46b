// Device pieces every fused voice-bank kernel shares: the counterparts of
// the in-kernel helpers of knaster_tpu/parallel/pallas_bank.py and of the
// plain torch helpers in knaster_tpu_torch/kernels/bank_common.py.
//
// Layout every bank kernel reads. One thread per voice. Float params arrive
// as anchored ramp groups ramps[n_float][5][V] (v0, step, el, dur, tgt);
// eventful blocks add D breakpoint rounds rounds[n_float][5][D][V] (v0,
// step, dur, tgt, frame) and packed trigger words words[n_trig][W][V], W =
// ceil(B/32). The hand FM kernel leaves its mix as warp partials
// partial[ceil(V/32)][C][B], summed by the wrapper; the sine, subtractive,
// generic and wavetable kernels sum it themselves through the CTA mix below
// (CtaMix, mix_combine_warps, mix_finish) into mix[C][B].
//
// Numerics. Every library is built with --fmad=false and no fast math: each
// multiply and add rounds on its own and divides are IEEE divides, as in the
// plain torch versions and XLA at optimization level 0, so carried state is
// bit-equal to the plain versions'. Expressions keep Python's left-to-right
// association.
//
// Each kernel library is one translation unit that includes this header
// once, so the extern "C" ktt_error_string below is defined once per library.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace ktt {

constexpr int kGroup = 5;  // floats per ramp group / breakpoint group

constexpr uint32_t kTableSize = 16384u;
constexpr uint32_t kTableHighMask = kTableSize - 1u;
constexpr uint32_t kCycle = 1u << 30;  // TABLE_SIZE * FRACTIONAL_PART phase units

// np.float32 values of the JAX package's constants, written exactly
constexpr float kIdxScale = 0x1.921fb6p-12f;  // 2*pi / 16384
constexpr float kU2Rad = 0x1.921fb6p-28f;     // 2*pi / 2^30
constexpr float kHalfPi = 0x1.921fb6p+0f;     // pi / 2
constexpr float kQuarterPi = 0x1.921fb6p-1f;  // pi / 4
constexpr float kToIncMax = 0x1.fffffep+30f;  // 2^31 - 128
constexpr float kMinDt = 0x1.12e0bep-30f;     // np.float32(1e-9)
constexpr float kC0 = 1.0f;
constexpr float kC1 = -0x1.555542p-3f;   // -0.16666652
constexpr float kC2 = 0x1.110df8p-7f;    // 0.008332964
constexpr float kC3 = -0x1.9f55f4p-13f;  // -0.00019804752
constexpr float kC4 = 0x1.5cb622p-19f;   // 2.5981028e-06

__device__ __forceinline__ float sin_poly(float u) {
  const float u2 = u * u;
  float p = kC4 * u2 + kC3;
  p = p * u2 + kC2;
  p = p * u2 + kC1;
  return (p * u2 + kC0) * u;
}

// SinWt's table-quantized sine: the 16384-grid index folded to the first
// quadrant by integer identities, then the degree-9 odd polynomial
__device__ __forceinline__ float sin_quant(uint32_t phase) {
  const uint32_t idx = (phase >> 16) & kTableHighMask;
  const uint32_t half = idx & (kTableSize / 2u - 1u);
  const bool neg = idx >= kTableSize / 2u;
  const uint32_t m = half > kTableSize / 4u ? kTableSize / 2u - half : half;
  const float p = sin_poly(static_cast<float>(static_cast<int32_t>(m)) * kIdxScale);
  return neg ? -p : p;
}

// sin_quant's 4097 first-quadrant values, sin_poly(m * kIdxScale) for m =
// 0 ... 4096, in shared memory: filled by every thread of the CTA, then a
// barrier; sin_quant_table(phase, tab) is sin_quant(phase) bit for bit
constexpr int kSinTable = static_cast<int>(kTableSize / 4u) + 1;

__device__ __forceinline__ void fill_sin_table(float* tab) {
  for (int m = threadIdx.x; m < kSinTable; m += blockDim.x) {
    tab[m] = sin_poly(static_cast<float>(m) * kIdxScale);
  }
  __syncthreads();
}

__device__ __forceinline__ float sin_quant_table(uint32_t phase, const float* tab) {
  const uint32_t idx = (phase >> 16) & kTableHighMask;
  const uint32_t half = idx & (kTableSize / 2u - 1u);
  const bool neg = idx >= kTableSize / 2u;
  const uint32_t m = half > kTableSize / 4u ? kTableSize / 2u - half : half;
  const float p = tab[m];
  return neg ? -p : p;
}

// AdditiveVoice's full-resolution phase angle (mod one cycle)
__device__ __forceinline__ float theta_full(uint32_t phase) {
  return static_cast<float>(static_cast<int32_t>(phase & (kCycle - 1u))) * kU2Rad;
}

__device__ __forceinline__ uint32_t to_inc(float x) {
  // jnp.clip(x, 0, 2^31 - 128) then int32 truncation, reinterpreted as u32
  x = fminf(fmaxf(x, 0.0f), kToIncMax);
  return static_cast<uint32_t>(static_cast<int32_t>(x));
}

struct Ramp {
  float v0, step, el, dur, tgt;
};

__device__ __forceinline__ Ramp load_ramp(const float* __restrict__ ramps,
                                          int p, int V, int v) {
  const float* g = ramps + static_cast<size_t>(p) * kGroup * V + v;
  return Ramp{g[0], g[static_cast<size_t>(V)], g[2 * static_cast<size_t>(V)],
              g[3 * static_cast<size_t>(V)], g[4 * static_cast<size_t>(V)]};
}

__device__ __forceinline__ float mat_base(float i_f, const Ramp& g) {
  const float prog = i_f + g.el;
  return prog >= g.dur ? g.tgt : g.v0 + g.step * prog;
}

// breakpoint rounds [n_float][5][D][V]: piece r wins from its frame on
__device__ __forceinline__ float mat_rounds(float i_f, float acc,
                                            const float* __restrict__ rounds,
                                            int p, int D, int V, int v) {
  const size_t plane = static_cast<size_t>(D) * V;
  const float* g = rounds + static_cast<size_t>(p) * kGroup * plane + v;
  for (int r = 0; r < D; ++r) {
    const float* gr = g + static_cast<size_t>(r) * V;
    const float rv0 = __ldg(gr);
    const float rstep = __ldg(gr + plane);
    const float rdur = __ldg(gr + 2 * plane);
    const float rtgt = __ldg(gr + 3 * plane);
    const float rframe = __ldg(gr + 4 * plane);
    const float ln = i_f - rframe;
    const float val = ln >= rdur ? rtgt : rv0 + rstep * ln;
    acc = i_f >= rframe ? val : acc;
  }
  return acc;
}

// the materialized float param p at sample i_f: base ramp, then (eventful)
// the breakpoint rounds
template <bool EVENTFUL>
__device__ __forceinline__ float mat(float i_f, const Ramp& g,
                                     const float* __restrict__ rounds, int p,
                                     int D, int V, int v) {
  const float base = mat_base(i_f, g);
  return EVENTFUL ? mat_rounds(i_f, base, rounds, p, D, V, v) : base;
}

// packed trigger words: word w of trigger k holds frames [32w, 32w+32);
// a thread keeps the current word of each trigger in a register
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              int k, int W, int w, int V, int v) {
  return words[(static_cast<size_t>(k) * W + w) * V + v];
}

__device__ __forceinline__ bool trig_bit(uint32_t word, int i) {
  return (word >> (i & 31)) & 1u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// True where mat_base gives one bit pattern at every sample of an
// event-free block of B samples (kernels/bank_common.py
// ramp_flat_over_block states and tests the rule): the ramp has ended
// (every progress >= el >= dur: tgt), or its step is zero and it does not
// end inside the block, where v0 + step*prog keeps one sign of zero (prog
// never negative, or v0 not zero). The value to hoist is mat_base at i = 0,
// never v0 itself (v0 = -0.0 with step = +0.0 gives +0.0).
__device__ __forceinline__ bool ramp_flat(const Ramp& g, int B) {
  return g.el >= g.dur || (g.step == 0.0f && g.el + static_cast<float>(B - 1) < g.dur &&
                           (g.el >= 0.0f || g.v0 != 0.0f));
}

// The linear-angle pan pack of an event-free block (kernels/bank_common.py
// pan_pack, the JAX package's pallas_bank._pan_fast_operands), built from the raw
// pan ramp group: the angle at sample 0, d(angle)/d(sample), the target's
// gains and the ramp's remaining length. The same operations in the same
// order as the host's; the target gains come from cosf/sinf, which may
// differ from torch's cos/sin by an ulp, and reach the mix only. rem is
// dur - el in f32, the host's (dur - el) rounded wherever |el|, |dur| <= 2^24.
struct PanPack {
  float a0, da, lt, rt, rem;
};

__device__ __forceinline__ PanPack pan_pack(const Ramp& g) {
  const float v0 = g.el >= g.dur ? g.tgt : g.v0 + g.step * g.el;
  const float at = (g.tgt * 0.5f + 0.5f) * kHalfPi;
  return PanPack{(v0 * 0.5f + 0.5f) * kHalfPi, g.step * kQuarterPi, cosf(at), sinf(at),
                 g.dur - g.el};
}

// the pack's gains at sample i_f (_pan_gains): the polynomial cos/sin of the
// linear angle until the ramp ends, the target's gains after
__device__ __forceinline__ void pack_gains(float i_f, const PanPack& p, float& l, float& r) {
  const float angle = p.a0 + p.da * i_f;
  const bool ended = i_f >= p.rem;
  l = ended ? p.lt : sin_poly(kHalfPi - angle);
  r = ended ? p.rt : sin_poly(angle);
}

// True where pack_gains gives one pair at every sample of an event-free
// block of B samples (kernels/bank_common.py pack_flat_over_block states and
// tests the rule): the ramp has ended (rem <= 0: every sample takes the
// target's gains), or the angle's step is zero and the ramp does not end
// inside the block (rem > B - 1), where a0 + da*i is a0 at every sample (a0
// is never -0.0: x*0.5 + 0.5 rounds a zero sum to +0.0). The value to
// hoist is pack_gains at sample 0.
__device__ __forceinline__ bool pack_flat(const PanPack& p, int B) {
  return p.rem <= 0.0f || (p.da == 0.0f && p.rem > static_cast<float>(B - 1));
}

// --------------------------------------------------------------------------
// The mix of the generic and wavetable kernels. Each CTA of 256 voices sums
// its voices' values into one partial row of work[cta][C][B], and
// mix_finish sums the rows. The scratch work holds, in order, the CTA rows,
// one row per group of kMixGroup CTAs, and (eventful blocks) one row per
// warp.
//
// Event-free blocks (CtaMix): a tile of T samples, C*T = 16 (channel,
// sample) columns, column ch*T + t. Each thread stores its value of each
// column into shared memory at [col][tid] (consecutive threads on
// consecutive banks); after one barrier the CTA sums each column of 256
// values, 16 threads a column, each over four float4 reads in a fixed
// interleave (a quarter warp reads 128 contiguous bytes), then a shuffle
// tree over the 16 lanes: a store a value and a quarter of a 16-byte load,
// where a warp shuffle sum takes five shuffles and five adds. Two tile
// buffers alternate, so the barrier of tile k + 1 also orders tile k's
// reads before tile k + 2's writes: one barrier a tile.
//
// Eventful blocks: a warp shuffle sum a sample and channel into the warp's
// row, as the hand kernels do, and one barrier at the end, after which the
// CTA sums its live warps' rows in warp order (mix_combine_warps). These
// blocks re-read their breakpoint rounds every sample from the SM's L1
// cache, which shares its 256 KB with shared memory, and have no register
// to spare under the 64 that keep four CTAs an SM: a tile and its barriers
// cost them more than the shuffles.
//
// mix_finish sums the CTA rows in a fixed order: the last CTA of each group
// (an atomic ticket after a __threadfence) sums its group's rows, the last
// group the group rows, into mix[C][B] (mix_sum_rows); each resets its
// ticket. No float atomics, and the order is the same in every launch.
// --------------------------------------------------------------------------

constexpr int kMixThreads = 256;
constexpr int kMixWarps = kMixThreads / 32;
constexpr int kMixCols = 16;
constexpr int kMixGroup = 32;

template <int C>
struct CtaMix {
  static constexpr int T = kMixCols / C;  // samples a tile
  static constexpr int kParts = kMixThreads / kMixCols;  // threads that sum one column
  float v[2][kMixCols * kMixThreads];

  // a warp past the bank: its values stay zero
  __device__ __forceinline__ void clear() {
    for (int col = 0; col < kMixCols; ++col) {
      v[0][col * kMixThreads + threadIdx.x] = 0.0f;
      v[1][col * kMixThreads + threadIdx.x] = 0.0f;
    }
  }
  // this thread's value x of column col in tile buffer b
  __device__ __forceinline__ void put(int b, int col, float x) {
    v[b][col * kMixThreads + threadIdx.x] = x;
  }
  // every thread: the barrier, then the column sums of buffer b into
  // row[ch*B + i0 + t] for the tile's first nt samples
  __device__ __forceinline__ void flush(int b, float* __restrict__ row, int B, int i0,
                                        int nt) const {
    __syncthreads();
    const int col = threadIdx.x / kParts;
    const int part = threadIdx.x % kParts;
    const float4* src = reinterpret_cast<const float4*>(v[b] + col * kMixThreads);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kMixThreads / (4 * kParts); ++j) {
      const float4 q = src[j * kParts + part];
      s = j == 0 ? q.x : s + q.x;
      s = s + q.y;
      s = s + q.z;
      s = s + q.w;
    }
#pragma unroll
    for (int off = kParts / 2; off > 0; off >>= 1) {
      s = s + __shfl_down_sync(0xffffffffu, s, off, kParts);
    }
    const int t = col % T;
    if (part == 0 && t < nt) row[static_cast<size_t>(col / T) * B + i0 + t] = s;
  }
};

// rows before the warp rows in work: the CTA rows and the group rows
__device__ __forceinline__ size_t mix_head_rows() {
  return gridDim.x + (gridDim.x + kMixGroup - 1) / kMixGroup;
}

// the warp's row of n_cols floats (eventful blocks)
__device__ __forceinline__ float* mix_warp_row(float* work, int n_cols) {
  return work + (mix_head_rows() + blockIdx.x * kMixWarps + (threadIdx.x >> 5)) * n_cols;
}

// Every thread of the CTA, after the eventful sample loop: the barrier,
// then the CTA row = the rows of its warps that hold voices, in warp order.
__device__ __forceinline__ void mix_combine_warps(float* work, int V, int n_cols) {
  const float* warps = work + (mix_head_rows() + blockIdx.x * kMixWarps) * n_cols;
  const int n_live = min(kMixWarps, (V - static_cast<int>(blockIdx.x) * kMixThreads + 31) / 32);
  float* row = work + static_cast<size_t>(blockIdx.x) * n_cols;
  __syncthreads();
  for (int j = threadIdx.x; j < n_cols; j += kMixThreads) {
    float s = warps[j];
    for (int w = 1; w < n_live; ++w) s = s + warps[static_cast<size_t>(w) * n_cols + j];
    row[j] = s;
  }
}

// dst[j] = the n rows of src[n][n_cols] summed, for every column j, in a
// fixed order: tp threads a column (4 where the columns are few), thread q
// adding rows q, q + tp, ... in order, kSumBatch loads issued together, then
// a shuffle tree over the tp threads. Wide rows (n_cols a multiple of 4 past
// the CTA) are read as float4s of four columns, each summed the same way.
constexpr int kSumBatch = 8;

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <class F>
__device__ __forceinline__ F mix_sum_column(const F* src, int n, int n_cols, int j, int q,
                                            int tp) {
  F s{};
  for (int r0 = q; r0 < n; r0 += kSumBatch * tp) {
    F x[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      const int r = r0 + k * tp;
      x[k] = r < n ? __ldcg(src + static_cast<size_t>(r) * n_cols + j) : F{};
    }
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      if (r0 + k * tp < n) s = r0 + k * tp == q ? x[k] : s + x[k];
    }
  }
  return s;
}

__device__ __forceinline__ void mix_sum_rows(const float* src, int n, int n_cols,
                                             float* __restrict__ dst) {
  if (n_cols % 4 == 0 && n_cols > kMixThreads) {
    const int n4 = n_cols / 4;
    for (int j = threadIdx.x; j < n4; j += kMixThreads) {
      reinterpret_cast<float4*>(dst)[j] =
          mix_sum_column(reinterpret_cast<const float4*>(src), n, n4, j, 0, 1);
    }
    return;
  }
  const int tp = n_cols <= kMixThreads / 4 ? 4 : (n_cols <= kMixThreads / 2 ? 2 : 1);
  const int q = threadIdx.x % tp;
  for (int j0 = 0; j0 < n_cols; j0 += kMixThreads / tp) {
    const int j = j0 + static_cast<int>(threadIdx.x) / tp;
    float s = j < n_cols ? mix_sum_column(src, n, n_cols, j, q, tp) : 0.0f;
    for (int off = tp / 2; off > 0; off >>= 1) {
      s = s + __shfl_down_sync(0xffffffffu, s, off, tp);
    }
    if (q == 0 && j < n_cols) dst[j] = s;
  }
}

// The kernel's last statement, every thread of every CTA: work holds the
// gridDim.x CTA rows of n_cols = C*B floats, then one row per group;
// tickets[0] counts groups, tickets[1 + g] the CTAs of group g. All zero
// before the launch and after it.
__device__ __forceinline__ void mix_finish(float* work, float* __restrict__ mix,
                                           unsigned* tickets, int n_cols) {
  __shared__ bool last;
  const int n_cta = static_cast<int>(gridDim.x);
  const int n_groups = (n_cta + kMixGroup - 1) / kMixGroup;
  const int g = static_cast<int>(blockIdx.x) / kMixGroup;
  const int first = g * kMixGroup;
  const int n = min(kMixGroup, n_cta - first);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + 1 + g, 1u) == static_cast<unsigned>(n - 1);
    if (last) atomicExch(tickets + 1 + g, 0u);
  }
  __syncthreads();
  if (!last) return;
  float* level2 = work + static_cast<size_t>(n_cta) * n_cols;
  mix_sum_rows(work + static_cast<size_t>(first) * n_cols, n, n_cols,
               n_groups == 1 ? mix : level2 + static_cast<size_t>(g) * n_cols);
  if (n_groups == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets, 1u) == static_cast<unsigned>(n_groups - 1);
    if (last) atomicExch(tickets, 0u);
  }
  __syncthreads();
  if (!last) return;
  mix_sum_rows(level2, n_groups, n_cols, mix);
}

// --------------------------------------------------------------------------
// The additive partials (the wavetable kernel and the generic Additive
// body): per-harmonic constants as a kernel parameter, so that the fully
// unrolled loop reads them as constant-bank operands, not through the load
// path. HMAX is the instantiation (8, 16, 32 or 64); harmonics from H on are
// padding (A = B = 0, thr = -inf) and the loop stops at H. A table of more
// than 64 harmonics stays in global memory (additive_partials_rt).
// --------------------------------------------------------------------------

template <int HMAX>
struct Harmonics {
  float a[HMAX], b[HMAX], thr[HMAX];
};

// the instantiation of tables past the largest HMAX: the table stays in
// global memory and the harmonic count is known only at run time
constexpr int kRuntimeH = 0;

// H partials of the fundamental angle theta by phasor recurrence, each
// masked by freq <= thr[h], accumulated in h order; sincosf once
template <int HMAX>
__device__ __forceinline__ float additive_partials(float freq, float theta,
                                                   const Harmonics<HMAX>& k, int H) {
  float s1, c1;
  sincosf(theta, &s1, &c1);
  float s = s1, c = c1;
  float acc = freq <= k.thr[0] ? k.a[0] * s + k.b[0] * c : 0.0f;
#pragma unroll
  for (int h = 1; h < HMAX; ++h) {
    if (h >= H) break;
    const float sn = s * c1 + c * s1;
    const float cn = c * c1 - s * s1;
    s = sn;
    c = cn;
    const float part = k.a[h] * s + k.b[h] * c;
    acc = acc + (freq <= k.thr[h] ? part : 0.0f);
  }
  return acc;
}

// additive_partials over a table in global memory, a[H], b[H] and thr[H]
// (tables past the largest instantiation): the same recurrence, masks and
// order; each constant is read with a warp-uniform index, one broadcast load
// through L1 for the warp
__device__ __forceinline__ float additive_partials_rt(float freq, float theta,
                                                      const float* __restrict__ a,
                                                      const float* __restrict__ b,
                                                      const float* __restrict__ thr, int H) {
  float s1, c1;
  sincosf(theta, &s1, &c1);
  float s = s1, c = c1;
  float acc = freq <= __ldg(thr) ? __ldg(a) * s + __ldg(b) * c : 0.0f;
#pragma unroll 4
  for (int h = 1; h < H; ++h) {
    const float sn = s * c1 + c * s1;
    const float cn = c * c1 - s * s1;
    s = sn;
    c = cn;
    const float part = __ldg(a + h) * s + __ldg(b + h) * c;
    acc = acc + (freq <= __ldg(thr + h) ? part : 0.0f);
  }
  return acc;
}

// EnvAsr state machine (stages: 0 stop, 1 atk, 2 sus, 3 rel). With restart
// and release false it is the event-free variant (_env_asr_free). Updates
// stage, t and rscale; returns the envelope value.
__device__ __forceinline__ float env_asr(float& stage, float& t, float& rscale,
                                         bool restart, bool release, float atk,
                                         float rel) {
  if (restart) stage = 1.0f;
  const bool rel_from_atk = release && stage == 1.0f;
  const bool rel_from_sus = release && stage == 2.0f;
  rscale = rel_from_atk ? t : (rel_from_sus ? 1.0f : rscale);
  if (rel_from_atk || rel_from_sus) {
    t = 1.0f;
    stage = 3.0f;
  }
  const float env = stage == 1.0f ? t
                  : stage == 2.0f ? 1.0f
                  : stage == 3.0f ? t * t * t * rscale
                  : 0.0f;
  float t_next = stage == 1.0f ? t + atk : (stage == 3.0f ? t - rel : t);
  const bool to_sus = stage == 1.0f && t_next >= 1.0f;
  if (to_sus) t_next = 1.0f;  // pin sustain t
  const bool done = stage == 3.0f && t_next <= 0.0f;
  if (to_sus) stage = 2.0f;
  if (done) {
    stage = 0.0f;
    t_next = 0.0f;
  }
  t = t_next;
  return env;
}

// True where event-free EnvAsr (restart and release false) leaves (stage,
// t, rscale) as they are at every sample and gives one value, 0 (stopped)
// or 1 (sustain): stage 0 or 2 at block entry (kernels/bank_common.py
// env_asr_steady states and tests the rule)
__device__ __forceinline__ bool env_asr_steady(float stage) {
  return stage == 0.0f || stage == 2.0f;
}

// EnvAr state machine (stages: 0 stopped, 1 attack, 2 release), no sustain.
// restart false is the event-free variant (_env_ar_free). Note that `done`
// excludes the sample that just entered release (~to_rel), which EnvAsr's
// has no counterpart of.
__device__ __forceinline__ float env_ar(float& stage, float& t, bool restart,
                                        float atk, float rel) {
  if (restart) stage = 1.0f;
  const float env = stage == 1.0f ? t : (stage == 2.0f ? t * t * t : 0.0f);
  float t_next = stage == 1.0f ? t + atk : (stage == 2.0f ? t - rel : t);
  const bool to_rel = stage == 1.0f && t_next >= 1.0f;
  if (to_rel) {
    stage = 2.0f;
    t_next = 1.0f;
  }
  const bool done = stage == 2.0f && !to_rel && t_next <= 0.0f;
  if (done) {
    stage = 0.0f;
    t_next = 0.0f;
  }
  t = t_next;
  return env;
}

// SVF lowpass coefficients in the one-divide form (pallas_bank
// _svf_low_coeffs): s = sin(x), c = cos(x) by the odd polynomial,
// a1 = d*c^2, a2 = d*s*c, a3 = d*s^2 with d = q / (q + s*c)
__device__ __forceinline__ void svf_low_coeffs(float x, float q, float& a1,
                                               float& a2, float& a3) {
  const float s = sin_poly(x);
  const float c = sin_poly(kHalfPi - x);
  const float sc = s * c;
  const float d = q / (q + sc);
  a1 = d * (c * c);
  a2 = d * sc;
  a3 = d * (s * s);
}

// polyBLEP residual of the saw (polyblep.rs)
__device__ __forceinline__ float blep(float t, float dt) {
  const float safe_dt = fmaxf(dt, kMinDt);
  const float a = t / safe_dt - 1.0f;
  const float b = (t - 1.0f) / safe_dt + 1.0f;
  return t < dt ? -(a * a) : (t > 1.0f - dt ? b * b : 0.0f);
}

// blep with one IEEE divide (kernels/bank_common.py _blep_one_divide):
// x = (t < dt ? t : t - 1) / safe_dt, then a = x - 1 and b = x + 1 are
// blep's two expressions rounded the same way, and the quotient blep does
// not select was never read. The divide is taken only where some lane of
// the warp is within dt of an edge (t < dt or t > 1 - dt); every lane of
// the warp calls it.
__device__ __forceinline__ float blep_warp(float t, float dt) {
  const bool lo = t < dt;
  const bool hi = t > 1.0f - dt;
  float r = 0.0f;
  if (__any_sync(0xffffffffu, lo || hi)) {
    const float x = (lo ? t : t - 1.0f) / fmaxf(dt, kMinDt);
    const float a = x - 1.0f;
    const float b = x + 1.0f;
    r = lo ? -(a * a) : (hi ? b * b : 0.0f);
  }
  return r;
}

constexpr float kPi = 0x1.921fb6p+1f;  // np.float32(np.pi)

// degree-5 fit of 2^f on [-0.5, 0.5] (pallas_bank _EXP2_C)
constexpr float kExp2C0 = 0x1.5f48c8p-10f;  // 0.0013400433
constexpr float kExp2C1 = 0x1.3d107cp-7f;   // 0.009676037
constexpr float kExp2C2 = 0x1.c6aeccp-5f;   // 0.05550327
constexpr float kExp2C3 = 0x1.ebf906p-3f;   // 0.24022107
constexpr float kExp2C4 = 0x1.62e430p-1f;   // 0.6931472
constexpr float kExp2C5 = 0x1.000002p+0f;   // 1.0000001
constexpr float kLog2E = 0x1.715476p+0f;    // np.float32(log2(e))
constexpr float kTiny = 0x1.197998p-40f;    // np.float32(1e-12)

// exp(x) for x <= 0 (pallas_bank _exp_poly): x*log2(e) = n + f, n rounded
// half to even, 2^n in the exponent field with n clamped to [-126, 0], 2^f
// by the polynomial. The max keeps jnp.maximum's NaN.
__device__ __forceinline__ float exp_poly(float x) {
  float z = x * kLog2E;
  z = z < -126.0f ? -126.0f : z;
  const float n = rintf(z);
  const float f = z - n;
  float p = kExp2C0;
  p = p * f + kExp2C1;
  p = p * f + kExp2C2;
  p = p * f + kExp2C3;
  p = p * f + kExp2C4;
  p = p * f + kExp2C5;
  const int n_i = static_cast<int>(fminf(fmaxf(n, -126.0f), 0.0f));
  return __int_as_float((n_i + 127) << 23) * p;
}

// (sin, cos) of theta in [0, pi] (pallas_bank _sincos_halfturn)
__device__ __forceinline__ void sincos_halfturn(float theta, float& s, float& c) {
  const float folded = kPi - theta;
  s = sin_poly(theta < folded ? theta : folded);
  c = sin_poly(kHalfPi - theta);
}

// the multi-segment Envelope (pallas_bank _make_env_multiseg), its running
// flag folded into seg as these sentinels
constexpr float kEnvSegFinished = -1.0f;  // a non-looping program ran out
constexpr float kEnvSegStopped = -2.0f;   // t_stop froze the value

enum EnvShape { kLinear = 0, kExponential = 1, kSinusoidal = 2, kStep = 3 };

// _segment_value's formula for one shape over the selected constants
__device__ __forceinline__ float env_shape_eval(int shape, float from_v, float val,
                                                float frac) {
  switch (shape) {
    case kLinear:
      return from_v + frac * (val - from_v);
    case kSinusoidal:
      return from_v + (val - from_v) * (1.0f - cosf(kPi * frac)) * 0.5f;
    case kStep:
      return val;
    default: {  // kExponential: geometric for same signs, else linear
      const float lin = from_v + frac * (val - from_v);
      const float fa = fmaxf(fabsf(from_v), kTiny);
      const float ta = fmaxf(fabsf(val), kTiny);
      const float sgn = from_v > 0.0f ? 1.0f : (from_v < 0.0f ? -1.0f : 0.0f);
      const float geo = sgn * fa * expf(frac * logf(ta / fa));
      return from_v * val > 0.0f ? geo : lin;
    }
  }
}

// An envelope program: S segments staged once per CTA into shared memory as
// table[s] = (recip, dur, val, shape code), the present shape codes as a
// bit mask, the start value and the looping flag.
struct EnvProgram {
  const float4* table;
  int S;
  unsigned present;  // bit c set where shape code c occurs in the table
  float start_v;
  bool looping;

  // The segment a lane's seg selects: seg itself where it is one of 1 ...
  // S - 1, else 0 (segment 0 and the negative finished / stopped codes), as
  // the select loop over S of kernels/bank_common.py _make_env_multiseg
  // picks it (env_segment_index there).
  __device__ __forceinline__ int index(float seg) const {
    const int idx = static_cast<int>(seg);
    return static_cast<float>(idx) == seg && idx >= 1 && idx < S ? idx : 0;
  }

  // One sample: the triggers, the selected segment's constants (one
  // 16-byte shared-memory read), its shape's formula (each shape present
  // evaluated only where some lane of the warp selects it; a lane's value
  // is its own shape's either way), t_stop's freeze, then the transitions.
  // Updates seg, t and from_v; returns the envelope value. Every lane of
  // the warp calls it (the shape votes are warp-wide).
  __device__ __forceinline__ float step(float& seg, float& t, float& from_v, float dt,
                                        bool restart, bool stop) const {
    if (restart) {
      seg = 0.0f;
      t = 0.0f;
      from_v = start_v;
    }
    const float4 q = table[index(seg)];
    const float r = q.x, d = q.y, v = q.z;
    const int sh = static_cast<int>(q.w);
    const float frac = fminf(fmaxf(t * r, 0.0f), 1.0f);
    float cur = 0.0f;
#pragma unroll
    for (int code = kLinear; code <= kStep; ++code) {
      if ((present >> code & 1u) && __any_sync(0xffffffffu, sh == code)) {
        const float e = env_shape_eval(code, from_v, v, frac);
        if (sh == code) cur = e;
      }
    }
    if (stop && seg >= 0.0f) {
      from_v = cur;
      seg = kEnvSegStopped;
    }
    const bool is_run = seg >= 0.0f;
    const bool in_seg = t < d;
    const bool has_next = seg + 1.0f < static_cast<float>(S);
    const float out = is_run ? (in_seg ? cur : v) : from_v;
    const bool adv = is_run && !in_seg && has_next;
    const bool fin = is_run && !in_seg && !has_next;
    if (adv || fin) from_v = v;
    t = (is_run && in_seg) ? t + dt : (adv ? t - d + dt : t);
    if (adv) seg = seg + 1.0f;
    if (fin) {
      if (looping) {
        seg = 0.0f;
        t = 0.0f;
      } else {
        seg = kEnvSegFinished;
      }
    }
    return out;
  }
};

}  // namespace ktt

extern "C" const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
