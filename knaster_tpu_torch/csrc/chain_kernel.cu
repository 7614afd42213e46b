// The collapsed-chain executor for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/chain_kernel.py.
//
// Replaces knaster_tpu/graph/chain_kernel.py::run (kernel :265): the whole
// stage loop of a collapsed chain of K isomorphic units of p nodes in one
// kernel. It is compiled once from this file and never generated per graph:
// the host lowers a chain plan into a small int32 program (layout below,
// built by knaster_tpu_torch/graph/chain_kernel.py::lower), so a graph edit
// never waits for nvcc.
//
// Program layout (int32):
//   [0] p  [1] n_carry  [2] n_slots  [3] n_ext  [4] n_state  [5] n_out
//   [6] n_done  [7] n_scratch
//   [8, 8 + n_carry)            the slot each carry row is copied from at
//                               the end of a stage
//   [8 + n_carry, .. + p)       the start of each offset's record
//   record: op, arg, n_in, n_par, n_out, state_row, in_tab, par_tab, out_tab,
//           done_plane (-1 unless the unit may set done)
//     in_tab:  n_in pairs (start, count) of source lists; a list is count
//              (kind, index) pairs summed left to right (0.0 when empty)
//     par_tab: n_par (kind, index) sources, in the body's param order
//     out_tab: n_out pairs (slot, out plane or -1 when nothing outside the
//              chain reads the channel)
//   source kinds: 0 a slot of this stage (an earlier offset's output),
//   1 a carry row (an output of the previous stage), 2 an external row,
//   3 a param plane planes[index][k][t].
//
// Operands: planes f32 [n_planes, K, B] (stage-stacked params; integer
// params as whole-number floats), state i32 [n_state, K] (32-bit state
// words: u32 phases, f32 values and int32 stages as bit patterns), rows f32
// [n_ext + n_carry, B] (external rows, then the carry rows stage 0 reads);
// out f32 [n_out, K, B], state_out i32 [n_state, K] and done u8 (torch
// bool) [n_done, K, B].
//
// Design. One CTA per chain, one thread per sample. The rows of the stage
// being computed (one slot per output channel), the carry rows and the
// scan scratch live in shared memory, or, where they do not fit there (a
// long superblock: the host decides from the program's row count), in a
// global-memory workspace the host allocates for the launch: the same
// stage loop, instantiated on that pointer, so that a chain runs its
// kernel at every superblock length the graph takes. Each thread reads and
// writes only its own samples of the slots and carry rows, but for
// SampleDelay, which reads its input at t - d between two barriers; the
// other cross-thread steps are the block scans: SinWt's and PolyBlep's u32 phase sums (stage_scan.cuh), and
// the Hillis-Steele doubling of the filters' affine maps and the
// envelopes' rate cumsums, log2(B) steps over ping-pong scratch rows with
// one __syncthreads() a step, with the identity fills and the multiply-add
// order of the plain versions (knaster_tpu_torch/core/dsp.py), and
// SinNumeric's and Phasor's f32 phase sums in the blocked base-16
// association of core/dsp.py cumsum_base16 (one barrier a level). EnvAr's
// anchor R[k] is a block min. With --fmad=false every product and sum
// rounds on its own, as in the plain torch versions, so state, outputs and
// done rows are bit-equal to them at every B; the transcendental calls
// (sinf, cosf, expf, powf) are the libdevice functions torch's CUDA ops
// call. The k and j loops are uniform across the block, each record's body
// is a switch on its opcode, and PolyBlep's waveform switch reads one
// plane value per stage, so every warp takes the same branch. A stage's
// done row is written after its output.
//
// WhiteNoise restates jax.random's Threefry-2x32 (fold_in, then one 32-bit
// draw on the partitionable path) in u32 arithmetic, so its stream is the
// JAX package's bit for bit. SampleDelay's ring is L state words of its
// stage, read from `state` and rewritten whole to `state_out`.
//
// Two kernels from one stage loop, a template on whether the program uses a
// body past Math1 (the host reads that from the program's opcodes): a
// program of Constant, SinWt, Math and Math1 bodies only runs
// chain_kernel_small, whose switch holds those four cases and nothing else,
// since the subtractive slice's bodies, compiled into the same switch, made
// the SinWt/Math stage loop of the FM cascade run 19% slower on an H100
// (7.5% with those bodies out of line). chain_kernel_all holds every body,
// inlined.
//
// What bounds it: K*p dependent bodies per block, each a few instructions
// per sample plus, for the scan bodies, log2(B) barrier-separated steps;
// one SM of 132 does the work, which is what a serial 256-deep chain at
// B = 64 is. Running several chains or graphs per launch is later work.
// WhiteNoise is ~240 integer operations a sample with no barrier;
// SampleDelay copies its whole ring from `state` to `state_out` each
// launch (8 L bytes a stage), strided by K words, between two barriers.
//
// B is a superblock's length in the graph's event-free runs (up to 128
// blocks: 131,072 samples at B = 1024): every per-sample loop strides by
// blockDim (at most 1024). Each of the two kernels has a shared-row and a
// global-row instantiation; the global rows cost L2 and HBM latency where
// shared memory would not, and only launches too long for shared memory
// take them.

#include "stage_scan.cuh"

namespace {

using namespace ktt;

// body opcodes (knaster_tpu_torch/kernels/chain_kernel.py BODIES)
constexpr int kOpConstant = 0, kOpSinWt = 1, kOpMath = 2, kOpMath1 = 3, kOpPolyBlep = 4,
              kOpSvf = 5, kOpLpf = 6, kOpHpf = 7, kOpEnvAsr = 8, kOpEnvAr = 9,
              kOpPan2 = 10, kOpSinNumeric = 11, kOpPhasor = 12, kOpWhiteNoise = 13,
              kOpSampleDelay = 14;
// Math args (ugens/math.py KERNEL_BINOPS) and Math1 args (KERNEL_UNOPS)
constexpr int kAdd = 0, kSub = 1, kMul = 2, kDiv = 3;
constexpr int kCeil = 0, kFloor = 1, kSqrt = 2, kExp = 3, kAbs = 4, kNeg = 5,
              kLog = 6, kSin = 7, kCos = 8, kTanh = 9;
constexpr int kSrcSlot = 0, kSrcCarry = 1, kSrcRow = 2, kSrcPlane = 3;
constexpr int kHeader = 8;

// Python's float constants, rounded to f32 as torch rounds a Python number
// (double first, then to the nearest float)
constexpr double kPi = 3.141592653589793;
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kTau = static_cast<float>(2.0 * kPi);
constexpr float kHalfPi = static_cast<float>(kPi / 2.0);
constexpr float kTwoOverPi = static_cast<float>(2.0 / kPi);
constexpr float kFourOverPi = static_cast<float>(4.0 / kPi);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kNegTwoPi = static_cast<float>(-2.0 * kPi);
constexpr float kPwLo = static_cast<float>(0.0001), kPwHi = static_cast<float>(0.9999);
constexpr float kBig = static_cast<float>(3.4e38);
// the degree-9 sine polynomial (core/dsp.py SIN9_C)
constexpr float kS1 = static_cast<float>(-0.16666652), kS2 = static_cast<float>(0.008332964),
                kS3 = static_cast<float>(-0.00019804752),
                kS4 = static_cast<float>(2.5981028e-06);
// PolyBlep's u32 phase: 2^30 units a cycle, t from the top 24 bits
constexpr uint32_t kPhaseMask = (1u << 30) - 1u;
constexpr float kTScale = 1.0f / 16777216.0f;
// EnvAsr stages (envelopes.rs AsrState)
constexpr int kStopped = 0, kAttacking = 1, kSustaining = 2, kReleasing = 3;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

struct Frame {
  const float* planes;
  const float* rows;
  float* slots;
  float* carry;
  float* scratch;
  int K, B, k;
};

__device__ __forceinline__ float fetch(const Frame& f, int kind, int idx, int t) {
  switch (kind) {
    case kSrcSlot: return f.slots[idx * f.B + t];
    case kSrcCarry: return f.carry[idx * f.B + t];
    case kSrcRow: return f.rows[idx * f.B + t];
    default: return f.planes[(static_cast<size_t>(idx) * f.K + f.k) * f.B + t];
  }
}

// input channel c of a record: its sources summed left to right
__device__ __forceinline__ float input(const Frame& f, const int* prog, int in_tab,
                                       int c, int t) {
  const int start = prog[in_tab + 2 * c], count = prog[in_tab + 2 * c + 1];
  if (count == 0) return 0.0f;
  float acc = fetch(f, prog[start], prog[start + 1], t);
  for (int i = 1; i < count; ++i)
    acc = add(acc, fetch(f, prog[start + 2 * i], prog[start + 2 * i + 1], t));
  return acc;
}

__device__ __forceinline__ float param(const Frame& f, const int* prog, int par_tab,
                                       int i, int t) {
  return fetch(f, prog[par_tab + 2 * i], prog[par_tab + 2 * i + 1], t);
}

__device__ __forceinline__ void emit(const Frame& f, const int* prog, int out_tab,
                                     int c, int t, float v, float* __restrict__ out) {
  f.slots[prog[out_tab + 2 * c] * f.B + t] = v;
  const int plane = prog[out_tab + 2 * c + 1];
  if (plane >= 0) out[(static_cast<size_t>(plane) * f.K + f.k) * f.B + t] = v;
}

__device__ __forceinline__ float binop(int op, float a, float b) {
  switch (op) {
    case kAdd: return add(a, b);
    case kSub: return sub(a, b);
    case kMul: return mul(a, b);
    default: return fdiv(a, b);
  }
}

__device__ __forceinline__ float unop(int op, float x) {
  switch (op) {
    case kCeil: return ceilf(x);
    case kFloor: return floorf(x);
    case kSqrt: return __fsqrt_rn(x);
    case kExp: return expf(x);
    case kAbs: return fabsf(x);
    case kNeg: return -x;
    case kLog: return logf(x);
    case kSin: return sinf(x);
    case kCos: return cosf(x);
    default: return tanhf(x);
  }
}

// ---------------------------------------------------------------------------
// PolyBlep (ugens/polyblep.py): the 14 waveforms of (t, dt, pulse width)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float frac(float t) { return sub(t, truncf(t)); }
__device__ __forceinline__ float sel(bool c, float a, float b) { return c ? a : b; }

__device__ float blep(float t, float dt) {
  const float a = sub(fdiv(t, dt), 1.0f);
  const float b = add(fdiv(sub(t, 1.0f), dt), 1.0f);
  return sel(t < dt, -mul(a, a), sel(t > sub(1.0f, dt), mul(b, b), 0.0f));
}

__device__ float blamp(float t, float dt) {
  const float ta = sub(fdiv(t, dt), 1.0f);
  const float a = mul(mul(mul(-kThird, ta), ta), ta);
  const float tb = add(fdiv(sub(t, 1.0f), dt), 1.0f);
  const float b = mul(mul(mul(kThird, tb), tb), tb);
  return sel(t < dt, a, sel(t > sub(1.0f, dt), b, 0.0f));
}

// y = 4t folded into the triangle: y - 4 from 3 up, 2 - y above 1
__device__ __forceinline__ float fold4(float y) {
  return sel(y >= 3.0f, sub(y, 4.0f), sel(y > 1.0f, sub(2.0f, y), y));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ float polyblep_wave(int w, float t, float dt, float pw) {
  switch (w) {
    case 0: {  // Sawtooth
      const float u = frac(add(t, 0.5f));
      return sub(sub(mul(2.0f, u), 1.0f), blep(u, dt));
    }
    case 1: return sinf(mul(t, kTau));  // Sine
    case 2: return cosf(mul(t, kTau));  // Cosine
    case 3: {  // Triangle
      const float t1 = frac(add(t, 0.25f)), t2 = frac(add(t, 0.75f));
      const float y = fold4(mul(t, 4.0f));
      return add(y, mul(mul(4.0f, dt), sub(blamp(t1, dt), blamp(t2, dt))));
    }
    case 4: {  // Square
      const float t2 = frac(add(t, 0.5f));
      return sub(add(sel(t < 0.5f, 1.0f, -1.0f), blep(t, dt)), blep(t2, dt));
    }
    case 5: {  // Rectangle
      const float t2 = frac(sub(add(t, 1.0f), pw));
      const float y = add(mul(-2.0f, pw), sel(t < pw, 2.0f, 0.0f));
      return sub(add(y, blep(t, dt)), blep(t2, dt));
    }
    case 6: {  // Ramp
      const float u = frac(t);
      return add(sub(1.0f, mul(2.0f, u)), blep(u, dt));
    }
    case 7: {  // ModifiedTriangle
      const float p = clampf(pw, kPwLo, kPwHi);
      const float t1 = frac(add(t, mul(0.5f, p)));
      const float t2 = frac(sub(add(t, 1.0f), mul(0.5f, p)));
      const float y2 = mul(t, 2.0f);
      const float y = sel(y2 >= sub(2.0f, p), fdiv(sub(y2, 2.0f), p),
                          sel(y2 >= p, sub(1.0f, fdiv(sub(y2, p), sub(1.0f, p))),
                              fdiv(y2, p)));
      return add(y, mul(fdiv(dt, sub(p, mul(p, p))), sub(blamp(t1, dt), blamp(t2, dt))));
    }
    case 8: {  // ModifiedSquare
      const float q = mul(0.25f, sub(pw, 0.5f));
      float t1 = frac(add(add(t, 0.875f), q));
      float t2 = frac(add(add(t, 0.375f), q));
      float y = sub(add(sel(t1 < 0.5f, 1.0f, -1.0f), blep(t1, dt)), blep(t2, dt));
      const float h = mul(0.5f, sub(1.0f, pw));
      t1 = frac(add(t1, h));
      t2 = frac(add(t2, h));
      y = sub(add(add(y, sel(t1 < 0.5f, 1.0f, -1.0f)), blep(t1, dt)), blep(t2, dt));
      return mul(0.5f, y);
    }
    case 9: {  // HalfWaveRectifiedSine
      const float t2 = frac(add(t, 0.5f));
      const float y = sel(t < 0.5f, sub(mul(2.0f, sinf(mul(t, kTau))), kTwoOverPi),
                          -kTwoOverPi);
      return add(y, mul(mul(kTau, dt), add(blamp(t, dt), blamp(t2, dt))));
    }
    case 10: {  // FullWaveRectifiedSine
      const float u = frac(add(t, 0.25f));
      const float y = sub(mul(2.0f, sinf(mul(u, kPiF))), kFourOverPi);
      return add(y, mul(mul(kTau, dt), blamp(u, dt)));
    }
    case 11: {  // TriangularPulse
      const float t1 = frac(add(add(t, 0.75f), mul(0.5f, pw)));
      const float y1 = mul(4.0f, t1);
      const float y = sel(t1 >= pw, -pw,
                          sel(y1 >= mul(2.0f, pw), sub(sub(4.0f, fdiv(y1, pw)), pw),
                              sub(fdiv(y1, pw), pw)));
      const float t2 = frac(sub(add(t1, 1.0f), mul(0.5f, pw)));
      const float t3 = frac(sub(add(t1, 1.0f), pw));
      const float corr = mul(fdiv(mul(2.0f, dt), pw),
                             add(sub(blamp(t1, dt), mul(2.0f, blamp(t2, dt))),
                                 blamp(t3, dt)));
      return sel(pw > 0.0f, add(y, corr), y);
    }
    case 12: {  // TrapezoidFixed
      float y = clampf(mul(2.0f, fold4(mul(4.0f, t))), -1.0f, 1.0f);
      float t1 = frac(add(t, 0.125f));
      float t2 = frac(add(t1, 0.5f));
      y = add(y, mul(mul(4.0f, dt), sub(blamp(t1, dt), blamp(t2, dt))));
      t1 = frac(add(t, 0.375f));
      t2 = frac(add(t1, 0.5f));
      return add(y, mul(mul(4.0f, dt), sub(blamp(t1, dt), blamp(t2, dt))));
    }
    default: {  // TrapezoidVariable
      const float p = fminf(pw, kPwHi);
      const float scale = fdiv(1.0f, sub(1.0f, p));
      const float s2dt = mul(mul(scale, 2.0f), dt);
      float y = clampf(mul(scale, fold4(mul(4.0f, t))), -1.0f, 1.0f);
      float t1 = frac(sub(add(t, 0.25f), mul(0.25f, p)));
      float t2 = frac(add(t1, 0.5f));
      y = add(y, mul(s2dt, sub(blamp(t1, dt), blamp(t2, dt))));
      t1 = frac(add(add(t, 0.25f), mul(0.25f, p)));
      t2 = frac(add(t1, 0.5f));
      return add(y, mul(s2dt, sub(blamp(t1, dt), blamp(t2, dt))));
    }
  }
}

// ---------------------------------------------------------------------------
// SvfFilter (ugens/filters.py svf_coefficients)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sin_poly(float u) {
  const float u2 = mul(u, u);
  float p = add(mul(kS4, u2), kS3);
  p = add(mul(p, u2), kS2);
  p = add(mul(p, u2), kS1);
  return mul(add(mul(p, u2), 1.0f), u);
}

// tan on [0, pi/2) as sin / sin(pi/2 - x) by the polynomial (core/dsp.py)
__device__ __forceinline__ float tan_first_quadrant(float x) {
  return fdiv(sin_poly(x), sin_poly(sub(kHalfPi, x)));
}

struct SvfCoefs {
  float a1, a2, a3, m0, m1, m2;
};

// ty: the filter type as a float (SvfFilterType: Low 0, High 1, Band 2,
// Notch 3, Peak 4, All 5, Bell 6, LowShelf 7, HighShelf 8; any other value
// takes the defaults, as the chained wheres do)
__device__ SvfCoefs svf_coefs(float ty, float cutoff, float q, float gain, float sr) {
  const float amp = powf(10.0f, fdiv(gain, 40.0f));
  const float sqrt_amp = __fsqrt_rn(amp);
  const bool bell = ty == 6.0f, ls = ty == 7.0f, hs = ty == 8.0f;
  const float g_base = tan_first_quadrant(fdiv(mul(kPiF, cutoff), sr));
  const float g = (bell || ls) ? fdiv(g_base, sqrt_amp) : (hs ? mul(g_base, sqrt_amp) : g_base);
  const float k = bell ? fdiv(1.0f, mul(q, amp)) : fdiv(1.0f, q);
  SvfCoefs c;
  c.a1 = fdiv(1.0f, add(1.0f, mul(g, add(g, k))));
  c.a2 = mul(g, c.a1);
  c.a3 = mul(g, c.a2);
  const float amp2 = mul(amp, amp);
  c.m0 = (ty == 0.0f || ty == 2.0f) ? 0.0f : (hs ? amp2 : 1.0f);
  c.m1 = ty == 0.0f ? 0.0f
       : ty == 2.0f ? 1.0f
       : (ty == 3.0f || ty == 1.0f || ty == 4.0f) ? -k
       : ty == 5.0f ? mul(-2.0f, k)
       : bell ? mul(k, sub(amp2, 1.0f))
       : ls ? mul(k, sub(amp, 1.0f))
       : hs ? mul(mul(k, sub(1.0f, amp)), amp)
       : 0.0f;
  c.m2 = ty == 0.0f ? 1.0f
       : ty == 1.0f ? -1.0f
       : ty == 4.0f ? -2.0f
       : ls ? sub(amp2, 1.0f)
       : hs ? sub(1.0f, amp2)
       : 0.0f;
  return c;
}

// ---------------------------------------------------------------------------
// Hillis-Steele block scans over shared scratch rows (core/dsp.py): at step
// s, lane t combines with lane t - s, or with the identity where t < s.
// Rows r of ping-pong buffer b live at scratch + (b * n + r) * B; each
// returns the buffer that holds the result. The caller has written buffer
// 0 and synchronised.
// ---------------------------------------------------------------------------

__device__ int scan_affine_1d(float* sc, int B) {  // rows A, C
  int cur = 0;
  for (int s = 1; s < B; s <<= 1) {
    const float* A = sc + (cur * 2) * B;
    const float* C = A + B;
    float* nA = sc + ((cur ^ 1) * 2) * B;
    float* nC = nA + B;
    for (int t = threadIdx.x; t < B; t += blockDim.x) {
      const bool has = t >= s;
      const float al = has ? A[t - s] : 1.0f, cl = has ? C[t - s] : 0.0f;
      nC[t] = add(mul(A[t], cl), C[t]);
      nA[t] = mul(al, A[t]);
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

__device__ int scan_affine_2x2(float* sc, int B) {  // rows A00 A01 A10 A11 C0 C1
  int cur = 0;
  for (int s = 1; s < B; s <<= 1) {
    const float* r = sc + (cur * 6) * B;
    float* n = sc + ((cur ^ 1) * 6) * B;
    for (int t = threadIdx.x; t < B; t += blockDim.x) {
      const bool has = t >= s;
      const int u = t - s;
      const float l00 = has ? r[u] : 1.0f, l01 = has ? r[B + u] : 0.0f,
                  l10 = has ? r[2 * B + u] : 0.0f, l11 = has ? r[3 * B + u] : 1.0f,
                  lc0 = has ? r[4 * B + u] : 0.0f, lc1 = has ? r[5 * B + u] : 0.0f;
      const float a00 = r[t], a01 = r[B + t], a10 = r[2 * B + t], a11 = r[3 * B + t],
                  c0 = r[4 * B + t], c1 = r[5 * B + t];
      n[t] = add(mul(a00, l00), mul(a01, l10));
      n[B + t] = add(mul(a00, l01), mul(a01, l11));
      n[2 * B + t] = add(mul(a10, l00), mul(a11, l10));
      n[3 * B + t] = add(mul(a10, l01), mul(a11, l11));
      n[4 * B + t] = add(add(mul(a00, lc0), mul(a01, lc1)), c0);
      n[5 * B + t] = add(add(mul(a10, lc0), mul(a11, lc1)), c1);
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

__device__ int scan_cumsum_2(float* sc, int B) {  // two rows, x + x[t - s]
  int cur = 0;
  for (int s = 1; s < B; s <<= 1) {
    const float* r = sc + (cur * 2) * B;
    float* n = sc + ((cur ^ 1) * 2) * B;
    for (int t = threadIdx.x; t < B; t += blockDim.x) {
      const bool has = t >= s;
      n[t] = add(r[t], has ? r[t - s] : 0.0f);
      n[B + t] = add(r[B + t], has ? r[B + t - s] : 0.0f);
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

// The inclusive prefix sum x[0, n) -> r[0, n) in the association of
// core/dsp.py cumsum_base16 (jnp.cumsum on XLA's CPU backend), step for
// step: rows of 16, the last one padded with zeros, summed left to right
// from 0; the row totals scanned the same way, level by level, until a
// level is one row; then, level by level downwards, each lane's in-row sum
// plus the scanned total of the rows before its own (0 for the first).
// `work` holds every upper level's totals and scans: 2 * (ceil(n/16) +
// ceil(n/256) + ...) floats, at most n for n > 16. Every thread of the
// block calls it after x is written and synchronised; r is complete and
// synchronised when it returns.
constexpr int kScanBase = 16;
constexpr int kMaxLevels = 8;  // n up to 16^8

__device__ void scan_sum_base16(const float* x, float* r, float* work, int n) {
  int size[kMaxLevels];
  const float* in[kMaxLevels];
  float* res[kMaxLevels];
  size[0] = n;
  in[0] = x;
  res[0] = r;
  int top = 0;
  while (size[top] > kScanBase) {
    const int rows = (size[top] + kScanBase - 1) / kScanBase;
    float* tot = work;
    res[top + 1] = work + rows;
    work += 2 * rows;
    const float* v = in[top];
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const int c0 = i * kScanBase;
      float acc = add(0.0f, v[c0]);
      for (int c = c0 + 1; c < c0 + kScanBase; ++c)
        acc = add(acc, c < size[top] ? v[c] : 0.0f);
      tot[i] = acc;
    }
    __syncthreads();
    ++top;
    size[top] = rows;
    in[top] = tot;
  }
  if (threadIdx.x == 0) {  // the top level: one row
    float acc = add(0.0f, in[top][0]);
    res[top][0] = acc;
    for (int i = 1; i < size[top]; ++i) {
      acc = add(acc, in[top][i]);
      res[top][i] = acc;
    }
  }
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    const float* v = in[l];
    for (int i = threadIdx.x; i < size[l]; i += blockDim.x) {
      const int row = i / kScanBase, c0 = row * kScanBase;
      float acc = add(0.0f, v[c0]);
      for (int c = c0 + 1; c <= i; ++c) acc = add(acc, v[c]);
      res[l][i] = add(acc, row > 0 ? res[l + 1][row - 1] : 0.0f);
    }
    __syncthreads();
  }
}

// the minimum of one float per thread over the block; `red` is 32 words of
// shared memory. Every thread of the block must call it.
__device__ float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, d));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : kBig;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) w = fminf(w, __shfl_xor_sync(0xffffffffu, w, d));
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// the envelopes' rate from a time: 1/(t*sr), t == 0 instant
__device__ __forceinline__ float rate_from_time(float seconds, float sr) {
  return seconds == 0.0f ? 1.0f : fdiv(1.0f, mul(seconds, sr));
}

__device__ __forceinline__ float word_f(uint32_t w) { return __uint_as_float(w); }
__device__ __forceinline__ uint32_t f_word(float x) { return __float_as_uint(x); }

// What a stage body reads and writes besides the frame: the program, the
// state words, the outputs, the shared scan scratch and the constants.
struct Io {
  const int* prog;
  const uint32_t* state;
  uint32_t* state_out;
  float* out;
  uint32_t* scan32;  // 32 words of shared memory (block_scan_u32)
  float* red;        // 32 words of shared memory (block_min)
  float f2pi, scale, sr;
};

// One record of the program, decoded.
struct Rec {
  int arg, n_out, srow, in_tab, par_tab, out_tab;
  uint8_t* done_row;  // this stage's done row, or null
};

// The bodies of the subtractive slice; every thread of the block calls them.

__device__ void body_polyblep(const Frame& f, const Io& io, const Rec& rc) {
  // params: waveform, freq, pulse_width; the phase as SinWt's, in 2^30
  // units a cycle (f2pi is the same constant); the waveform from sample 0
  const int K = f.K, B = f.B, k = f.k, tid = threadIdx.x;
  const uint32_t ph0 = io.state[rc.srow * K + k];
  const float wv = param(f, io.prog, rc.par_tab, 0, 0);
  const int w = wv <= 0.0f ? 0 : (wv >= 13.0f ? 13 : static_cast<int>(wv));
  const float quarter = mul(io.sr, 0.25f);
  uint32_t running = 0u;
  for (int t0 = 0; t0 < B; t0 += blockDim.x) {
    const int t = t0 + tid;
    const bool live = t < B;
    uint32_t inc = 0u;
    float freq = 0.0f, pw = 0.0f;
    if (live) {
      freq = param(f, io.prog, rc.par_tab, 1, t);
      pw = param(f, io.prog, rc.par_tab, 2, t);
      inc = inc_u32(mul(freq, io.f2pi));
    }
    uint32_t total;
    const uint32_t incl = block_scan_u32(inc, io.scan32, &total);
    if (live) {
      const uint32_t ph = ph0 + running + incl - inc;
      const float tt = mul(static_cast<float>(static_cast<int>((ph & kPhaseMask) >> 6)), kTScale);
      float y = polyblep_wave(w, tt, fdiv(freq, io.sr), pw);
      if (freq >= quarter) y = sinf(mul(tt, kTau));
      emit(f, io.prog, rc.out_tab, 0, t, y, io.out);
    }
    running += total;
  }
  if (tid == 0) io.state_out[rc.srow * K + k] = ph0 + running;
}

__device__ void body_svf(const Frame& f, const Io& io, const Rec& rc) {
  // params: filter, cutoff_freq, q, gain; words ic0, ic1
  const int K = f.K, B = f.B, k = f.k, tid = threadIdx.x;
  const int* prog = io.prog;
  const float ic0 = word_f(io.state[rc.srow * K + k]);
  const float ic1 = word_f(io.state[(rc.srow + 1) * K + k]);
  float* sc = f.scratch;
  __syncthreads();  // the previous body's scratch reads are done
  for (int t = tid; t < B; t += blockDim.x) {
    const SvfCoefs c = svf_coefs(param(f, prog, rc.par_tab, 0, t),
                                 param(f, prog, rc.par_tab, 1, t),
                                 param(f, prog, rc.par_tab, 2, t),
                                 param(f, prog, rc.par_tab, 3, t), io.sr);
    const float x = input(f, prog, rc.in_tab, 0, t);
    sc[t] = sub(mul(2.0f, c.a1), 1.0f);
    sc[B + t] = mul(-2.0f, c.a2);
    sc[2 * B + t] = mul(2.0f, c.a2);
    sc[3 * B + t] = sub(1.0f, mul(2.0f, c.a3));
    sc[4 * B + t] = mul(mul(2.0f, c.a2), x);
    sc[5 * B + t] = mul(mul(2.0f, c.a3), x);
  }
  __syncthreads();
  const float* m = sc + scan_affine_2x2(sc, B) * 6 * B;
  for (int t = tid; t < B; t += blockDim.x) {
    const SvfCoefs c = svf_coefs(param(f, prog, rc.par_tab, 0, t),
                                 param(f, prog, rc.par_tab, 1, t),
                                 param(f, prog, rc.par_tab, 2, t),
                                 param(f, prog, rc.par_tab, 3, t), io.sr);
    const float x = input(f, prog, rc.in_tab, 0, t);
    float s0 = ic0, s1 = ic1;
    if (t > 0) {
      const int u = t - 1;
      s0 = add(add(mul(m[u], ic0), mul(m[B + u], ic1)), m[4 * B + u]);
      s1 = add(add(mul(m[2 * B + u], ic0), mul(m[3 * B + u], ic1)), m[5 * B + u]);
    }
    const float v3 = sub(x, s1);
    const float v1 = add(mul(c.a1, s0), mul(c.a2, v3));
    const float v2 = add(add(s1, mul(c.a2, s0)), mul(c.a3, v3));
    emit(f, prog, rc.out_tab, 0, t, add(add(mul(c.m0, x), mul(c.m1, v1)), mul(c.m2, v2)),
         io.out);
    if (t == B - 1) {
      io.state_out[rc.srow * K + k] =
          f_word(add(add(mul(m[t], ic0), mul(m[B + t], ic1)), m[4 * B + t]));
      io.state_out[(rc.srow + 1) * K + k] =
          f_word(add(add(mul(m[2 * B + t], ic0), mul(m[3 * B + t], ic1)), m[5 * B + t]));
    }
  }
}

__device__ void body_onepole(const Frame& f, const Io& io, const Rec& rc,
                                          bool highpass) {
  // y[t] = b1*y[t-1] + a0*x[t]; the highpass outputs x - y
  const int K = f.K, B = f.B, k = f.k, tid = threadIdx.x;
  const int* prog = io.prog;
  const float last = word_f(io.state[rc.srow * K + k]);
  float* sc = f.scratch;
  __syncthreads();
  for (int t = tid; t < B; t += blockDim.x) {
    const float b1 = expf(mul(kNegTwoPi, fdiv(param(f, prog, rc.par_tab, 0, t), io.sr)));
    sc[t] = b1;
    sc[B + t] = mul(sub(1.0f, b1), input(f, prog, rc.in_tab, 0, t));
  }
  __syncthreads();
  const float* m = sc + scan_affine_1d(sc, B) * 2 * B;
  for (int t = tid; t < B; t += blockDim.x) {
    const float b1 = expf(mul(kNegTwoPi, fdiv(param(f, prog, rc.par_tab, 0, t), io.sr)));
    const float x = input(f, prog, rc.in_tab, 0, t);
    const float pre = t > 0 ? add(mul(m[t - 1], last), m[B + t - 1]) : last;
    const float y = add(mul(b1, pre), mul(sub(1.0f, b1), x));
    emit(f, prog, rc.out_tab, 0, t, highpass ? sub(x, y) : y, io.out);
    if (t == B - 1) io.state_out[rc.srow * K + k] = f_word(add(mul(m[t], last), m[B + t]));
  }
}

__device__ void body_env(const Frame& f, const Io& io, const Rec& rc, bool ar) {
  // the event-free closed forms (ugens/envelopes.py); params attack_time,
  // release_time; words release_scale, stage, t
  const int K = f.K, B = f.B, k = f.k, tid = threadIdx.x, srow = rc.srow;
  const int* prog = io.prog;
  const float rs = word_f(io.state[srow * K + k]);
  const int stage0 = static_cast<int>(io.state[(srow + 1) * K + k]);
  const float t0 = word_f(io.state[(srow + 2) * K + k]);
  float* sc = f.scratch;
  __syncthreads();
  for (int t = tid; t < B; t += blockDim.x) {
    sc[t] = rate_from_time(param(f, prog, rc.par_tab, 0, t), io.sr);
    sc[B + t] = rate_from_time(param(f, prog, rc.par_tab, 1, t), io.sr);
  }
  __syncthreads();
  const float* A = sc + scan_cumsum_2(sc, B) * 2 * B;
  const float* R = A + B;
  const float inc_atk_last = add(t0, A[B - 1]);
  const bool atk_any = inc_atk_last >= 1.0f;
  const float inc_rel_last = sub(t0, R[B - 1]);
  const bool rel_done = inc_rel_last <= 0.0f;
  const float t_rel = rel_done ? 0.0f : inc_rel_last;
  const int st_rel = rel_done ? kStopped : kReleasing;
  float t_fin, rs_fin = rs;
  int st_fin;
  if (!ar) {
    for (int t = tid; t < B; t += blockDim.x) {
      const float e_atk = add(t0, t > 0 ? A[t - 1] : 0.0f);
      const float e_rel = sub(t0, t > 0 ? R[t - 1] : 0.0f);
      const bool alive = t == 0 || e_rel > 0.0f;
      const bool done_rel = alive && sub(t0, R[t]) <= 0.0f;
      const float out_rel = alive ? mul(mul(mul(e_rel, e_rel), e_rel), rs) : 0.0f;
      const float y = stage0 == kAttacking ? (e_atk >= 1.0f ? 1.0f : e_atk)
                    : stage0 == kSustaining ? 1.0f
                    : stage0 == kReleasing ? out_rel : 0.0f;
      emit(f, prog, rc.out_tab, 0, t, y, io.out);
      if (rc.done_row) rc.done_row[t] = stage0 == kReleasing && done_rel;
    }
    t_fin = stage0 == kAttacking ? (atk_any ? 1.0f : inc_atk_last)
          : stage0 == kReleasing ? t_rel : t0;
    st_fin = stage0 == kAttacking ? (atk_any ? kSustaining : kAttacking)
           : stage0 == kReleasing ? st_rel : stage0;
  } else {
    // EnvAr: R at the first crossed lane, the minimum of R there (atk_any
    // is the same in every thread: all or none reduce)
    float lmin = kBig;
    for (int t = tid; t < B; t += blockDim.x)
      if (add(t0, A[t]) >= 1.0f) lmin = fminf(lmin, R[t]);
    const float Rk = atk_any ? block_min(lmin, io.red) : 0.0f;
    for (int t = tid; t < B; t += blockDim.x) {
      const float Rex = t > 0 ? R[t - 1] : 0.0f;
      const float e_atk = add(t0, t > 0 ? A[t - 1] : 0.0f);
      const bool in_rel2 = e_atk >= 1.0f;
      const float t_rel2 = sub(1.0f, sub(Rex, Rk));
      const bool alive2 = t_rel2 > 0.0f;
      const float out_a = in_rel2 ? (alive2 ? mul(mul(t_rel2, t_rel2), t_rel2) : 0.0f) : e_atk;
      const bool done_a = in_rel2 && alive2 && sub(1.0f, sub(R[t], Rk)) <= 0.0f;
      const float e_rel = sub(t0, Rex);
      const bool alive = t == 0 || e_rel > 0.0f;
      const bool done_r = alive && sub(t0, R[t]) <= 0.0f;
      const float out_r = alive ? mul(mul(mul(e_rel, e_rel), e_rel), rs) : 0.0f;
      const float y = stage0 == kAttacking ? out_a : stage0 == kReleasing ? out_r : 0.0f;
      emit(f, prog, rc.out_tab, 0, t, y, io.out);
      if (rc.done_row)
        rc.done_row[t] = (stage0 == kAttacking && done_a) || (stage0 == kReleasing && done_r);
    }
    const float t_after = sub(1.0f, sub(R[B - 1], Rk));
    const bool a_done = atk_any && t_after <= 0.0f;
    const float t_a = a_done ? 0.0f : (atk_any ? t_after : inc_atk_last);
    const int st_a = a_done ? kStopped : (atk_any ? kReleasing : kAttacking);
    t_fin = stage0 == kAttacking ? t_a : stage0 == kReleasing ? t_rel : t0;
    st_fin = stage0 == kAttacking ? st_a : stage0 == kReleasing ? st_rel : stage0;
    if (stage0 == kAttacking && atk_any) rs_fin = 1.0f;
  }
  if (tid == (B - 1) % blockDim.x) {
    io.state_out[srow * K + k] = f_word(rs_fin);
    io.state_out[(srow + 1) * K + k] = static_cast<uint32_t>(st_fin);
    io.state_out[(srow + 2) * K + k] = f_word(t_fin);
  }
}

__device__ void body_pan2(const Frame& f, const Io& io, const Rec& rc) {
  for (int t = threadIdx.x; t < f.B; t += blockDim.x) {
    const float x = input(f, io.prog, rc.in_tab, 0, t);
    const float angle =
        mul(add(mul(param(f, io.prog, rc.par_tab, 0, t), 0.5f), 0.5f), kHalfPi);
    emit(f, io.prog, rc.out_tab, 0, t, mul(x, cosf(angle)), io.out);
    emit(f, io.prog, rc.out_tab, 1, t, mul(x, sinf(angle)), io.out);
  }
}

// SinNumeric (the fast program's no-reset path) and Phasor (ugens/osc.py):
// the f32 phase in cycles, phase_t = ph0 + sum(inc[0:t]) with inc = freq *
// (1 / sr) summed over the whole block by scan_sum_base16, wrapped only at
// the block's end. Params: freq (, phase_offset); word: the phase.
__device__ void body_float_osc(const Frame& f, const Io& io, const Rec& rc, bool phasor) {
  const int K = f.K, B = f.B, k = f.k, tid = threadIdx.x;
  const float ph0 = word_f(io.state[rc.srow * K + k]);
  const float inv_sr = fdiv(1.0f, io.sr);
  float* inc = f.scratch;
  float* csum = inc + B;
  __syncthreads();  // the previous body's scratch reads are done
  for (int t = tid; t < B; t += blockDim.x)
    inc[t] = mul(param(f, io.prog, rc.par_tab, 0, t), inv_sr);
  __syncthreads();
  scan_sum_base16(inc, csum, csum + B, B);
  for (int t = tid; t < B; t += blockDim.x) {
    const float ph = add(ph0, t > 0 ? csum[t - 1] : 0.0f);
    const float y = phasor ? sub(ph, floorf(ph))
                           : sinf(mul(add(ph, param(f, io.prog, rc.par_tab, 1, t)), kTau));
    emit(f, io.prog, rc.out_tab, 0, t, y, io.out);
  }
  if (tid == 0) {
    const float c = add(ph0, csum[B - 1]);
    io.state_out[rc.srow * K + k] = f_word(sub(c, floorf(c)));
  }
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key (k0, k1),
// in place (jax.random's threefry2x32; knaster_tpu_torch/ugens/noise.py).
constexpr uint32_t kThreefryParity = 0x1BD11BDAu;

__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = (x1 << r) | (x1 >> (32 - r));
  x1 ^= x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kThreefryParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      threefry_mix(x0, x1, 13); threefry_mix(x0, x1, 15);
      threefry_mix(x0, x1, 26); threefry_mix(x0, x1, 6);
    } else {
      threefry_mix(x0, x1, 17); threefry_mix(x0, x1, 29);
      threefry_mix(x0, x1, 16); threefry_mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// WhiteNoise (ugens/noise.py): words frame, seed (the sorted state names).
// Sample t: the key fold_in(PRNGKey(seed), frame + t) = Threefry of the
// counter (0, frame + t) under (0, seed); one 32-bit draw = the XOR of the
// key's Threefry of the counter (0, 0); its top 23 bits under 1.0's
// exponent, minus 1, mapped to (-1, 1).
__device__ void body_white_noise(const Frame& f, const Io& io, const Rec& rc) {
  const int K = f.K, k = f.k;
  const uint32_t frame0 = io.state[rc.srow * K + k];
  const uint32_t seed = io.state[(rc.srow + 1) * K + k];
  for (int t = threadIdx.x; t < f.B; t += blockDim.x) {
    uint32_t a = 0u, b = frame0 + static_cast<uint32_t>(t);
    threefry2x32(0u, seed, a, b);
    uint32_t b0 = 0u, b1 = 0u;
    threefry2x32(a, b, b0, b1);
    const float u = sub(__uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u), 1.0f);
    emit(f, io.prog, rc.out_tab, 0, t, sub(mul(u, 2.0f), 1.0f), io.out);
  }
  if (threadIdx.x == 0) {
    io.state_out[rc.srow * K + k] = frame0 + static_cast<uint32_t>(f.B);
    io.state_out[(rc.srow + 1) * K + k] = seed;
  }
}

// SampleDelay (ugens/delay.py sample_delay_block): words the ring buf[0, L)
// and pos; arg = L. Write before read: sample t reads hist[L + t - d], hist
// = [the ring oldest-first from pos | this block's input], d = clip(trunc(
// delay_time * sr), 0, L - 1); at index >= L that is the input at t - d,
// another thread's sample, hence the barrier before. The old ring is read
// from `state` and the new one written whole to `state_out` (slot s takes
// hist[B + (s - pos') mod L], pos' = (pos + B) mod L), so no read sees a
// write; the barrier after keeps the input rows until every thread has
// read them.
__device__ void body_sample_delay(const Frame& f, const Io& io, const Rec& rc) {
  const int K = f.K, B = f.B, k = f.k, L = rc.arg, tid = threadIdx.x;
  const uint32_t* ring = io.state + static_cast<size_t>(rc.srow) * K + k;
  uint32_t* ring_out = io.state_out + static_cast<size_t>(rc.srow) * K + k;
  const int pos = static_cast<int>(ring[static_cast<size_t>(L) * K]);
  const float top = static_cast<float>(L - 1);
  __syncthreads();  // the input rows of every sample are written
  for (int t = tid; t < B; t += blockDim.x) {
    const float x = mul(param(f, io.prog, rc.par_tab, 0, t), io.sr);
    const int m = t - (x > 0.0f ? static_cast<int>(fminf(x, top)) : 0);
    const float v = m >= 0 ? input(f, io.prog, rc.in_tab, 0, m)
                           : word_f(ring[static_cast<size_t>((pos + L + m) % L) * K]);
    emit(f, io.prog, rc.out_tab, 0, t, v, io.out);
  }
  const int new_pos = (pos + B % L) % L;
  for (int s = tid; s < L; s += blockDim.x) {
    const int m = B + (s - new_pos + L) % L;
    ring_out[static_cast<size_t>(s) * K] =
        m >= L ? f_word(input(f, io.prog, rc.in_tab, 0, m - L))
               : ring[static_cast<size_t>((pos + m) % L) * K];
  }
  if (tid == 0) ring_out[static_cast<size_t>(L) * K] = static_cast<uint32_t>(new_pos);
  __syncthreads();
}

// The stage loop of the kernels below. kAllBodies: the program may use a
// body past Math1. kGlobalRows: the slot, carry and scratch rows live in
// the global workspace `ws`, else in dynamic shared memory.
template <bool kAllBodies, bool kGlobalRows>
__device__ __forceinline__ void run_chain(const int* __restrict__ prog,
                                          const float* __restrict__ planes,
                                          const uint32_t* __restrict__ state,
                                          const float* __restrict__ rows,
                                          float* __restrict__ out,
                                          uint32_t* __restrict__ state_out,
                                          uint8_t* __restrict__ done_out, int K, int B,
                                          float f2pi, float scale, float sr, float* ws) {
  __shared__ uint32_t scratch[32];
  __shared__ float red[32];
  const int p = prog[0], n_carry = prog[1], n_slots = prog[2], n_ext = prog[3];
  extern __shared__ float dyn_smem[];
  float* smem = kGlobalRows ? ws : dyn_smem;
  float* carry = smem + static_cast<size_t>(n_slots) * B;
  Frame f{planes, rows, smem, carry, carry + static_cast<size_t>(n_carry) * B, K, B, 0};
  const Io io{prog, state, state_out, out, scratch, red, f2pi, scale, sr};
  const int* carry_src = prog + kHeader;
  const int* records = carry_src + n_carry;
  const int tid = threadIdx.x;

  for (int i = 0; i < n_carry; ++i)
    for (int t = tid; t < B; t += blockDim.x)
      carry[i * B + t] = rows[(n_ext + i) * B + t];

  for (int k = 0; k < K; ++k) {
    f.k = k;
    for (int j = 0; j < p; ++j) {
      const int* r = prog + records[j];
      const int op = r[0], arg = r[1], n_out = r[4], srow = r[5];
      const int in_tab = r[6], par_tab = r[7], out_tab = r[8];
      switch (op) {
        case kOpConstant:
          for (int t = tid; t < B; t += blockDim.x)
            emit(f, prog, out_tab, 0, t, param(f, prog, par_tab, 0, t), out);
          break;
        case kOpMath:
          for (int c = 0; c < n_out; ++c)
            for (int t = tid; t < B; t += blockDim.x)
              emit(f, prog, out_tab, c, t,
                   binop(arg, input(f, prog, in_tab, c, t),
                         input(f, prog, in_tab, c + n_out, t)),
                   out);
          break;
        case kOpMath1:
          for (int c = 0; c < n_out; ++c)
            for (int t = tid; t < B; t += blockDim.x)
              emit(f, prog, out_tab, c, t, unop(arg, input(f, prog, in_tab, c, t)), out);
          break;
        case kOpSinWt: {
          // the fast program's no-reset path: phase_t = ph0 + sum(inc[0:t])
          const uint32_t ph0 = state[srow * K + k];
          uint32_t running = 0u;
          for (int t0 = 0; t0 < B; t0 += blockDim.x) {
            const int t = t0 + tid;
            const bool live = t < B;
            uint32_t inc = 0u;
            float poff = 0.0f;
            if (live) {
              inc = inc_u32(mul(param(f, prog, par_tab, 0, t), f2pi));
              poff = param(f, prog, par_tab, 1, t);
            }
            uint32_t total;
            const uint32_t incl = block_scan_u32(inc, scratch, &total);
            if (live) {
              const uint32_t off = inc_u32(mul(poff, kFractionalPart));
              emit(f, prog, out_tab, 0, t,
                   sin_quant(ph0 + running + incl - inc + off, scale), out);
            }
            running += total;
          }
          if (tid == 0) state_out[srow * K + k] = ph0 + running;
          break;
        }
        default:
          if constexpr (kAllBodies) {
            // a stage's done row is written with its output
            const int done_plane = r[9];
            const Rec rc{arg, n_out, srow, in_tab, par_tab, out_tab,
                         done_plane >= 0
                             ? done_out + (static_cast<size_t>(done_plane) * K + k) * B
                             : nullptr};
            switch (op) {
              case kOpPolyBlep: body_polyblep(f, io, rc); break;
              case kOpSvf: body_svf(f, io, rc); break;
              case kOpLpf: body_onepole(f, io, rc, false); break;
              case kOpHpf: body_onepole(f, io, rc, true); break;
              case kOpEnvAsr: body_env(f, io, rc, false); break;
              case kOpEnvAr: body_env(f, io, rc, true); break;
              case kOpPan2: body_pan2(f, io, rc); break;
              case kOpSinNumeric: body_float_osc(f, io, rc, false); break;
              case kOpPhasor: body_float_osc(f, io, rc, true); break;
              case kOpWhiteNoise: body_white_noise(f, io, rc); break;
              case kOpSampleDelay: body_sample_delay(f, io, rc); break;
              default: break;
            }
          }
      }
    }
    // the stage's carried outputs become the next stage's carry rows
    for (int i = 0; i < n_carry; ++i)
      for (int t = tid; t < B; t += blockDim.x)
        carry[i * B + t] = smem[carry_src[i] * B + t];
  }
}

// Constant, SinWt, Math and Math1 bodies only. No launch bound: with
// __launch_bounds__(1024) this loop ran slower on an H100, and it needs no
// more than 64 registers a thread without one.
template <bool kGlobalRows>
__global__ void chain_kernel_small(const int* __restrict__ prog,
                                   const float* __restrict__ planes,
                                   const uint32_t* __restrict__ state,
                                   const float* __restrict__ rows, float* __restrict__ out,
                                   uint32_t* __restrict__ state_out,
                                   uint8_t* __restrict__ done_out, int K, int B, float f2pi,
                                   float scale, float sr, float* ws) {
  run_chain<false, kGlobalRows>(prog, planes, state, rows, out, state_out, done_out, K, B,
                                f2pi, scale, sr, ws);
}

// Every body. Up to 1024 threads a block (one per sample) allow at most 64
// registers each, which the inlined bodies exceed unbounded.
template <bool kGlobalRows>
__global__ void __launch_bounds__(1024) chain_kernel_all(const int* __restrict__ prog,
                                                         const float* __restrict__ planes,
                                                         const uint32_t* __restrict__ state,
                                                         const float* __restrict__ rows,
                                                         float* __restrict__ out,
                                                         uint32_t* __restrict__ state_out,
                                                         uint8_t* __restrict__ done_out,
                                                         int K, int B, float f2pi,
                                                         float scale, float sr, float* ws) {
  run_chain<true, kGlobalRows>(prog, planes, state, rows, out, state_out, done_out, K, B,
                               f2pi, scale, sr, ws);
}

}  // namespace

extern "C" {

// Runs one chain over one block on `stream`; returns cudaGetLastError().
// row_floats = (n_slots + n_carry + n_scratch) * B, from the program's
// header; all_bodies: nonzero when the program uses a body past Math1;
// workspace: null to keep the rows in dynamic shared memory, else a global
// buffer of row_floats floats that holds them instead.
int ktt_chain_kernel(const int* prog, const float* planes, const uint32_t* state,
                     const float* rows, float* out, uint32_t* state_out, uint8_t* done,
                     int K, int B, int row_floats, int all_bodies, float f2pi, float scale,
                     float sr, float* workspace, void* stream) {
  if (K < 1 || B < 1 || row_floats < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (workspace != nullptr) {
    const auto kernel = all_bodies ? chain_kernel_all<true> : chain_kernel_small<true>;
    kernel<<<1, stage_threads(B), 0, s>>>(prog, planes, state, rows, out, state_out, done,
                                          K, B, f2pi, scale, sr, workspace);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = all_bodies ? chain_kernel_all<false> : chain_kernel_small<false>;
  const size_t smem = static_cast<size_t>(row_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<1, stage_threads(B), smem, s>>>(prog, planes, state, rows, out, state_out, done,
                                           K, B, f2pi, scale, sr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
