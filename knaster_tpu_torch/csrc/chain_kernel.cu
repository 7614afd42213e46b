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
//   [8, 8 + n_carry)            the slot each carry row is taken from (the
//                               previous stage's output)
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
// Design.
// 1. The program is decoded once per launch. The CTA copies it into shared
//    memory and turns every source and output pair into a descriptor (Src):
//    a row pointer, a stride per stage and a stride for odd stages. A slot
//    row, a carry row, an external row, a staged param row and a param
//    plane in device memory are all read as base + k * kstride + (k & 1) *
//    pstride, so the per-sample loops load through pointers resolved once
//    per stage, with no source-kind switch and no program reads from device
//    memory. The (k, j) opcode switch stays uniform across the block. A
//    carried slot has two rows, one per stage parity, and the carry row of
//    stage k is the slot row of stage k - 1: no carry copy between stages.
// 2. Stage k + 1's operands are in flight during stage k. Its param-plane
//    rows (this CTA's samples of each plane the program reads, as many as
//    the host's plan stages) go to a shared double buffer by TMA 1-D bulk
//    copies (cp.async.bulk ... mbarrier::complete_tx) that one thread issues
//    when stage k starts; every thread waits on the stage's mbarrier before
//    its first body. A row that a bulk copy cannot take (an address or a
//    length that is not a multiple of 16 bytes: an odd B, a plane tensor
//    off 16 bytes) is copied by the threads themselves, 4 bytes each, by
//    cp.async into the same buffer. The stage's scalar state words (every
//    body's words but SampleDelay's ring) come the same way, by cp.async.
//    Planes past the plan's staged count are read from device memory.
// 3. Three layouts, chosen by the host before the launch (launch_plan in
//    kernels/chain_kernel.py), each an instantiation of one stage loop:
//    - shared: one CTA holds the slot, carry and scan-scratch rows of all
//      B samples in its shared memory (short blocks);
//    - cluster: a thread-block cluster of C CTAs on neighbouring SMs, each
//      holding a contiguous chunk of B / C samples (a multiple of 32) in
//      its own shared memory, so the cluster holds up to C * 227 KB. The
//      elementwise bodies touch only their own chunk. The cross-sample
//      steps read the neighbours' rows through distributed shared memory
//      (cooperative_groups::this_cluster().map_shared_rank) and take
//      cluster.sync() where the one-CTA layout takes __syncthreads(): the
//      u32 phase scans of SinWt and PolyBlep (a CTA reduction, then one
//      exchange of CTA totals), every Hillis-Steele step (t - s crosses a
//      chunk edge), the base-16 levels (each CTA sums its own rows of 16;
//      the upper levels read the other CTAs' totals), EnvAr's minimum
//      (one exchange of CTA minima) and SampleDelay's read at t - d;
//    - global: one CTA with the rows in a device-memory workspace the host
//      allocates, only for rows past what a cluster's shared memory holds.
//
// Numerics. With --fmad=false every product and sum rounds on its own, as in
// the plain torch versions (knaster_tpu_torch/core/dsp.py and the UGens'
// block functions), so state, outputs and done rows are bit-equal to them
// at every B and in every layout: the Hillis-Steele steps combine lane t
// with lane t - s and the base-16 scan sums rows of 16 samples, both by
// sample index and not by thread or CTA; a minimum is exact in any order and
// the u32 sums wrap exactly in any order. The transcendental calls (sinf,
// cosf, expf, powf) are the libdevice functions torch's CUDA ops call.
// WhiteNoise restates jax.random's Threefry-2x32 (fold_in, then one 32-bit
// draw on the partitionable path) in u32 arithmetic, so its stream is the
// JAX package's bit for bit. SampleDelay's ring is L state words of its
// stage, read from `state` and rewritten whole to `state_out`.
//
// Two body sets, a template on whether the program uses a body past Math1
// (the host reads that from the program's opcodes): a program of Constant,
// SinWt, Math and Math1 bodies only runs chain_kernel_small, whose switch
// holds those four cases and nothing else, since the subtractive slice's
// bodies, compiled into the same switch, made the SinWt/Math stage loop of
// the FM cascade run 19% slower on an H100. chain_kernel_all holds every
// body. Each set has the three layouts, and chain_kernel_all a second
// cluster kernel for CTAs of at most 512 threads (128 registers a thread,
// where the 1024-thread bound of 64 spills): seven kernels.
//
// What bounds it: K * p dependent bodies a launch, each a few instructions
// per sample plus, for the scan bodies, log2(B) barrier-separated steps
// (cluster barriers in the cluster layout); the latency of each body, not
// the card's bandwidth or arithmetic rate, sets the time. The staged
// operands take device-memory round trips off that serial path; a cluster
// divides each body's per-thread samples by C at the price of its barrier
// and DSMEM latency. WhiteNoise is ~240 integer operations a sample with no
// barrier; SampleDelay copies its whole ring from `state` to `state_out`
// each launch (8 L bytes a stage), strided by K words.

#include <cooperative_groups.h>

#include "env_asr.cuh"
#include "scan_base16.cuh"
#include "stage_scan.cuh"
#include "svf_filter.cuh"
#include "threefry.cuh"

namespace cg = cooperative_groups;

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
// PolyBlep's u32 phase: 2^30 units a cycle, t from the top 24 bits
constexpr uint32_t kPhaseMask = (1u << 30) - 1u;
constexpr float kTScale = 1.0f / 16777216.0f;
// EnvAsr stages (envelopes.rs AsrState)
constexpr int kStopped = 0, kAttacking = 1, kSustaining = 2, kReleasing = 3;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }



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
// The launch's frame: descriptors, the async copies, the cluster's exchange
// ---------------------------------------------------------------------------

// the three layouts (kernels/chain_kernel.py LAYOUTS)
constexpr int kLayoutShared = 0, kLayoutCluster = 1, kLayoutGlobal = 2;

// A row of a source or an output at stage k: base + k * kstride + (k & 1) *
// pstride (no row when base is null). Every (kind, index) source pair and
// every (slot, plane) output pair of the program has one, at the pair's
// word offset (an output's plane at the offset after). An input's (start,
// count) pair has its list's first source at its offset and {null, count,
// start} at the offset after, so a one-source input is one lookup.
struct __align__(16) Src {
  float* base;
  int kstride, pstride;
};

__device__ __forceinline__ float* row_at(const Src& s, int k) {
  return s.base == nullptr ? nullptr
                           : s.base + static_cast<ptrdiff_t>(k) * s.kstride +
                                 ((k & 1) ? s.pstride : 0);
}

// the scalar state words of a body (all its words but SampleDelay's ring),
// by opcode: kernels/chain_kernel.py Body.n_words
__device__ __forceinline__ int scalar_words(int op) {
  switch (op) {
    case kOpSinWt: case kOpPolyBlep: case kOpLpf: case kOpHpf: case kOpSinNumeric:
    case kOpPhasor: case kOpSampleDelay: return 1;
    case kOpSvf: case kOpWhiteNoise: return 2;
    case kOpEnvAsr: case kOpEnvAr: return 3;
    default: return 0;
  }
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the phase of parity `parity` to complete; a copy that never
// lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0u;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// one TMA 1-D bulk copy into this CTA's shared memory, completing on `bar`:
// 16-byte aligned addresses, a multiple of 16 bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one 4-byte async copy into shared memory (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ uint32_t dynamic_smem_size() {
  uint32_t v;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

// What a stage body reads and writes besides its record: the descriptors,
// the state (SampleDelay's rings), the scratch rows, and this CTA's place in
// the block.
struct Ctx {
  const Src* desc;  // the descriptors, one per program word
  const uint32_t* state;
  uint32_t* state_out;
  float* scratch;   // the scan-scratch rows, cs floats apart
  uint32_t* scan32;  // 32 words of shared memory (block_scan_u32)
  float* red;        // 32 words of shared memory (block_min)
  float* xch;        // 2 x 32 words: the cluster's exchange slots
  int K, B, k;
  int n;      // this CTA's samples: B / C
  int cs;     // floats from one row to the next: n rounded up to 4
  int c0;     // this CTA's first sample
  int rank;   // this CTA's rank in its cluster (0 outside one)
  int C;      // the cluster's CTAs (1 outside one)
  int xpar;   // the exchange slot the next exchange writes
  float f2pi, scale, sr;
};

// One record of the program at this stage.
struct Rec {
  int op, arg, n_out, srow, in_tab, par_tab, out_tab;
  uint32_t w[3];      // the record's scalar words
  uint8_t* done_row;  // this CTA's samples of its done row, or null
};

// A record's header as decoded once per launch: three 16-byte loads.
struct __align__(16) RecHead {
  int op, arg, n_out, srow;
  int in_tab, par_tab, out_tab, wslot;  // wslot: its first staged word
  int done_plane, n_words, wfirst, pad;  // wfirst: its first word's state row
};

// where the stage loop finds its params and scalar words (the host's
// LaunchPlan.staging): two stages at a time, every stage before the loop,
// or device memory each stage
constexpr int kStageRing = 0, kStageWhole = 1, kStageDirect = 2;

__device__ __forceinline__ bool leader(const Ctx& x) {
  return x.rank == 0 && threadIdx.x == 0;
}

__device__ __forceinline__ const float* src(const Ctx& x, int w) {
  return row_at(x.desc[w], x.k);
}

// input channel c of a record at this CTA's sample i: its sources summed
// left to right
__device__ __forceinline__ float input(const Ctx& x, const Rec& rc, int c, int i) {
  const Src list = x.desc[rc.in_tab + 2 * c + 1];  // {null, count, start}
  if (list.kstride == 0) return 0.0f;
  float acc = src(x, rc.in_tab + 2 * c)[i];
  for (int s = 1; s < list.kstride; ++s) acc = add(acc, src(x, list.pstride + 2 * s)[i]);
  return acc;
}

__device__ __forceinline__ float param(const Ctx& x, const Rec& rc, int n, int i) {
  return src(x, rc.par_tab + 2 * n)[i];
}

__device__ __forceinline__ void emit(const Ctx& x, const Rec& rc, int c, int i, float v) {
  row_at(x.desc[rc.out_tab + 2 * c], x.k)[i] = v;
  float* plane = row_at(x.desc[rc.out_tab + 2 * c + 1], x.k);
  if (plane != nullptr) plane[i] = v;
}

// A shared row of this CTA (its samples c0 .. c0 + n) at the block's sample
// g, from the CTA of the cluster that holds g.
template <bool kCl>
__device__ __forceinline__ float at(const Ctx& x, const float* row, int g) {
  if constexpr (kCl) {
    const int r = g / x.n, i = g - r * x.n;
    if (r == x.rank) return row[i];
    return *cg::this_cluster().map_shared_rank(const_cast<float*>(row) + i, r);
  } else {
    return row[g];
  }
}

// A source row at the block's sample g: shared rows through `at`, device
// rows (based at this CTA's first sample) directly.
template <bool kCl>
__device__ __forceinline__ float src_at(const Ctx& x, const float* p, int g) {
  if constexpr (kCl) {
    if (__isShared(p)) return at<true>(x, p, g);
    return p[g - x.c0];
  } else {
    return p[g];
  }
}

template <bool kCl>
__device__ __forceinline__ float input_at(const Ctx& x, const Rec& rc, int c, int g) {
  const Src list = x.desc[rc.in_tab + 2 * c + 1];  // {null, count, start}
  if (list.kstride == 0) return 0.0f;
  float acc = src_at<kCl>(x, src(x, rc.in_tab + 2 * c), g);
  for (int s = 1; s < list.kstride; ++s)
    acc = add(acc, src_at<kCl>(x, src(x, list.pstride + 2 * s), g));
  return acc;
}

// The barrier over every thread that reads the rows: the cluster's in the
// cluster layout, the block's in the others.
template <bool kCl>
__device__ __forceinline__ void sync_rows() {
  if constexpr (kCl) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The cluster's exchange of one u32 a CTA: the wrap-around sums over the
// CTAs before this one and over all. Every thread of every CTA calls it.
// The slots alternate, so a slot is written again only after the next
// exchange's barrier, which every CTA reaches after its reads of this one.
__device__ void exchange_u32(Ctx& x, uint32_t v, uint32_t* before, uint32_t* all) {
  cg::cluster_group cl = cg::this_cluster();
  uint32_t* slot = reinterpret_cast<uint32_t*>(x.xch) + 32 * x.xpar;
  if (threadIdx.x == 0) slot[0] = v;
  cl.sync();
  uint32_t b = 0u, a = 0u;
  for (int r = 0; r < x.C; ++r) {
    const uint32_t u = *cl.map_shared_rank(slot, r);
    if (r < x.rank) b += u;
    a += u;
  }
  *before = b;
  *all = a;
  x.xpar ^= 1;
}

// the minimum over the cluster of one float a CTA
__device__ float exchange_min(Ctx& x, float v) {
  cg::cluster_group cl = cg::this_cluster();
  float* slot = x.xch + 32 * x.xpar;
  if (threadIdx.x == 0) slot[0] = v;
  cl.sync();
  float m = kBig;
  for (int r = 0; r < x.C; ++r) m = fminf(m, *cl.map_shared_rank(slot, r));
  x.xpar ^= 1;
  return m;
}

// ---------------------------------------------------------------------------
// Hillis-Steele scans over the scratch rows (core/dsp.py): at step s, sample
// t combines with sample t - s, or with the identity where t < s. Row r of
// ping-pong buffer b lives at scratch + (b * n_rows + r) * cs, this CTA's
// samples; each returns the buffer that holds the result. The caller has
// written buffer 0 and synchronised the rows (sync_rows).
// ---------------------------------------------------------------------------

template <bool kCl>
__device__ int scan_affine_1d(const Ctx& x, float* sc) {  // rows A, C
  const int cs = x.cs;
  int cur = 0;
  for (int s = 1; s < x.B; s <<= 1) {
    const float* A = sc + (cur * 2) * cs;
    const float* C = A + cs;
    float* nA = sc + ((cur ^ 1) * 2) * cs;
    float* nC = nA + cs;
    for (int i = threadIdx.x; i < x.n; i += blockDim.x) {
      const int t = x.c0 + i;
      const bool has = t >= s;
      const float al = has ? at<kCl>(x, A, t - s) : 1.0f;
      const float cl = has ? at<kCl>(x, C, t - s) : 0.0f;
      nC[i] = add(mul(A[i], cl), C[i]);
      nA[i] = mul(al, A[i]);
    }
    sync_rows<kCl>();
    cur ^= 1;
  }
  return cur;
}

template <bool kCl>
__device__ int scan_affine_2x2(const Ctx& x, float* sc) {  // rows A00 A01 A10 A11 C0 C1
  const int cs = x.cs;
  int cur = 0;
  for (int s = 1; s < x.B; s <<= 1) {
    const float* r = sc + (cur * 6) * cs;
    float* nn = sc + ((cur ^ 1) * 6) * cs;
    for (int i = threadIdx.x; i < x.n; i += blockDim.x) {
      const int t = x.c0 + i, u = t - s;
      const bool has = t >= s;
      const float l00 = has ? at<kCl>(x, r, u) : 1.0f;
      const float l01 = has ? at<kCl>(x, r + cs, u) : 0.0f;
      const float l10 = has ? at<kCl>(x, r + 2 * cs, u) : 0.0f;
      const float l11 = has ? at<kCl>(x, r + 3 * cs, u) : 1.0f;
      const float lc0 = has ? at<kCl>(x, r + 4 * cs, u) : 0.0f;
      const float lc1 = has ? at<kCl>(x, r + 5 * cs, u) : 0.0f;
      const float a00 = r[i], a01 = r[cs + i], a10 = r[2 * cs + i], a11 = r[3 * cs + i],
                  c0 = r[4 * cs + i], c1 = r[5 * cs + i];
      nn[i] = add(mul(a00, l00), mul(a01, l10));
      nn[cs + i] = add(mul(a00, l01), mul(a01, l11));
      nn[2 * cs + i] = add(mul(a10, l00), mul(a11, l10));
      nn[3 * cs + i] = add(mul(a10, l01), mul(a11, l11));
      nn[4 * cs + i] = add(add(mul(a00, lc0), mul(a01, lc1)), c0);
      nn[5 * cs + i] = add(add(mul(a10, lc0), mul(a11, lc1)), c1);
    }
    sync_rows<kCl>();
    cur ^= 1;
  }
  return cur;
}

template <bool kCl>
__device__ int scan_cumsum_2(const Ctx& x, float* sc) {  // two rows, x + x[t - s]
  const int cs = x.cs;
  int cur = 0;
  for (int s = 1; s < x.B; s <<= 1) {
    const float* r = sc + (cur * 2) * cs;
    float* nn = sc + ((cur ^ 1) * 2) * cs;
    for (int i = threadIdx.x; i < x.n; i += blockDim.x) {
      const int t = x.c0 + i;
      const bool has = t >= s;
      nn[i] = add(r[i], has ? at<kCl>(x, r, t - s) : 0.0f);
      nn[cs + i] = add(r[cs + i], has ? at<kCl>(x, r + cs, t - s) : 0.0f);
    }
    sync_rows<kCl>();
    cur ^= 1;
  }
  return cur;
}

// The inclusive prefix sum in cumsum_base16's association over the whole
// block: csrc/scan_base16.cuh scan_sum_base16, every thread of the CTA.
__device__ void scan_sum_base16(const float* x, float* r, float* work, int n) {
  ktt::scan_sum_base16<float>(x, r, work, n, threadIdx.x, blockDim.x);
}

// scan_sum_base16 over a cluster's block, in the same association: v holds
// this CTA's n samples (whole rows of 16: n is a multiple of 32), r takes
// their prefixes, `work` is this CTA's third scratch row. The level-1
// values (the totals of the rows of 16) stay with the CTAs that summed
// them, n / 16 each; every CTA computes the levels above from the others'
// values (ceil(B / 256) of them), then the level-1 prefixes of its own rows
// and of the row before, then its samples'. Every thread of every CTA calls
// it after v is written and synchronised in the CTA; r is complete and
// synchronised over the cluster when it returns (the CTA after reads its
// r[t - 1] through `at`).
__device__ void scan_sum_base16_cluster(const Ctx& x, const float* v, float* r, float* work) {
  cg::cluster_group cl = cg::this_cluster();
  const int n = x.n, rows_own = n / kScanBase, n1 = x.B / kScanBase;
  const int first = x.rank * rows_own;  // this CTA's first block row
  float* t0 = work;              // this CTA's level-1 values
  float* res1 = t0 + rows_own;   // the level-1 prefixes at rows first - 1 ..
  for (int q = threadIdx.x; q < rows_own; q += blockDim.x) {
    const int c0 = q * kScanBase;
    float acc = add(0.0f, v[c0]);
    for (int c = c0 + 1; c < c0 + kScanBase; ++c) acc = add(acc, v[c]);
    t0[q] = acc;
  }
  cl.sync();
  // the level-1 value of block row g, from the CTA that holds it
  auto level1 = [&](int g) -> float {
    const int rk = g / rows_own, q = g - rk * rows_own;
    return rk == x.rank ? t0[q] : *cl.map_shared_rank(t0 + q, rk);
  };
  if (n1 <= kScanBase) {  // level 1 is the top: one row, left to right
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int g = 0; g < first + rows_own; ++g) {
        acc = g == 0 ? add(0.0f, level1(0)) : add(acc, level1(g));
        if (g >= first - 1) res1[g - first + 1] = acc;
      }
    }
  } else {
    const int n2 = (n1 + kScanBase - 1) / kScanBase;
    float* t1 = res1 + rows_own + 1;  // the level-2 values
    float* r2 = t1 + n2;              // their prefixes, then the upper levels' work
    for (int q = threadIdx.x; q < n2; q += blockDim.x) {
      const int c0 = q * kScanBase;
      float acc = add(0.0f, level1(c0));
      for (int c = c0 + 1; c < c0 + kScanBase; ++c) acc = add(acc, c < n1 ? level1(c) : 0.0f);
      t1[q] = acc;
    }
    __syncthreads();
    scan_sum_base16(t1, r2, r2 + n2, n2);
    for (int q = threadIdx.x; q <= rows_own; q += blockDim.x) {
      const int g = first + q - 1;
      if (g < 0) continue;
      const int row = g / kScanBase, c0 = row * kScanBase;
      float acc = add(0.0f, level1(c0));
      for (int c = c0 + 1; c <= g; ++c) acc = add(acc, level1(c));
      res1[q] = add(acc, row > 0 ? r2[row - 1] : 0.0f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i / kScanBase, c0 = row * kScanBase;
    float acc = add(0.0f, v[c0]);
    for (int c = c0 + 1; c <= i; ++c) acc = add(acc, v[c]);
    r[i] = add(acc, first + row > 0 ? res1[row] : 0.0f);
  }
  cl.sync();  // the other CTAs read r at their samples' t - 1 and at B - 1
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

// ---------------------------------------------------------------------------
// The bodies. Every thread of the CTA (of the cluster, in the cluster
// layout) calls each; i is this CTA's sample, t = c0 + i the block's.
// ---------------------------------------------------------------------------

// SinWt's fast program without resets and PolyBlep's phase: phase_t = ph0 +
// sum(inc[0:t]) in u32. In a cluster each CTA sums its own increments first
// and the exchange gives it the CTAs before; returns (through *base, *all)
// ph0 plus the increments before this CTA's first sample, and ph0 plus all.
template <bool kCl>
__device__ __forceinline__ void phase_base(Ctx& x, const float* freq, uint32_t ph0,
                                           uint32_t* base, uint32_t* all) {
  *base = ph0;
  *all = ph0;
  if constexpr (kCl) {
    uint32_t part = 0u;
    for (int i = threadIdx.x; i < x.n; i += blockDim.x) part += inc_u32(mul(freq[i], x.f2pi));
    uint32_t total, before, sum;
    block_scan_u32(part, x.scan32, &total);
    exchange_u32(x, total, &before, &sum);
    *base = ph0 + before;
    *all = ph0 + sum;
  }
}

template <bool kCl>
__device__ void body_sinwt(Ctx& x, const Rec& rc) {
  const int n = x.n, tid = threadIdx.x;
  const uint32_t ph0 = rc.w[0];
  const float* freq = src(x, rc.par_tab);
  const float* poff = src(x, rc.par_tab + 2);
  uint32_t base, all;
  phase_base<kCl>(x, freq, ph0, &base, &all);
  uint32_t running = 0u;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + tid;
    const bool live = i < n;
    uint32_t inc = 0u;
    float po = 0.0f;
    if (live) {
      inc = inc_u32(mul(freq[i], x.f2pi));
      po = poff[i];
    }
    uint32_t total;
    const uint32_t incl = block_scan_u32(inc, x.scan32, &total);
    if (live) {
      const uint32_t off = inc_u32(mul(po, kFractionalPart));
      emit(x, rc, 0, i, sin_quant(base + running + incl - inc + off, x.scale));
    }
    running += total;
  }
  if (leader(x)) x.state_out[rc.srow * x.K + x.k] = kCl ? all : ph0 + running;
}

template <bool kCl>
__device__ void body_polyblep(Ctx& x, const Rec& rc) {
  // params: waveform, freq, pulse_width; the phase as SinWt's, in 2^30
  // units a cycle (f2pi is the same constant); the waveform from the
  // block's sample 0, read after the exchange, when every CTA has written
  // its rows of this stage up to this body
  const int n = x.n, tid = threadIdx.x;
  const uint32_t ph0 = rc.w[0];
  const float* freq = src(x, rc.par_tab + 2);
  const float* pwr = src(x, rc.par_tab + 4);
  uint32_t base, all;
  phase_base<kCl>(x, freq, ph0, &base, &all);
  const float wv = src_at<kCl>(x, src(x, rc.par_tab), 0);
  const int w = wv <= 0.0f ? 0 : (wv >= 13.0f ? 13 : static_cast<int>(wv));
  const float quarter = mul(x.sr, 0.25f);
  uint32_t running = 0u;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + tid;
    const bool live = i < n;
    uint32_t inc = 0u;
    float f = 0.0f, pw = 0.0f;
    if (live) {
      f = freq[i];
      pw = pwr[i];
      inc = inc_u32(mul(f, x.f2pi));
    }
    uint32_t total;
    const uint32_t incl = block_scan_u32(inc, x.scan32, &total);
    if (live) {
      const uint32_t ph = base + running + incl - inc;
      const float tt = mul(static_cast<float>(static_cast<int>((ph & kPhaseMask) >> 6)), kTScale);
      float y = polyblep_wave(w, tt, fdiv(f, x.sr), pw);
      if (f >= quarter) y = sinf(mul(tt, kTau));
      emit(x, rc, 0, i, y);
    }
    running += total;
  }
  if (leader(x)) x.state_out[rc.srow * x.K + x.k] = kCl ? all : ph0 + running;
}

// sample i's SVF coefficients (csrc/svf_filter.cuh, shared with the SVF
// block kernel) from the params filter (the type as a float: any value but
// 0-8 takes the defaults, as the chained wheres do), cutoff_freq, q, gain
__device__ __forceinline__ svf::Coefs<float> svf_coefs(const Ctx& x, const Rec& rc, int i) {
  return svf::coefs<float>(param(x, rc, 0, i), param(x, rc, 1, i), param(x, rc, 2, i),
                           param(x, rc, 3, i), x.sr);
}

template <bool kCl>
__device__ void body_svf(Ctx& x, const Rec& rc) {
  // params: filter, cutoff_freq, q, gain; words ic0, ic1
  const int n = x.n, cs = x.cs, tid = threadIdx.x;
  const float ic0 = word_f(rc.w[0]), ic1 = word_f(rc.w[1]);
  float* sc = x.scratch;
  sync_rows<kCl>();  // every earlier reader of the scratch rows is done
  for (int i = tid; i < n; i += blockDim.x) {
    const svf::Coefs<float> c = svf_coefs(x, rc, i);
    svf::rows<float>(sc, cs, i, c.a1, c.a2, c.a3, input(x, rc, 0, i));
  }
  sync_rows<kCl>();
  const float* m = sc + scan_affine_2x2<kCl>(x, sc) * 6 * cs;
  for (int i = tid; i < n; i += blockDim.x) {
    const int t = x.c0 + i;
    const svf::Coefs<float> c = svf_coefs(x, rc, i);
    float s0 = ic0, s1 = ic1;
    if (t > 0) {
      const int u = t - 1;
      s0 = add(add(mul(at<kCl>(x, m, u), ic0), mul(at<kCl>(x, m + cs, u), ic1)),
               at<kCl>(x, m + 4 * cs, u));
      s1 = add(add(mul(at<kCl>(x, m + 2 * cs, u), ic0), mul(at<kCl>(x, m + 3 * cs, u), ic1)),
               at<kCl>(x, m + 5 * cs, u));
    }
    emit(x, rc, 0, i,
         svf::out<float>(s0, s1, c.a1, c.a2, c.a3, c.m0, c.m1, c.m2, input(x, rc, 0, i)));
    if (t == x.B - 1) {
      x.state_out[rc.srow * x.K + x.k] =
          f_word(add(add(mul(m[i], ic0), mul(m[cs + i], ic1)), m[4 * cs + i]));
      x.state_out[(rc.srow + 1) * x.K + x.k] = f_word(
          add(add(mul(m[2 * cs + i], ic0), mul(m[3 * cs + i], ic1)), m[5 * cs + i]));
    }
  }
}

template <bool kCl>
__device__ void body_onepole(Ctx& x, const Rec& rc, bool highpass) {
  // y[t] = b1*y[t-1] + a0*x[t]; the highpass outputs x - y
  const int n = x.n, cs = x.cs, tid = threadIdx.x;
  const float last = word_f(rc.w[0]);
  float* sc = x.scratch;
  sync_rows<kCl>();
  for (int i = tid; i < n; i += blockDim.x) {
    const float b1 = expf(mul(kNegTwoPi, fdiv(param(x, rc, 0, i), x.sr)));
    sc[i] = b1;
    sc[cs + i] = mul(sub(1.0f, b1), input(x, rc, 0, i));
  }
  sync_rows<kCl>();
  const float* m = sc + scan_affine_1d<kCl>(x, sc) * 2 * cs;
  for (int i = tid; i < n; i += blockDim.x) {
    const int t = x.c0 + i;
    const float b1 = expf(mul(kNegTwoPi, fdiv(param(x, rc, 0, i), x.sr)));
    const float xin = input(x, rc, 0, i);
    const float pre =
        t > 0 ? add(mul(at<kCl>(x, m, t - 1), last), at<kCl>(x, m + cs, t - 1)) : last;
    const float y = add(mul(b1, pre), mul(sub(1.0f, b1), xin));
    emit(x, rc, 0, i, highpass ? sub(xin, y) : y);
    if (t == x.B - 1)
      x.state_out[rc.srow * x.K + x.k] = f_word(add(mul(m[i], last), m[cs + i]));
  }
}

template <bool kCl>
__device__ void body_env(Ctx& x, const Rec& rc, bool ar) {
  // the event-free closed forms (ugens/envelopes.py); params attack_time,
  // release_time; words release_scale, stage, t
  const int n = x.n, cs = x.cs, B = x.B, tid = threadIdx.x;
  const float rs = word_f(rc.w[0]);
  const int stage0 = static_cast<int>(rc.w[1]);
  const float t0 = word_f(rc.w[2]);
  float* sc = x.scratch;
  sync_rows<kCl>();
  for (int i = tid; i < n; i += blockDim.x) {
    sc[i] = rate_from_time(param(x, rc, 0, i), x.sr);
    sc[cs + i] = rate_from_time(param(x, rc, 1, i), x.sr);
  }
  sync_rows<kCl>();
  const float* A = sc + scan_cumsum_2<kCl>(x, sc) * 2 * cs;
  const float* R = A + cs;
  float t_fin = t0, rs_fin = rs;
  int st_fin = stage0;
  if (!ar) {
    // csrc/env_asr.cuh's closed form, shared with the EnvAsr block kernel
    for (int i = tid; i < n; i += blockDim.x) {
      const int t = x.c0 + i;
      float y;
      bool done;
      asr::closed_lane_of<float>(t > 0 ? at<kCl>(x, A, t - 1) : 0.0f,
                                 t > 0 ? at<kCl>(x, R, t - 1) : 0.0f, R[i], t, stage0, t0, rs,
                                 &y, &done);
      emit(x, rc, 0, i, y);
      if (rc.done_row) rc.done_row[i] = done;
    }
    asr::closed_state<float>(at<kCl>(x, A, B - 1), at<kCl>(x, R, B - 1), &st_fin, &t_fin);
  } else {
    const float inc_atk_last = add(t0, at<kCl>(x, A, B - 1));
    const bool atk_any = inc_atk_last >= 1.0f;
    const float inc_rel_last = sub(t0, at<kCl>(x, R, B - 1));
    const bool rel_done = inc_rel_last <= 0.0f;
    const float t_rel = rel_done ? 0.0f : inc_rel_last;
    const int st_rel = rel_done ? kStopped : kReleasing;
    // EnvAr: R at the first crossed sample, the minimum of R there (atk_any
    // is the same in every thread of the cluster: all or none reduce)
    float lmin = kBig;
    for (int i = tid; i < n; i += blockDim.x)
      if (add(t0, A[i]) >= 1.0f) lmin = fminf(lmin, R[i]);
    float Rk = 0.0f;
    if (atk_any) {
      Rk = block_min(lmin, x.red);
      if constexpr (kCl) Rk = exchange_min(x, Rk);
    }
    for (int i = tid; i < n; i += blockDim.x) {
      const int t = x.c0 + i;
      const float Rex = t > 0 ? at<kCl>(x, R, t - 1) : 0.0f;
      const float e_atk = add(t0, t > 0 ? at<kCl>(x, A, t - 1) : 0.0f);
      const bool in_rel2 = e_atk >= 1.0f;
      const float t_rel2 = sub(1.0f, sub(Rex, Rk));
      const bool alive2 = t_rel2 > 0.0f;
      const float out_a = in_rel2 ? (alive2 ? mul(mul(t_rel2, t_rel2), t_rel2) : 0.0f) : e_atk;
      const bool done_a = in_rel2 && alive2 && sub(1.0f, sub(R[i], Rk)) <= 0.0f;
      const float e_rel = sub(t0, Rex);
      const bool alive = t == 0 || e_rel > 0.0f;
      const bool done_r = alive && sub(t0, R[i]) <= 0.0f;
      const float out_r = alive ? mul(mul(mul(e_rel, e_rel), e_rel), rs) : 0.0f;
      const float y = stage0 == kAttacking ? out_a : stage0 == kReleasing ? out_r : 0.0f;
      emit(x, rc, 0, i, y);
      if (rc.done_row)
        rc.done_row[i] = (stage0 == kAttacking && done_a) || (stage0 == kReleasing && done_r);
    }
    const float t_after = sub(1.0f, sub(at<kCl>(x, R, B - 1), Rk));
    const bool a_done = atk_any && t_after <= 0.0f;
    const float t_a = a_done ? 0.0f : (atk_any ? t_after : inc_atk_last);
    const int st_a = a_done ? kStopped : (atk_any ? kReleasing : kAttacking);
    t_fin = stage0 == kAttacking ? t_a : stage0 == kReleasing ? t_rel : t0;
    st_fin = stage0 == kAttacking ? st_a : stage0 == kReleasing ? st_rel : stage0;
    if (stage0 == kAttacking && atk_any) rs_fin = 1.0f;
  }
  if (leader(x)) {
    x.state_out[rc.srow * x.K + x.k] = f_word(rs_fin);
    x.state_out[(rc.srow + 1) * x.K + x.k] = static_cast<uint32_t>(st_fin);
    x.state_out[(rc.srow + 2) * x.K + x.k] = f_word(t_fin);
  }
}

__device__ void body_pan2(const Ctx& x, const Rec& rc) {
  for (int i = threadIdx.x; i < x.n; i += blockDim.x) {
    const float xin = input(x, rc, 0, i);
    const float angle = mul(add(mul(param(x, rc, 0, i), 0.5f), 0.5f), kHalfPi);
    emit(x, rc, 0, i, mul(xin, cosf(angle)));
    emit(x, rc, 1, i, mul(xin, sinf(angle)));
  }
}

// SinNumeric (the fast program's no-reset path) and Phasor (ugens/osc.py):
// the f32 phase in cycles, phase_t = ph0 + sum(inc[0:t]) with inc = freq *
// (1 / sr) summed over the whole block by scan_sum_base16, wrapped only at
// the block's end. Params: freq (, phase_offset); word: the phase.
template <bool kCl>
__device__ void body_float_osc(Ctx& x, const Rec& rc, bool phasor) {
  const int n = x.n, tid = threadIdx.x;
  const float ph0 = word_f(rc.w[0]);
  const float inv_sr = fdiv(1.0f, x.sr);
  float* inc = x.scratch;
  float* csum = inc + x.cs;
  sync_rows<kCl>();  // every earlier reader of the scratch rows is done
  for (int i = tid; i < n; i += blockDim.x) inc[i] = mul(param(x, rc, 0, i), inv_sr);
  __syncthreads();
  if constexpr (kCl) {
    scan_sum_base16_cluster(x, inc, csum, csum + x.cs);
  } else {
    scan_sum_base16(inc, csum, csum + x.cs, x.B);
  }
  for (int i = tid; i < n; i += blockDim.x) {
    const int t = x.c0 + i;
    const float ph = add(ph0, t > 0 ? at<kCl>(x, csum, t - 1) : 0.0f);
    const float y = phasor ? sub(ph, floorf(ph))
                           : sinf(mul(add(ph, param(x, rc, 1, i)), kTau));
    emit(x, rc, 0, i, y);
  }
  if (leader(x)) {
    const float c = add(ph0, at<kCl>(x, csum, x.B - 1));
    x.state_out[rc.srow * x.K + x.k] = f_word(sub(c, floorf(c)));
  }
}

// WhiteNoise (ugens/noise.py): words frame, seed (the sorted state names).
// Sample t: the key fold_in(PRNGKey(seed), frame + t) = Threefry of the
// counter (0, frame + t) under (0, seed); one 32-bit draw = the XOR of the
// key's Threefry of the counter (0, 0); its top 23 bits under 1.0's
// exponent, minus 1, mapped to (-1, 1).
__device__ void body_white_noise(const Ctx& x, const Rec& rc) {
  const uint32_t frame0 = rc.w[0], seed = rc.w[1];
  for (int i = threadIdx.x; i < x.n; i += blockDim.x) {
    uint32_t a = 0u, b = frame0 + static_cast<uint32_t>(x.c0 + i);
    threefry2x32(0u, seed, a, b);
    uint32_t b0 = 0u, b1 = 0u;
    threefry2x32(a, b, b0, b1);
    const float u = sub(__uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u), 1.0f);
    emit(x, rc, 0, i, sub(mul(u, 2.0f), 1.0f));
  }
  if (leader(x)) {
    x.state_out[rc.srow * x.K + x.k] = frame0 + static_cast<uint32_t>(x.B);
    x.state_out[(rc.srow + 1) * x.K + x.k] = seed;
  }
}

// SampleDelay (ugens/delay.py sample_delay_block): words the ring buf[0, L)
// and pos; arg = L. Write before read: sample t reads hist[L + t - d], hist
// = [the ring oldest-first from pos | this block's input], d = clip(trunc(
// delay_time * sr), 0, L - 1); at index >= L that is the input at t - d,
// another thread's (in a cluster, maybe another CTA's) sample, hence the
// barrier before. The old ring is read from `state` and the new one written
// whole to `state_out` (slot s takes hist[B + (s - pos') mod L], pos' = (pos
// + B) mod L), so no read sees a write; the barrier after keeps the input
// rows until every thread has read them.
template <bool kCl>
__device__ void body_sample_delay(const Ctx& x, const Rec& rc) {
  const int K = x.K, B = x.B, L = rc.arg, tid = threadIdx.x;
  const uint32_t* ring = x.state + static_cast<size_t>(rc.srow) * K + x.k;
  uint32_t* ring_out = x.state_out + static_cast<size_t>(rc.srow) * K + x.k;
  const int pos = static_cast<int>(rc.w[0]);
  const float top = static_cast<float>(L - 1);
  sync_rows<kCl>();  // the input rows of every sample are written
  for (int i = tid; i < x.n; i += blockDim.x) {
    const int t = x.c0 + i;
    const float d = mul(param(x, rc, 0, i), x.sr);
    const int m = t - (d > 0.0f ? static_cast<int>(fminf(d, top)) : 0);
    const float v = m >= 0 ? input_at<kCl>(x, rc, 0, m)
                           : word_f(ring[static_cast<size_t>((pos + L + m) % L) * K]);
    emit(x, rc, 0, i, v);
  }
  const int new_pos = (pos + B % L) % L;
  for (int s = x.rank * blockDim.x + tid; s < L; s += x.C * blockDim.x) {
    const int m = B + (s - new_pos + L) % L;
    ring_out[static_cast<size_t>(s) * K] =
        m >= L ? f_word(input_at<kCl>(x, rc, 0, m - L))
               : ring[static_cast<size_t>((pos + m) % L) * K];
  }
  if (leader(x)) ring_out[static_cast<size_t>(L) * K] = static_cast<uint32_t>(new_pos);
  sync_rows<kCl>();
}

// ---------------------------------------------------------------------------
// The stage loop
// ---------------------------------------------------------------------------

// The stage loop of the kernels below. kAllBodies: the program may use a
// body past Math1. kLayout: where the rows live (shared memory, the
// cluster's shared memories, the global workspace `ws`).
//
// Staging. The first n_stage param planes and the scalar state words reach
// shared memory before the stage that reads them: with kStageWhole, every
// stage's at once before the loop (one bulk copy a plane: one CTA, whose
// rows of a plane are one contiguous [K, B] slab); with kStageRing two
// stages' at a time, stage k + 1's issued when stage k starts; with
// kStageDirect none (n_stage = 0), each stage reading its words and param
// rows from device memory.
//
// Dynamic shared memory, in order, each part a multiple of 16 bytes
// (kernels/chain_kernel.py smem_bytes, which the host sizes the launch by):
// two mbarriers (16 bytes), the descriptors (16 bytes a program word), the
// program (its words, rounded up to 4), the staged param rows (n_stage x
// depth rows of cs floats, depth = K with kStageWhole, else 2), the
// exchange slots (256 bytes), the rows (n_slots + n_carry + n_scratch rows
// of cs floats; none in the global layout), the scalar words (depth x
// n_words, rounded up to 4), the record headers (48 bytes each), the
// words' state rows (n_words, rounded up to 4), the records the loop runs
// (p, rounded up to 4), the slots' forwarded sources (2 n_slots, rounded
// up to 4) and per record its word count and skip flag (2 p, rounded up).
template <bool kAllBodies, int kLayout>
__device__ __forceinline__ void run_chain(const int* __restrict__ gprog, int n_prog,
                                          const float* __restrict__ planes,
                                          const uint32_t* __restrict__ state,
                                          const float* __restrict__ rows,
                                          float* __restrict__ out,
                                          uint32_t* __restrict__ state_out,
                                          uint8_t* __restrict__ done_out, int K, int B,
                                          int n_stage, int staging, float f2pi, float scale,
                                          float sr, float* ws) {
  constexpr bool kCl = kLayout == kLayoutCluster;
  __shared__ uint32_t scan32[32];
  __shared__ float red[32];
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, bd = blockDim.x;
  int rank = 0, C = 1;
  if constexpr (kCl) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    C = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const int n = B / C, c0 = rank * n, cs = round4(n);
  const int depth = staging == kStageWhole ? K : 2;  // stage buffers

  // The parts whose place depends on the launch's arguments alone come
  // first, so that warp 0 issues the param rows' bulk copies (stage 0's, or
  // every stage's with kStageWhole) before the program is even read; they
  // need 16-byte aligned rows of a multiple of 16 bytes.
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Src* desc = reinterpret_cast<Src*>(smem + 16);
  int* prog = reinterpret_cast<int*>(smem + 16 + 16 * static_cast<size_t>(n_prog));
  size_t off = 16 + 16 * static_cast<size_t>(n_prog) + 4 * static_cast<size_t>(round4(n_prog));
  float* staged = reinterpret_cast<float*>(smem + off);  // [plane][stage buffer][cs]
  off += 4 * static_cast<size_t>(n_stage) * depth * cs;
  if (off > dynamic_smem_size()) __trap();  // the host sized the launch for another layout
  const bool tma = n_stage > 0 && B % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(planes) & 15u) == 0;
  auto issue_bulk = [&](int k) {  // warp 0
    const int b = k & 1;
    const bool whole = staging == kStageWhole;
    const uint32_t bytes = static_cast<uint32_t>(whole ? K * n : n) * 4u;
    if (tid == 0) mbar_expect_tx(&bar[b], bytes * static_cast<uint32_t>(n_stage));
    __syncwarp();
    for (int q = tid; q < n_stage; q += 32)
      bulk_copy(staged + static_cast<size_t>(q) * depth * cs + (whole ? 0 : b * cs),
                planes + (static_cast<size_t>(q) * K + (whole ? 0 : k)) * B + c0, bytes, &bar[b]);
  };
  if (tma && tid < 32) {
    if (tid == 0) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    issue_bulk(0);
  }

  // the program, copied in once
  for (int i = tid; i < n_prog; i += bd) prog[i] = gprog[i];
  __syncthreads();
  const int p = prog[0], n_carry = prog[1], n_slots = prog[2], n_ext = prog[3];
  const int n_rows = n_slots + n_carry + prog[7];
  const int* carry_src = prog + kHeader;
  const int* records = carry_src + n_carry;
  int n_words = 0;
  for (int j = 0; j < p; ++j) n_words += scalar_words(prog[records[j]]);
  float* xch = reinterpret_cast<float*>(smem + off);
  off += 256;
  float* rowbase = ws;
  if constexpr (kLayout != kLayoutGlobal) {
    rowbase = reinterpret_cast<float*>(smem + off);
    off += 4 * static_cast<size_t>(n_rows) * cs;
  }
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(smem + off);  // [stage buffer][word]
  off += 4 * static_cast<size_t>(round4(depth * n_words));
  RecHead* head = reinterpret_cast<RecHead*>(smem + off);
  off += sizeof(RecHead) * static_cast<size_t>(p);
  int* wrow = reinterpret_cast<int*>(smem + off);  // per word: its state row
  off += 4 * static_cast<size_t>(round4(n_words));
  int* live = reinterpret_cast<int*>(smem + off);  // the records the stage loop runs
  off += 4 * static_cast<size_t>(round4(p));
  int* fwd = reinterpret_cast<int*>(smem + off);  // per slot: the source its readers take
  off += 4 * static_cast<size_t>(round4(2 * n_slots));
  int* nw_of = reinterpret_cast<int*>(smem + off);  // per record: its scalar words
  int* skip_of = nw_of + p;                         // per record: a Constant the loop skips
  off += 4 * static_cast<size_t>(round4(2 * p));
  if (off > dynamic_smem_size()) __trap();  // the host sized the launch for another layout

  // a carried slot has a row per stage parity; the others one
  auto carried = [&](int s) {
    for (int i = 0; i < n_carry; ++i)
      if (carry_src[i] == s) return true;
    return false;
  };
  auto slot_row = [&](int s) {
    int r = s;
    for (int i = 0; i < n_carry; ++i) r += carry_src[i] < s;
    return r;
  };

  // The prologue's other loads are issued before the decode, to land
  // while the CTA decodes the program.
  // the state row of scalar word w (the word tables are not built yet)
  auto word_row = [&](int w) {
    for (int j = 0; j < p; ++j) {
      const int* r = prog + records[j];
      const int nw = scalar_words(r[0]);
      if (w < nw) return r[5] + (r[0] == kOpSampleDelay ? r[1] : 0) + w;
      w -= nw;
    }
    return 0;
  };
  // stage k's scalar words and, where no bulk copy takes them, staged param
  // rows (every stage's with kStageWhole), by cp.async
  auto issue_small = [&](int k, bool prologue) {
    const bool whole = staging == kStageWhole;
    for (int i = tid; i < (whole ? K : 1) * n_words; i += bd) {
      const int kk = whole ? i / n_words : k, w = whole ? i - kk * n_words : i;
      cp_async4(wbuf + (whole ? i : (k & 1) * n_words + i),
                state + static_cast<size_t>(prologue ? word_row(w) : wrow[w]) * K + kk);
    }
    if (tma) return;
    const int rows_of = whole ? K : 1;
    for (int q = 0; q < n_stage; ++q)
      for (int i = tid; i < rows_of * n; i += bd) {
        const int r = i / n, t = i - r * n, kk = whole ? r : k;
        cp_async4(staged + static_cast<size_t>(q) * depth * cs + (whole ? r : (k & 1)) * cs + t,
                  planes + (static_cast<size_t>(q) * K + kk) * B + c0 + t);
      }
  };
  if (staging != kStageDirect) issue_small(0, true);
  // stage 0's carry rows: the parity-1 rows of their slots
  for (int i = 0; i < n_carry; ++i) {
    float* dst = rowbase + static_cast<size_t>(slot_row(carry_src[i]) + 1) * cs;
    const float* from = rows + static_cast<size_t>(n_ext + i) * B + c0;
    for (int t = tid; t < n; t += bd) {
      if constexpr (kLayout == kLayoutGlobal) {
        dst[t] = from[t];
      } else {
        cp_async4(dst + t, from + t);
      }
    }
  }
  // The decode: two passes, a thread a record, with no search over the
  // records. A Constant whose output slot is neither carried nor read
  // outside the chain only copies its param row: the stage loop skips it
  // and its readers read that row. Pass 1: each record's scalar-word count,
  // whether it is such a copy, and for each slot it writes the source its
  // readers take (fwd: the param's (kind, index), or -1: the slot itself).
  for (int j = tid; j < p; j += bd) {
    const int* r = prog + records[j];
    const int n_out = r[4], out_tab = r[8], par_tab = r[7];
    const bool skip =
        r[0] == kOpConstant && prog[out_tab + 1] < 0 && !carried(prog[out_tab]);
    nw_of[j] = scalar_words(r[0]);
    skip_of[j] = skip;
    for (int c = 0; c < n_out; ++c) {
      const int slot = prog[out_tab + 2 * c];
      fwd[2 * slot] = skip ? prog[par_tab] : -1;
      fwd[2 * slot + 1] = skip ? prog[par_tab + 1] : -1;
    }
  }
  __syncthreads();
  auto resolve = [&](int kind, int idx) -> Src {
    for (int hop = 0; hop < p && kind == kSrcSlot && fwd[2 * idx] >= 0; ++hop) {
      const int next = fwd[2 * idx];
      idx = fwd[2 * idx + 1];
      kind = next;
    }
    switch (kind) {
      case kSrcSlot:
        return Src{rowbase + static_cast<size_t>(slot_row(idx)) * cs, 0, carried(idx) ? cs : 0};
      case kSrcCarry:  // stage k reads its slot's row of stage k - 1
        return Src{rowbase + static_cast<size_t>(slot_row(carry_src[idx]) + 1) * cs, 0, -cs};
      case kSrcRow:
        return Src{const_cast<float*>(rows) + static_cast<size_t>(idx) * B + c0, 0, 0};
      default: {
        if (idx >= n_stage)
          return Src{const_cast<float*>(planes) + static_cast<size_t>(idx) * K * B + c0, B, 0};
        float* row = staged + static_cast<size_t>(idx) * depth * cs;
        return staging == kStageWhole ? Src{row, cs, 0} : Src{row, 0, cs};
      }
    }
  };
  // Pass 2: each record's descriptors, header, words' state rows and place
  // in the list of records the loop runs.
  for (int j = tid; j < p; j += bd) {
    const int* r = prog + records[j];
    const int n_in = r[2], n_par = r[3], n_out = r[4], in_tab = r[6], par_tab = r[7],
              out_tab = r[8];
    int wslot = 0, pos = 0;
    for (int i = 0; i < j; ++i) {
      wslot += nw_of[i];
      pos += !skip_of[i];
    }
    const int wfirst = r[5] + (r[0] == kOpSampleDelay ? r[1] : 0);
    head[j] = RecHead{r[0], r[1], n_out, r[5], in_tab, par_tab, out_tab, wslot, r[9],
                      nw_of[j], wfirst, 0};
    for (int w = 0; w < nw_of[j]; ++w) wrow[wslot + w] = wfirst + w;
    if (!skip_of[j]) live[pos] = j;
    for (int c = 0; c < n_in; ++c) {
      const int start = prog[in_tab + 2 * c], count = prog[in_tab + 2 * c + 1];
      for (int s = 0; s < count; ++s) {
        const int w = start + 2 * s;
        desc[w] = resolve(prog[w], prog[w + 1]);
      }
      desc[in_tab + 2 * c] = count ? resolve(prog[start], prog[start + 1]) : Src{nullptr, 0, 0};
      desc[in_tab + 2 * c + 1] = Src{nullptr, count, start};
    }
    for (int i = 0; i < n_par; ++i) {
      const int w = par_tab + 2 * i;
      desc[w] = resolve(prog[w], prog[w + 1]);
    }
    for (int c = 0; c < n_out; ++c) {
      const int w = out_tab + 2 * c, plane = prog[w + 1], slot = prog[w];
      desc[w] = Src{rowbase + static_cast<size_t>(slot_row(slot)) * cs, 0,
                    carried(slot) ? cs : 0};
      desc[w + 1] = plane >= 0 ? Src{out + static_cast<size_t>(plane) * K * B + c0, B, 0}
                               : Src{nullptr, 0, 0};
    }
  }
  int n_live = 0;
  for (int j = 0; j < p; ++j) n_live += !skip_of[j];
  cp_async_wait_all();
  if (tma && staging == kStageWhole) mbar_wait(&bar[0], 0u);
  __syncthreads();
  if constexpr (kCl) cg::this_cluster().sync();  // every CTA runs before any reads another

  Ctx x{desc, state, state_out,
        rowbase + static_cast<size_t>(n_slots + n_carry) * cs, scan32, red, xch,
        K, B, 0, n, cs, c0, rank, C, 0, f2pi, scale, sr};
  for (int k = 0; k < K; ++k) {
    if (staging == kStageRing) {
      if (k + 1 < K) {
        if (tma && tid < 32) issue_bulk(k + 1);
        issue_small(k + 1, false);
      }
      if (tma) mbar_wait(&bar[k & 1], static_cast<uint32_t>((k >> 1) & 1));
    }
    x.k = k;
    const uint32_t* words = wbuf + (staging == kStageWhole ? k : (k & 1)) * n_words;
    for (int l = 0; l < n_live; ++l) {
      const RecHead h = head[live[l]];
      Rec rc{h.op, h.arg, h.n_out, h.srow, h.in_tab, h.par_tab, h.out_tab, {0u, 0u, 0u},
             h.done_plane >= 0
                 ? done_out + (static_cast<size_t>(h.done_plane) * K + k) * B + c0
                 : nullptr};
      // at most three words a body, read without a loop so they stay in registers
      const uint32_t* wsrc = staging == kStageDirect
                                 ? state + static_cast<size_t>(h.wfirst) * K + k
                                 : words + h.wslot;
      const int wstep = staging == kStageDirect ? K : 1;
      if (h.n_words > 0) rc.w[0] = wsrc[0];
      if (h.n_words > 1) rc.w[1] = wsrc[wstep];
      if (h.n_words > 2) rc.w[2] = wsrc[2 * wstep];
      switch (rc.op) {
        case kOpConstant: {
          const float* v = src(x, rc.par_tab);
          for (int i = tid; i < n; i += bd) emit(x, rc, 0, i, v[i]);
          break;
        }
        case kOpMath:
          for (int c = 0; c < rc.n_out; ++c)
            for (int i = tid; i < n; i += bd)
              emit(x, rc, c, i,
                   binop(rc.arg, input(x, rc, c, i), input(x, rc, c + rc.n_out, i)));
          break;
        case kOpMath1:
          for (int c = 0; c < rc.n_out; ++c)
            for (int i = tid; i < n; i += bd) emit(x, rc, c, i, unop(rc.arg, input(x, rc, c, i)));
          break;
        case kOpSinWt: body_sinwt<kCl>(x, rc); break;
        default:
          if constexpr (kAllBodies) {
            switch (rc.op) {
              case kOpPolyBlep: body_polyblep<kCl>(x, rc); break;
              case kOpSvf: body_svf<kCl>(x, rc); break;
              case kOpLpf: body_onepole<kCl>(x, rc, false); break;
              case kOpHpf: body_onepole<kCl>(x, rc, true); break;
              case kOpEnvAsr: body_env<kCl>(x, rc, false); break;
              case kOpEnvAr: body_env<kCl>(x, rc, true); break;
              case kOpPan2: body_pan2(x, rc); break;
              case kOpSinNumeric: body_float_osc<kCl>(x, rc, false); break;
              case kOpPhasor: body_float_osc<kCl>(x, rc, true); break;
              case kOpWhiteNoise: body_white_noise(x, rc); break;
              case kOpSampleDelay: body_sample_delay<kCl>(x, rc); break;
              default: break;
            }
          }
      }
    }
    if (staging == kStageRing) {
      // stage k + 1's words and rows have landed; stage k's buffers are free
      cp_async_wait_all();
      __syncthreads();
    }
  }
  if constexpr (kCl) cg::this_cluster().sync();  // no CTA leaves while another reads its rows
}

#define CHAIN_KERNEL_PARAMS                                                                \
  const int *__restrict__ prog, int n_prog, const float *__restrict__ planes,              \
      const uint32_t *__restrict__ state, const float *__restrict__ rows,                  \
      float *__restrict__ out, uint32_t *__restrict__ state_out,                           \
      uint8_t *__restrict__ done_out, int K, int B, int n_stage, int staging, float f2pi,    \
      float scale, float sr, float *ws
#define CHAIN_KERNEL_ARGS                                                                   \
  prog, n_prog, planes, state, rows, out, state_out, done_out, K, B, n_stage, staging, f2pi, \
      scale, sr, ws

// Constant, SinWt, Math and Math1 bodies only. No launch bound for one CTA
// with shared rows: with __launch_bounds__(1024) the FM cascade's loop ran
// slower on an H100, and it needs no more than 64 registers without one.
template <int kLayout>
__global__ void chain_kernel_small(CHAIN_KERNEL_PARAMS) {
  run_chain<false, kLayout>(CHAIN_KERNEL_ARGS);
}

// The same for the cluster and global layouts, whose CTAs take 1024 threads
// and whose unbounded loop took 80 registers (a refused launch).
template <int kLayout>
__global__ void __launch_bounds__(1024) chain_kernel_small_bounded(CHAIN_KERNEL_PARAMS) {
  run_chain<false, kLayout>(CHAIN_KERNEL_ARGS);
}

// Every body, for CTAs of at most kThreads threads: 1024 allow 64 registers
// a thread, under which the inlined bodies spill; 512 allow 128, which a
// cluster's CTAs of 512 samples take (one CTA keeps the 1024 bound: with
// 128 registers its loop ran 5-14% slower on an H100, PERF.md §6).
template <int kLayout, int kThreads>
__global__ void __launch_bounds__(kThreads) chain_kernel_all(CHAIN_KERNEL_PARAMS) {
  run_chain<true, kLayout>(CHAIN_KERNEL_ARGS);
}

using ChainKernel = void (*)(const int*, int, const float*, const uint32_t*, const float*,
                             float*, uint32_t*, uint8_t*, int, int, int, int, float, float,
                             float, float*);

ChainKernel pick_kernel(int all_bodies, int layout, int threads) {
  switch (layout) {
    case kLayoutShared:
      return all_bodies ? chain_kernel_all<kLayoutShared, 1024> : chain_kernel_small<kLayoutShared>;
    case kLayoutCluster:
      return all_bodies ? (threads <= 512 ? chain_kernel_all<kLayoutCluster, 512>
                                          : chain_kernel_all<kLayoutCluster, 1024>)
                        : chain_kernel_small_bounded<kLayoutCluster>;
    default:
      return all_bodies ? chain_kernel_all<kLayoutGlobal, 1024>
                        : chain_kernel_small_bounded<kLayoutGlobal>;
  }
}

constexpr int kPortableCluster = 8, kMaxCluster = 16;

cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr, bool with_cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = with_cluster ? 1 : 0;
  return cfg;
}

}  // namespace

extern "C" {

// Runs one chain over one block on `stream` in the layout the host planned
// (kernels/chain_kernel.py launch_plan): layout 0 (one CTA, rows in shared
// memory), 1 (a cluster of `cluster` CTAs, B / cluster samples each) or 2
// (one CTA, rows in `workspace`); `threads` a CTA, `smem_bytes` of dynamic
// shared memory, the first `n_stage` param planes staged ahead of each
// stage (every stage's before the loop with staging 1: one CTA only; none
// with staging 2, which reads words and planes from device memory);
// all_bodies: nonzero when the program uses a body past Math1.
// Returns the launch's error (cudaLaunchKernelEx's, else
// cudaGetLastError()'s): a cluster the card cannot schedule never runs and
// is reported, never replaced by another layout.
int ktt_chain_kernel(const int* prog, const float* planes, const uint32_t* state,
                     const float* rows, float* out, uint32_t* state_out, uint8_t* done,
                     int K, int B, int n_prog, int layout, int cluster, int threads,
                     int smem_bytes, int n_stage, int staging, int all_bodies, float f2pi,
                     float scale, float sr, float* workspace, void* stream) {
  if (K < 1 || B < 1 || n_prog < kHeader || cluster < 1 || B % cluster != 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || smem_bytes < 0 || n_stage < 0 ||
      layout < kLayoutShared || layout > kLayoutGlobal ||
      (layout != kLayoutCluster && cluster != 1) || staging < kStageRing ||
      staging > kStageDirect || (staging == kStageWhole && cluster != 1) ||
      (staging == kStageDirect && n_stage != 0) ||
      ((layout == kLayoutGlobal) != (workspace != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChainKernel kernel = pick_kernel(all_bodies, layout, threads);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err == cudaSuccess && cluster > kPortableCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem_bytes, static_cast<cudaStream_t>(stream), attr,
                     layout == kLayoutCluster);
  err = cudaLaunchKernelEx(&cfg, kernel, prog, n_prog, planes, state, rows, out, state_out,
                           done, K, B, n_stage, staging, f2pi, scale, sr, workspace);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The largest cluster the plan may take on this card: 16 where a
// non-portable cluster of 16 CTAs of 1024 threads and `smem_bytes` of
// shared memory each can be resident (cudaOccupancyMaxActiveClusters, for
// both body sets), else the portable 8. Returns a CUDA error, 0 on success.
int ktt_chain_max_cluster(int smem_bytes, int* max_cluster) {
  int best = kMaxCluster;
  const ChainKernel kernels[2] = {chain_kernel_small_bounded<kLayoutCluster>,
                                  chain_kernel_all<kLayoutCluster, 1024>};
  for (const ChainKernel kernel : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int clusters = 0;
    if (err == cudaSuccess) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg =
          cluster_config(kMaxCluster, 1024, smem_bytes, nullptr, attr, true);
      err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
    }
    cudaGetLastError();
    if (err != cudaSuccess || clusters < 1) best = kPortableCluster;
  }
  *max_cluster = best;
  return 0;
}

// the CUDA error's name (cudaErrorClusterOutOfResources, ...)
const char* ktt_chain_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
