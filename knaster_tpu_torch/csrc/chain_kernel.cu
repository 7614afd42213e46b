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
//   [6, 6 + n_carry)            the slot each carry row is copied from at
//                               the end of a stage
//   [6 + n_carry, .. + p)       the start of each offset's record
//   record: op, arg, n_in, n_par, n_out, state_row, in_tab, par_tab, out_tab
//     in_tab:  n_in pairs (start, count) of source lists; a list is count
//              (kind, index) pairs summed left to right (0.0 when empty)
//     par_tab: n_par (kind, index) sources, in the body's param order
//     out_tab: n_out pairs (slot, out plane or -1 when nothing outside the
//              chain reads the channel)
//   source kinds: 0 a slot of this stage (an earlier offset's output),
//   1 a carry row (an output of the previous stage), 2 an external row,
//   3 a param plane planes[index][k][t].
//
// Operands: planes f32 [n_planes, K, B] (stage-stacked float params),
// state i32 [n_state, K] (state words, u32 as bit patterns), rows f32
// [n_ext + n_carry, B] (external rows, then the carry rows stage 0 reads);
// out f32 [n_out, K, B] and state_out i32 [n_state, K].
//
// Design. One CTA per chain, one thread per sample. The rows of the stage
// being computed (one slot per output channel) and the carry rows live in
// shared memory; each thread reads and writes only its own samples there,
// so the only cross-thread step is SinWt's phase scan, the block scan of
// stage_scan.cuh shared with the cascade kernel. The k and j loops are
// uniform across the block, and each record's body is a switch on its
// opcode. What bounds it: K*p dependent bodies per block, each a few
// instructions per sample plus, for SinWt, a scan and a sinf; one SM of
// 132 does the work, which is what a serial 256-deep chain at B = 64 is.
// Running several chains or graphs per launch is later work.

#include "stage_scan.cuh"

namespace {

using namespace ktt;

// body opcodes (knaster_tpu_torch/kernels/chain_kernel.py BODIES)
constexpr int kOpConstant = 0, kOpSinWt = 1, kOpMath = 2, kOpMath1 = 3;
// Math args (ugens/math.py KERNEL_BINOPS) and Math1 args (KERNEL_UNOPS)
constexpr int kAdd = 0, kSub = 1, kMul = 2, kDiv = 3;
constexpr int kCeil = 0, kFloor = 1, kSqrt = 2, kExp = 3, kAbs = 4, kNeg = 5,
              kLog = 6, kSin = 7, kCos = 8, kTanh = 9;
constexpr int kSrcSlot = 0, kSrcCarry = 1, kSrcRow = 2, kSrcPlane = 3;
constexpr int kHeader = 6;

struct Frame {
  const float* planes;
  const float* rows;
  float* slots;
  float* carry;
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
    acc = __fadd_rn(acc, fetch(f, prog[start + 2 * i], prog[start + 2 * i + 1], t));
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
    case kAdd: return __fadd_rn(a, b);
    case kSub: return __fsub_rn(a, b);
    case kMul: return __fmul_rn(a, b);
    default: return __fdiv_rn(a, b);
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

__global__ void chain_kernel(const int* __restrict__ prog,
                             const float* __restrict__ planes,
                             const uint32_t* __restrict__ state,
                             const float* __restrict__ rows, float* __restrict__ out,
                             uint32_t* __restrict__ state_out, int K, int B, float f2pi,
                             float scale) {
  extern __shared__ float smem[];
  __shared__ uint32_t scratch[32];
  const int p = prog[0], n_carry = prog[1], n_slots = prog[2], n_ext = prog[3];
  Frame f{planes, rows, smem, smem + static_cast<size_t>(n_slots) * B, K, B, 0};
  const int* carry_src = prog + kHeader;
  const int* records = carry_src + n_carry;

  for (int i = 0; i < n_carry; ++i)
    for (int t = threadIdx.x; t < B; t += blockDim.x)
      f.carry[i * B + t] = rows[(n_ext + i) * B + t];

  for (int k = 0; k < K; ++k) {
    f.k = k;
    for (int j = 0; j < p; ++j) {
      const int* r = prog + records[j];
      const int op = r[0], arg = r[1], n_out = r[4], srow = r[5];
      const int in_tab = r[6], par_tab = r[7], out_tab = r[8];
      switch (op) {
        case kOpConstant:
          for (int t = threadIdx.x; t < B; t += blockDim.x)
            emit(f, prog, out_tab, 0, t, param(f, prog, par_tab, 0, t), out);
          break;
        case kOpMath:
          for (int c = 0; c < n_out; ++c)
            for (int t = threadIdx.x; t < B; t += blockDim.x)
              emit(f, prog, out_tab, c, t,
                   binop(arg, input(f, prog, in_tab, c, t),
                         input(f, prog, in_tab, c + n_out, t)),
                   out);
          break;
        case kOpMath1:
          for (int c = 0; c < n_out; ++c)
            for (int t = threadIdx.x; t < B; t += blockDim.x)
              emit(f, prog, out_tab, c, t, unop(arg, input(f, prog, in_tab, c, t)), out);
          break;
        case kOpSinWt: {
          // the fast program's no-reset path: phase_t = ph0 + sum(inc[0:t])
          const uint32_t ph0 = state[srow * K + k];
          uint32_t running = 0u;
          for (int t0 = 0; t0 < B; t0 += blockDim.x) {
            const int t = t0 + threadIdx.x;
            const bool live = t < B;
            uint32_t inc = 0u;
            float poff = 0.0f;
            if (live) {
              inc = inc_u32(__fmul_rn(param(f, prog, par_tab, 0, t), f2pi));
              poff = param(f, prog, par_tab, 1, t);
            }
            uint32_t total;
            const uint32_t incl = block_scan_u32(inc, scratch, &total);
            if (live) {
              const uint32_t off = inc_u32(__fmul_rn(poff, kFractionalPart));
              emit(f, prog, out_tab, 0, t,
                   sin_quant(ph0 + running + incl - inc + off, scale), out);
            }
            running += total;
          }
          if (threadIdx.x == 0) state_out[srow * K + k] = ph0 + running;
          break;
        }
        default:
          break;
      }
    }
    // the stage's carried outputs become the next stage's carry rows
    for (int i = 0; i < n_carry; ++i)
      for (int t = threadIdx.x; t < B; t += blockDim.x)
        f.carry[i * B + t] = f.slots[carry_src[i] * B + t];
  }
}

}  // namespace

extern "C" {

// Runs one chain over one block on `stream`; returns cudaGetLastError().
// smem_floats = (n_slots + n_carry) * B, from the program's header.
int ktt_chain_kernel(const int* prog, const float* planes, const uint32_t* state,
                     const float* rows, float* out, uint32_t* state_out, int K, int B,
                     int smem_floats, float f2pi, float scale, void* stream) {
  if (K < 1 || B < 1 || smem_floats < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_kernel<<<1, stage_threads(B), smem, static_cast<cudaStream_t>(stream)>>>(
      prog, planes, state, rows, out, state_out, K, B, f2pi, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
