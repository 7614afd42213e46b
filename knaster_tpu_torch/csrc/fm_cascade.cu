// The fused N-stage FM cascade for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/fm_cascade.py.
//
// Replaces knaster_tpu/models/voices.py::FMCascade._process_pallas (kernel
// :661). Stage 0 runs at `freq`; stage k at base + depth * out[k-1]. Each
// stage turns its frequency row into u32 phase increments, takes their
// prefix sum from the stage's carried phase, and outputs the sine of the
// 16384-grid table index; the last stage's row times `amp` is the block.
// The four params arrive at block rate (params[0..3] = freq, base, depth,
// amp, as the Pallas kernel reads params[...][0] into SMEM); the N phases
// are read and written in place.
//
// What bounds it: the N dependent stages. A stage is one block scan of the
// increments and one sine a sample, and no stage can start before the one
// before it ends, so the time is N times a stage's latency; the card's
// arithmetic rate and bandwidth are far from the limit (N phase words a
// launch). One CTA on one SM takes every sample of a long block in turn: at
// 8192 samples, 8 rounds of 1024 threads a stage. What the design does
// about it:
// - layouts (launch_plan in kernels/fm_cascade.py): one CTA for short
//   blocks, one thread a sample; past that a thread-block cluster of C CTAs
//   on neighbouring SMs (up to 16), CTA r owning the contiguous slice
//   [r * chunk, (r + 1) * chunk) of the samples and that slice of the row in
//   its own shared memory. Stage k's modulator at sample t is stage k - 1's
//   output at the same t, so the row never crosses CTAs: once a stage only
//   the CTAs' increment totals cross, through distributed shared memory, by
//   a look-back (Exchange): a CTA publishes its total and reads those of the
//   CTAs before it, with no cluster barrier a stage (faster than the chain
//   kernel's exchange behind a cluster barrier, csrc/chain_kernel.cu
//   exchange_u32, at clusters of 8 and 16, slower at 2 and 4 on short
//   blocks: PERF.md §6).
//   u32 sums are exact modulo 2^32, so the slice's prefix
//   offset by the totals of the slices before it is the one-CTA scan's
//   prefix bit for bit, whatever the split;
// - one barrier a scan (scan_u32): each warp sums the warp totals itself,
//   from one of two alternating buffers, where the shared block_scan_u32
//   takes three;
// - the sine of the 16384-grid index from a table of sinf(idx * scale) for
//   every idx, 64 KB of shared memory filled at the kernel's start from the
//   launch's scale: the same sinf of the same rounded argument, bit for
//   bit, read instead of evaluated a sample. Filling it costs 16384 sinf a
//   CTA, so the kernel takes it only where a CTA's cascade evaluates many
//   more (use_table), and only where it fits beside the row: the one-CTA
//   layout's longest row is as long as before less the second scan buffer,
//   and the blocks past it up to MAX_BLOCK take a cluster;
// - one CTA takes a round's sines right after its scan, as the earlier
//   one-CTA design did; a cluster's CTAs keep each round's prefixes (the
//   first round's in a register, later rounds' in the row) until the
//   offset arrives. No __launch_bounds__: with it ptxas kept a stack frame for
//   sinf and the kernel ran up to 1.2x slower (PERF.md §6).
// The Pallas kernel's Hillis-Steele lane cumsum is the TPU's form of the
// scan and is not carried over.
//
// Numerics. Built with --fmad=false and no fast math: every multiply and add
// rounds on its own (written out as __fmul_rn / __fadd_rn besides), as in
// fm_cascade_plain, and sinf is the accurate library sine, so the phases and
// the block are bit-equal to the plain version's in every layout.

#include <cooperative_groups.h>

#include "stage_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ktt;

constexpr int kTable = 16384;  // TABLE_SIZE: one sinf per grid index
// dynamic shared memory a CTA may take (232,448 bytes), less the static
// scan scratch
constexpr int kSmemLimit = 227 * 1024 - 2 * 32 * 4;
constexpr int kPortableCluster = 8, kMaxCluster = 16;

// The block-wide inclusive u32 prefix sum (wrap-around) with one barrier:
// each warp scans its lanes by shuffles and writes its total to
// scratch[buf][warp]; after the barrier every warp loads the warp totals and
// scans them by shuffles itself, so there is no second pass over them. The
// two buffers alternate (buf flips), so a buffer is written again only
// after the next scan's barrier, which every thread reaches after its reads
// of this one. Every thread of the CTA calls it; *total is the CTA's sum.
__device__ __forceinline__ uint32_t scan_u32(uint32_t v, uint32_t* scratch, int& buf,
                                             uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint32_t* tot = scratch + 32 * buf;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  uint32_t w = lane < n_warps ? tot[lane] : 0u;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, w, d);
    if (lane >= d) w += up;
  }
  const uint32_t before = __shfl_sync(0xffffffffu, w, warp > 0 ? warp - 1 : 0);
  *total = __shfl_sync(0xffffffffu, w, n_warps - 1);
  buf ^= 1;
  return warp > 0 ? v + before : v;
}

// exchange: begin
// The CTAs' totals of one stage (cluster layout) by look-back: each CTA
// publishes its total, tagged with the stage, in a slot of its own shared
// memory (a release at cluster scope), and every warp reads the tagged
// totals of the CTAs before it through distributed shared memory, one lane
// a CTA (an acquire, again until the tag is the stage's), then sums them by
// shuffles: no barrier, and a CTA waits only for the CTAs before it. The
// kRing slots are reused every kRing stages, after a cluster barrier by
// which every CTA has read them.
constexpr int kRing = 64;
constexpr int kExchangeWords = 2 * kRing;

struct Exchange {
  uint32_t* words;  // kExchangeWords words of this CTA's shared memory

  __device__ unsigned long long* ring() const {
    return reinterpret_cast<unsigned long long*>(words);
  }
  // every thread of the cluster, before the first stage: no slot holds a tag
  __device__ void open() {
    for (int j = threadIdx.x; j < kRing; j += blockDim.x) ring()[j] = 0ull;
    cg::this_cluster().sync();
  }
  // every thread of the cluster, once a stage: the totals of the CTAs
  // before this one; *all the total over the cluster (valid in the last CTA)
  __device__ uint32_t offset(int k, int rank, uint32_t total, uint32_t* all) {
    unsigned long long* slot = ring() + k % kRing;
    const uint32_t tag = static_cast<uint32_t>(k) + 1u;
    if (threadIdx.x == 0) {
      const unsigned long long v = (static_cast<unsigned long long>(tag) << 32) | total;
      asm volatile("st.release.cluster.u64 [%0], %1;" ::"l"(slot), "l"(v) : "memory");
    }
    const int lane = threadIdx.x & 31;
    uint32_t u = 0u;
    if (lane < rank) {
      const unsigned long long* src = cg::this_cluster().map_shared_rank(slot, lane);
      unsigned long long v;
      uint32_t tries = 0u;
      do {
        // a total that never lands traps (a launch error) instead of hanging
        if (++tries == (1u << 28)) __trap();
        asm volatile("ld.acquire.cluster.u64 %0, [%1];" : "=l"(v) : "l"(src) : "memory");
      } while (static_cast<uint32_t>(v >> 32) != tag);
      u = static_cast<uint32_t>(v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
    *all = u + total;
    if (k % kRing == kRing - 1) cg::this_cluster().sync();
    return u;
  }
  // no CTA leaves while another may still read its slots
  __device__ void close() { cg::this_cluster().sync(); }
};
// exchange: end

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The dynamic shared memory of a CTA of `chunk` samples, in floats: the
// table (TABLE), the row (rounded up to 16 bytes) and, in a cluster, the
// exchange's words.
constexpr int smem_floats(bool cluster, bool table, int chunk) {
  return (table ? kTable : 0) + round4(chunk) + (cluster ? kExchangeWords : 0);
}

// Whether a CTA of `chunk` samples reads the sines from the table: where
// its N stages evaluate at least twice the table's sines (filling it takes
// 16384 sinf a CTA, which a short block's few threads pay in turn; measured
// on an H100, PERF.md §6), and the table fits beside the row.
bool use_table(bool cluster, int N, int chunk) {
  return static_cast<long long>(N) * chunk >= 2LL * kTable &&
         smem_floats(cluster, true, chunk) * static_cast<long long>(sizeof(float)) <= kSmemLimit;
}

template <bool CLUSTER, bool TABLE>
__global__ void fm_cascade_kernel(const float* __restrict__ params,
                                  uint32_t* __restrict__ phases, float* __restrict__ out,
                                  int N, int B, int chunk, float f2pi, float scale) {
  // [kTable] the sines (TABLE), then [chunk]: the previous stage's output
  // row (in a cluster, its words past the first round of blockDim samples
  // hold their samples' prefixes between the scan and the sines), then
  // (CLUSTER) the exchange's words
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t scratch[2 * 32];
  const float freq = params[0], base = params[1], depth = params[2], amp = params[3];
  int rank = 0, last = 0;  // this CTA's rank and the last CTA's
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    last = static_cast<int>(cg::this_cluster().num_blocks()) - 1;
  }
  const int c0 = rank * chunk;
  const int n = max(0, min(chunk, B - c0));  // this CTA's samples
  float* tab = smem;
  float* row = smem + (TABLE ? kTable : 0);
  uint32_t* pre = reinterpret_cast<uint32_t*>(row);
  if constexpr (TABLE) {
    // the first scan's barrier orders these before any read
    for (int j = threadIdx.x; j < kTable; j += blockDim.x)
      tab[j] = sinf(__fmul_rn(static_cast<float>(j), scale));
  }
  // the sine of the table index of a u32 phase
  auto sine = [&](uint32_t phase) {
    const uint32_t idx = (phase >> 16) & kTableHighMask;
    return TABLE ? tab[idx] : sinf(__fmul_rn(static_cast<float>(idx), scale));
  };
  Exchange xg{reinterpret_cast<uint32_t*>(row + round4(chunk))};
  if constexpr (CLUSTER) xg.open();
  int buf = 0;
  for (int k = 0; k < N; ++k) {
    const uint32_t ph0 = phases[k];
    uint32_t running = 0u;  // the increments of this CTA's earlier rounds
    uint32_t excl0 = 0u;    // (CLUSTER) this thread's prefix in the first round
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const bool live = i < n;
      uint32_t inc = 0u;
      if (live) {
        const float f = k == 0 ? freq : __fadd_rn(base, __fmul_rn(depth, row[i]));
        inc = inc_i32_sat(__fmul_rn(f, f2pi));
      }
      uint32_t total;
      const uint32_t excl = running + scan_u32(inc, scratch, buf, &total) - inc;
      if constexpr (CLUSTER) {
        // the sines wait for the offset of the CTAs before this one
        if (i0 == 0) {
          excl0 = excl;
        } else if (live) {
          pre[i] = excl;
        }
      } else if (live) {
        row[i] = sine(ph0 + excl);
      }
      running += total;
    }
    uint32_t all = running;
    if constexpr (CLUSTER) {
      const uint32_t first = ph0 + xg.offset(k, rank, running, &all);
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        row[i] = sine(first + (i < static_cast<int>(blockDim.x) ? excl0 : pre[i]));
    }
    if (rank == last && threadIdx.x == 0) phases[k] = ph0 + all;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[c0 + i] = __fmul_rn(row[i], amp);
  if constexpr (CLUSTER) xg.close();
}

using CascadeKernel = void (*)(const float*, uint32_t*, float*, int, int, int, float, float);

CascadeKernel pick_kernel(bool cluster, bool table) {
  return cluster ? (table ? fm_cascade_kernel<true, true> : fm_cascade_kernel<true, false>)
                 : (table ? fm_cascade_kernel<false, true> : fm_cascade_kernel<false, false>);
}

// Lets the kernel take kSmemLimit bytes of dynamic shared memory and a
// non-portable cluster, once per kernel, not before every launch
cudaError_t opt_in(bool cluster, bool table) {
  static bool done[2][2] = {};
  if (done[cluster][table]) return cudaSuccess;
  const CascadeKernel kernel = pick_kernel(cluster, table);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done[cluster][table] = err == cudaSuccess;
  return err;
}

cudaLaunchConfig_t launch_config(int cluster, int threads, int smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
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
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

extern "C" {

// Runs the cascade over one block on `stream` in the layout the host planned
// (kernels/fm_cascade.py launch_plan): `cluster` CTAs (1: one CTA, no
// cluster) of `chunk` samples each, the last ones holding what is left of
// the B (chunk = B for one CTA). Returns the launch's error
// (cudaLaunchKernelEx's, else cudaGetLastError()'s): a cluster the card
// cannot schedule never runs and is reported, never replaced by another
// layout.
int ktt_fm_cascade(const float* params, uint32_t* phases, float* out, int N, int B,
                   int cluster, int chunk, float f2pi, float scale, void* stream) {
  if (N < 1 || B < 1 || cluster < 1 || cluster > kMaxCluster || chunk < 1 ||
      static_cast<long long>(cluster) * chunk < B || (cluster == 1 && chunk != B) ||
      smem_floats(cluster > 1, false, chunk) * static_cast<long long>(sizeof(float)) >
          kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool table = use_table(cluster > 1, N, chunk);
  const int smem = smem_floats(cluster > 1, table, chunk) * static_cast<int>(sizeof(float));
  const int threads = stage_threads(chunk);
  cudaError_t err = opt_in(cluster > 1, table);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, threads, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, pick_kernel(cluster > 1, table), params, phases, out, N, B,
                           chunk, f2pi, scale);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The largest cluster the plan may take on this card: 16 where a
// non-portable cluster of 16 CTAs of 1024 threads and the largest shared
// memory a launch takes can be resident (cudaOccupancyMaxActiveClusters),
// else the portable 8. Returns a CUDA error, 0 on success.
int ktt_fm_cascade_max_cluster(int* max_cluster) {
  const CascadeKernel kernel = fm_cascade_kernel<true, true>;
  cudaError_t err = opt_in(true, true);
  int clusters = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(kMaxCluster, 1024, kSmemLimit, nullptr, attr);
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  }
  cudaGetLastError();
  *max_cluster = err == cudaSuccess && clusters >= 1 ? kMaxCluster : kPortableCluster;
  return 0;
}

}  // extern "C"
