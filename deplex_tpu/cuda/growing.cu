// Region-growing rounds (stage 3) as one CUDA thread block per frame.
//
// Computes the same RoundData decisions as ops/growing.py:grow_rounds: for
// every round, the dominant normals-histogram bin (first-max tie-break), its
// minimum-MSE cell as the seed (first-min tie-break), and the seed's flood
// fill over the admissibility edges within the still-unassigned cells. The
// grown region is an order-independent reachability set, so a parallel
// breadth-first search gives exactly the XLA loop's region.
//
// Layout (per block, in shared memory):
//   hist        int32[nbins2]      live cell count per histogram bin, kept
//                                  eagerly: a claimed cell decrements its bin
//   unassigned  uint32[ceil(n/32)] one bit per cell; claiming a cell clears
//                                  its bit with atomicAnd, so each cell joins
//                                  exactly one region
//   bins        int16[n]           histogram bin, -1 once consumed
//   edges       uint8[n]           bit k: the neighbour in direction k may
//                                  activate this cell (up, down, left, right)
//   queue       uint16[n]          breadth-first worklist of one round; in
//                                  global scratch when shared memory is short
// `mse` stays in global memory (L2-resident) and is read only for the
// candidates of a round's dominant bin. `round_map` is written straight to
// global memory when a cell is claimed.
//
// Build: python -m deplex_tpu.cuda  (nvcc, sm_90a; output under build/).

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 226 * 1024;  // of the 227 KB a block may opt in to

// Bits of the packed per-cell flags input (ops/growing.py:pack_flags).
constexpr uint8_t kFromUp = 1, kFromDown = 2, kFromLeft = 4, kFromRight = 8;
constexpr uint8_t kPlanar = 16;

struct Layout {
  size_t hist, unassigned, bins, edges, queue, total_with_queue, total;
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

__host__ __device__ inline Layout make_layout(int n, int nbins2) {
  Layout l;
  l.hist = 0;
  l.unassigned = align_up(l.hist + sizeof(int) * nbins2, 16);
  l.bins = align_up(l.unassigned + sizeof(uint32_t) * ((n + 31) / 32), 16);
  l.edges = align_up(l.bins + sizeof(int16_t) * n, 16);
  l.queue = align_up(l.edges + n, 16);
  l.total = l.queue;
  l.total_with_queue = align_up(l.queue + sizeof(uint16_t) * n, 16);
  return l;
}

// Block-wide arg-reductions. Every thread passes its candidate; every thread
// receives the winner. `first max` / `first min`: ties go to the lower index.
__device__ inline bool max_wins(int v, int i, int bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ inline bool min_wins(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ void block_argmax(int& v, int& i, int* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    int ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (max_wins(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : INT32_MIN;
    i = lane < kWarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      int ov = __shfl_down_sync(0xffffffffu, v, off);
      int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (max_wins(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[kWarps] = v; si[kWarps] = i; }
  }
  __syncthreads();
  v = sv[kWarps];
  i = si[kWarps];
  __syncthreads();
}

__device__ void block_argmin(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (min_wins(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : __int_as_float(0x7f800000);
    i = lane < kWarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, v, off);
      int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (min_wins(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[kWarps] = v; si[kWarps] = i; }
  }
  __syncthreads();
  v = sv[kWarps];
  i = si[kWarps];
  __syncthreads();
}

__device__ int block_sum(int v, int* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s[kWarps] = v;
  }
  __syncthreads();
  v = s[kWarps];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
grow_rounds_kernel(const int32_t* __restrict__ bins_in,
                   const float* __restrict__ mse_in,
                   const uint8_t* __restrict__ flags_in,
                   int32_t* __restrict__ round_map, int32_t* __restrict__ seeds,
                   int32_t* __restrict__ nr_rounds,
                   uint16_t* __restrict__ gqueue, int gh, int gw, int r_max,
                   int nbins2, int min_candidates, bool queue_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red_i[kWarps + 1];
  __shared__ int red_j[kWarps + 1];
  __shared__ float red_f[kWarps + 1];
  __shared__ int s_tail;

  const int n = gh * gw;
  const int tid = threadIdx.x;
  const size_t frame = blockIdx.x;
  bins_in += frame * n;
  mse_in += frame * n;
  flags_in += frame * n;
  round_map += frame * n;
  seeds += frame * r_max;

  const Layout lay = make_layout(n, nbins2);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  uint32_t* unassigned = reinterpret_cast<uint32_t*>(smem + lay.unassigned);
  int16_t* bins = reinterpret_cast<int16_t*>(smem + lay.bins);
  uint8_t* edges = smem + lay.edges;
  uint16_t* queue = queue_in_smem ? reinterpret_cast<uint16_t*>(smem + lay.queue)
                                  : gqueue + frame * n;

  for (int i = tid; i < nbins2; i += kThreads) hist[i] = 0;
  for (int w = tid; w < (n + 31) / 32; w += kThreads) unassigned[w] = 0u;
  for (int r = tid; r < r_max; r += kThreads) seeds[r] = n;
  __syncthreads();

  int planar = 0;
  for (int i = tid; i < n; i += kThreads) {
    const int b = bins_in[i];
    const uint8_t f = flags_in[i];
    const int16_t bs = (b >= 0 && b < nbins2) ? static_cast<int16_t>(b) : -1;
    bins[i] = bs;
    edges[i] = f & (kFromUp | kFromDown | kFromLeft | kFromRight);
    round_map[i] = -1;
    if (f & kPlanar) {
      atomicOr(&unassigned[i >> 5], 1u << (i & 31));
      ++planar;
    }
    if (bs >= 0) atomicAdd(&hist[bs], 1);
  }
  int remaining = block_sum(planar, red_i);  // also a barrier for hist/bins

  const float inf = __int_as_float(0x7f800000);
  int round = 0;
  bool stop = false;
  while (remaining > 0 && !stop && round < r_max) {
    // 1. Dominant bin of the live cells.
    int cnt = INT32_MIN, mf = INT32_MAX;
    for (int i = tid; i < nbins2; i += kThreads) {
      if (max_wins(hist[i], i, cnt, mf)) { cnt = hist[i]; mf = i; }
    }
    block_argmax(cnt, mf, red_i, red_j);
    stop = cnt < min_candidates;

    // 2. Seed: the candidate with the least MSE (all-inf gives cell 0,
    // as jnp.argmin does).
    float best = inf;
    int seed = INT32_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float v = bins[i] == mf ? mse_in[i] : inf;
      if (min_wins(v, i, best, seed)) { best = v; seed = i; }
    }
    block_argmin(best, seed, red_f, red_j);

    // 3. Flood fill: breadth-first search, claiming cells as it goes.
    auto claim = [&](int c) -> bool {
      const uint32_t bit = 1u << (c & 31);
      if (!(unassigned[c >> 5] & bit)) return false;
      if (!(atomicAnd(&unassigned[c >> 5], ~bit) & bit)) return false;
      const int16_t b = bins[c];
      bins[c] = -1;
      if (b >= 0) atomicSub(&hist[b], 1);
      round_map[c] = round;
      return true;
    };
    if (tid == 0) {
      seeds[round] = seed;
      s_tail = 0;
      if (!stop && claim(seed)) {
        queue[0] = static_cast<uint16_t>(seed);
        s_tail = 1;
      }
    }
    __syncthreads();
    int lo = 0;
    while (true) {
      const int hi = s_tail;
      __syncthreads();
      if (lo == hi) break;
      for (int k = lo + tid; k < hi; k += kThreads) {
        const int c = queue[k];
        const int r = c / gw, col = c - r * gw;
        int nb[4];
        int m = 0;
        // A neighbour n joins when its edge from c's direction is set.
        if (r + 1 < gh && (edges[c + gw] & kFromUp)) nb[m++] = c + gw;
        if (r > 0 && (edges[c - gw] & kFromDown)) nb[m++] = c - gw;
        if (col + 1 < gw && (edges[c + 1] & kFromLeft)) nb[m++] = c + 1;
        if (col > 0 && (edges[c - 1] & kFromRight)) nb[m++] = c - 1;
        for (int j = 0; j < m; ++j) {
          if (claim(nb[j])) queue[atomicAdd(&s_tail, 1)] = static_cast<uint16_t>(nb[j]);
        }
      }
      __syncthreads();
      lo = hi;
    }

    // 4. Book-keeping (uniform across the block: every thread read s_tail
    // after the last barrier).
    remaining -= lo;
    ++round;
  }
  if (tid == 0) nr_rounds[frame] = round;
}

ffi::Error GrowRoundsImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> bins,
                          ffi::Buffer<ffi::F32> mse, ffi::Buffer<ffi::U8> flags,
                          ffi::ResultBuffer<ffi::S32> round_map,
                          ffi::ResultBuffer<ffi::S32> seeds,
                          ffi::ResultBuffer<ffi::S32> nr_rounds,
                          ffi::ResultBuffer<ffi::U16> scratch, int64_t r_max,
                          int64_t nbins2, int64_t min_candidates) {
  const auto dims = bins.dimensions();
  if (dims.size() < 2) {
    return ffi::Error::InvalidArgument("grow_rounds: bins must be (..., gh, gw)");
  }
  const int64_t gh = dims[dims.size() - 2], gw = dims[dims.size() - 1];
  const int64_t n = gh * gw;
  if (n == 0 || bins.element_count() == 0) return ffi::Error::Success();
  if (n > 65535) {
    return ffi::Error::InvalidArgument("grow_rounds: grid has more than 65535 cells");
  }
  if (nbins2 <= 0 || nbins2 > 32767) {
    return ffi::Error::InvalidArgument("grow_rounds: histogram size out of range");
  }
  const int64_t frames = bins.element_count() / n;
  const Layout lay = make_layout(static_cast<int>(n), static_cast<int>(nbins2));
  const bool queue_in_smem = lay.total_with_queue <= kSmemLimit;
  const size_t smem = queue_in_smem ? lay.total_with_queue : lay.total;
  if (smem > kSmemLimit) {
    return ffi::Error::InvalidArgument(
        "grow_rounds: cell grid needs " + std::to_string(smem) +
        " bytes of shared memory, more than a block may use");
  }
  cudaError_t err = cudaFuncSetAttribute(
      grow_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  grow_rounds_kernel<<<static_cast<unsigned>(frames), kThreads, smem, stream>>>(
      bins.typed_data(), mse.typed_data(), flags.typed_data(),
      round_map->typed_data(), seeds->typed_data(), nr_rounds->typed_data(),
      scratch->typed_data(), static_cast<int>(gh), static_cast<int>(gw),
      static_cast<int>(r_max), static_cast<int>(nbins2),
      static_cast<int>(min_candidates), queue_in_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DeplexGrowRounds, GrowRoundsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U16>>()
                                  .Attr<int64_t>("r_max")
                                  .Attr<int64_t>("nbins2")
                                  .Attr<int64_t>("min_candidates"));
