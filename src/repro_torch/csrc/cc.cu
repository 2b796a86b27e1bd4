// Connected components for Hopper (sm_90a): a whole `cc_labels` call, the
// chunk loop included, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/cc/cc.py:cc_rounds_pallas (body
// _cc_rounds_kernel) together with the loop that drove it
// (src/repro/kernels/cc/ops.py:_drive_chunks, a lax.while_loop on the
// device).  The TPU kernel kept the labels and both ELL neighbour blocks in
// VMEM and ran `rounds` rounds of
//
//   l1 = min(l,  min over out-neighbours u of l[u])
//   l2 = min(l1, min over in-neighbours  u of l1[u])
//   l3 = l2[l2]
//
// returning the labels and a flag set if any round changed any label.
//
// Formulation here: the plain version's own scatter-min over the live
// edges.  The wrapper compacts the graph into an edge list once per call,
// each edge a (src, dst) pair of int32 whose dst carries two flag bits:
//
//   step 1  l1 = l;  atomicMin(l1[src], l[dst])   (edges without IN_ONLY)
//   step 2  l2 = l1; atomicMin(l2[dst], l1[src])  (edges without OUT_ONLY)
//   step 3  l3 = l2[l2]; changed |= l3 != l
//
// The min is order-free on int32, so the labels are exact whatever order
// the atomics land in.  An out-neighbour column >= n is clamped to n - 1
// and flagged OUT_ONLY (it takes part in the out-hook only: the TPU
// kernel clamps it there, and its ELL transpose drops it); the
// `cc_rounds` entry passes an explicit in-neighbour ELL as IN_ONLY edges.
//
// Buffers: l (the labels), l1, and two l2 buffers used in turn.  Step 1
// lowers l1 and the round's l2 together (both start equal to l), so l2
// needs no copy of l1; step 3 writes l3 into l, l1 and the *other* l2
// buffer, which no step of this round reads.  So a round is three
// barrier-separated steps and no copy.
//
// What bounds it on this card: not bytes (the whole state is a few MB, read
// once) but the dependent chain: rounds x 3 barriers, each behind a pass
// over the live edges or the vertices.  The design cuts what each barrier
// costs:
//   * one launch per call: the chunk rule runs on the device (8-round
//     chunks while the chunk's changed flag is set and fewer than n_chunks
//     ran, then at most one `rem`-round tail), so the host reads the
//     rounds executed and the chunks once, after the launch;
//   * block path: when 16 B a vertex plus 8 B an edge fit in one block's
//     shared memory, one block of 1024 threads holds the whole state and
//     the steps are separated by __syncthreads (the chunk's changed flag by
//     __syncthreads_or);
//   * grid path: otherwise a cooperative launch (every block resident, the
//     grid sized from the occupancy calculator) separates the steps by
//     grid.sync(); the chunk's changed flag is an atomicOr into one of two
//     device ints used in turn, read after the chunk's last grid.sync, the
//     other one zeroed after the next chunk's first grid.sync.  Labels that
//     other blocks write are read with __ldcg (at L2, past the SM's L1).
// Each step walks only the live edges (step 1, 2) or the vertices (step 3),
// one a thread at a time (four in flight a thread measured slower on both
// paths).  The grid path runs blocks of 1024 threads, one an SM at the
// chain's size, so fewer blocks arrive at each grid barrier (faster than
// 256 on the chain).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t OUT_ONLY = 1u << 31;
constexpr uint32_t IN_ONLY = 1u << 30;
constexpr uint32_t IDX = IN_ONLY - 1;
constexpr int BLOCK_THREADS = 1024;
constexpr int GRID_THREADS = 1024;
constexpr int MAX_SHARED = 232448;

// the block path keeps everything in its own shared memory: plain loads;
// the grid path reads labels other blocks wrote this launch at L2
template <bool GRID>
__device__ __forceinline__ int ld(const int* p) {
  if (GRID) return __ldcg(p);
  return *p;
}

// The three steps of one round over [first, end) with `stride`; l2 is the
// round's l2 buffer, l2n the next round's.  step3 returns whether it
// changed a label of this thread's vertices.
template <bool GRID>
__device__ __forceinline__ void step1(const uint2* e, int m, const int* l,
                                      int* l1, int* l2, int first,
                                      int stride) {
  for (int i = first; i < m; i += stride) {
    const uint2 x = e[i];
    if (x.y & IN_ONLY) continue;
    const int v = ld<GRID>(l + (x.y & IDX));
    atomicMin(l1 + x.x, v);
    atomicMin(l2 + x.x, v);
  }
}

template <bool GRID>
__device__ __forceinline__ void step2(const uint2* e, int m, const int* l1,
                                      int* l2, int first, int stride) {
  for (int i = first; i < m; i += stride) {
    const uint2 x = e[i];
    if (x.y & OUT_ONLY) continue;
    atomicMin(l2 + (x.y & IDX), ld<GRID>(l1 + x.x));
  }
}

template <bool GRID>
__device__ __forceinline__ bool step3(int n, int* l, int* l1, const int* l2,
                                      int* l2n, int first, int stride) {
  bool chg = false;
  for (int v = first; v < n; v += stride) {
    const int l3 = ld<GRID>(l2 + ld<GRID>(l2 + v));
    chg |= l3 != ld<GRID>(l + v);
    l[v] = l3;
    l1[v] = l3;
    l2n[v] = l3;
  }
  return chg;
}

// Block path: the whole state in shared memory, one block.
__global__ void __launch_bounds__(BLOCK_THREADS)
cc_block_kernel(const uint2* __restrict__ edges, int m, int* labels, int n,
                int rounds, int n_chunks, int rem, int* info) {
  extern __shared__ int smem[];
  int* l = smem;
  int* l1 = l + n;
  int* const l2a = l1 + n;
  int* const l2c = l1 + 2 * n;
  uint2* e = reinterpret_cast<uint2*>(l1 + 3 * n);  // 16n bytes: aligned
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int v = tid; v < n; v += nt) {
    const int x = labels[v];
    l[v] = x;
    l1[v] = x;
    l2a[v] = x;
  }
  for (int i = tid; i < m; i += nt) e[i] = edges[i];
  __syncthreads();

  int iters = 0, chunks = 0, cur = 0;
  bool changed = true;
  auto chunk = [&](int r_count) {
    bool chg = false;
    for (int r = 0; r < r_count; ++r) {
      int* l2 = cur ? l2c : l2a;
      step1<false>(e, m, l, l1, l2, tid, nt);
      __syncthreads();
      step2<false>(e, m, l1, l2, tid, nt);
      __syncthreads();
      chg |= step3<false>(n, l, l1, l2, cur ? l2a : l2c, tid, nt);
      cur ^= 1;
      if (r + 1 < r_count) __syncthreads();
    }
    return __syncthreads_or(chg) != 0;
  };
  while (changed && chunks < n_chunks) {
    changed = chunk(rounds);
    iters += rounds;
    ++chunks;
  }
  if (rem > 0 && changed) {
    changed = chunk(rem);
    iters += rem;
    ++chunks;
  }
  for (int v = tid; v < n; v += nt) labels[v] = l[v];
  if (tid == 0) {
    info[0] = iters;
    info[1] = chunks;
    info[2] = changed;
  }
}

// Grid path: the labels (`labels`, in place) and l1, l2, l2' (`scratch`,
// 3n ints) in device memory, every block resident.
__global__ void __launch_bounds__(GRID_THREADS)
cc_grid_kernel(const uint2* __restrict__ edges, int m, int* labels,
               int* scratch, int n, int rounds, int n_chunks, int rem,
               int* flags, int* info) {
  cg::grid_group grid = cg::this_grid();
  int* l = labels;
  int* l1 = scratch;
  int* const l2a = scratch + n;
  int* const l2c = scratch + 2 * n;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int v = first; v < n; v += stride) {
    const int x = l[v];
    l1[v] = x;
    l2a[v] = x;
  }
  grid.sync();

  int iters = 0, chunks = 0, cur = 0;
  bool changed = true;
  auto chunk = [&](int r_count, int c) {
    bool chg = false;
    for (int r = 0; r < r_count; ++r) {
      int* l2 = cur ? l2c : l2a;
      step1<true>(edges, m, l, l1, l2, first, stride);
      grid.sync();
      // every thread read the previous chunk's flag before this barrier
      if (r == 0 && first == 0) flags[(c + 1) & 1] = 0;
      step2<true>(edges, m, l1, l2, first, stride);
      grid.sync();
      chg |= step3<true>(n, l, l1, l2, cur ? l2a : l2c, first, stride);
      cur ^= 1;
      if (r + 1 == r_count && __any_sync(0xffffffffu, chg) &&
          (threadIdx.x & 31) == 0)
        atomicOr(flags + (c & 1), 1);
      grid.sync();
    }
    return __ldcg(flags + (c & 1)) != 0;
  };
  while (changed && chunks < n_chunks) {
    changed = chunk(rounds, chunks);
    iters += rounds;
    ++chunks;
  }
  if (rem > 0 && changed) {
    changed = chunk(rem, chunks);
    iters += rem;
    ++chunks;
  }
  if (first == 0) {
    info[0] = iters;
    info[1] = chunks;
    info[2] = changed;
  }
}

}  // namespace

// Bytes of shared memory the block path needs for n vertices and m edges.
extern "C" long long cc_block_bytes(int n, int m) {
  return 16LL * n + 8LL * m;
}

// One launch of a whole call.  path 0: the block path (needs
// cc_block_bytes(n, m) <= 232448); path 1: the cooperative grid path
// (`scratch` 3n ints; `flags` two ints, zero).  `info` receives the rounds
// executed, the chunks run and the last chunk's changed flag.
extern "C" int cc_launch(const void* edges, int m, void* labels,
                         void* scratch, void* flags, void* info, int n,
                         int rounds, int n_chunks, int rem, int path,
                         void* stream) {
  if (n <= 0 || m < 0 || rounds < 1 || n_chunks < 0 || rem < 0 ||
      n > static_cast<int>(IDX))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const uint2* e = static_cast<const uint2*>(edges);
  int* lab = static_cast<int*>(labels);
  int* inf = static_cast<int*>(info);
  cudaError_t err;
  if (path == 0) {
    const long long bytes = cc_block_bytes(n, m);
    if (bytes > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(cc_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cc_block_kernel<<<1, BLOCK_THREADS, static_cast<size_t>(bytes), st>>>(
        e, m, lab, n, rounds, n_chunks, rem, inf);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cc_grid_kernel, GRID_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long work = n > m ? n : m;
  const long long want = (work + GRID_THREADS - 1) / GRID_THREADS;
  const long long cap = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  int* scr = static_cast<int*>(scratch);
  int* flg = static_cast<int*>(flags);
  void* args[] = {&e, &m, &lab, &scr, &n, &rounds, &n_chunks, &rem,
                  &flg, &inf};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cc_grid_kernel),
                                    dim3(blocks), dim3(GRID_THREADS), args, 0,
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
