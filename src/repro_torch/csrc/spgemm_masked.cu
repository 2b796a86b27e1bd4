// Sampled min-plus product at a mask's pattern for Hopper (sm_90a):
//
//   out[i, q] = (+)_a A[i, a] (x) B[A.cols[i, a], b]
//               over the b with B.cols[A.cols[i, a], b] == M.cols[i, q],
//
// (x) the 2x2 orientation product out[2x+y] = min_c a[2x+c] + b[2c+y],
// (+) an elementwise fminf, +inf where nothing is found and in M's empty
// slots.  All three operands are ELL: column ids int32 (-1 empty, rows
// sorted ascending with the empty slots last, no column twice in a row),
// A's and B's values (4,) f32.  The fused transitive reduction squares R
// sampled at R's own pattern with it (A = B = M = R).
//
// Replaces no TPU kernel: the JAX package squares graphs wider than
// TR_DENSE_MAX_ROWS with the torch-ops ELL square (repro.core.spgemm:
// spgemm_masked), which materialises all K_A x K_B candidates of every row
// and reduces them once per mask slot.  This kernel computes the same
// function, bit for bit: one f32 rounding for each a + b, and a min over
// the orientation and the k slots, which gives the same bits in any order
// (no fast-math; no multiply exists that could contract into an FMA).
//
// What bounds it on this card: bytes and latency, not arithmetic.  Each
// product is 8 adds and 8 mins (its 4 and the fold's 4) on 16 bytes of B, and the least work reads
// A, M and the B rows that A selects once: at 14,863 reads and K = 40 all
// of R is ~12 MB, which sits in the 50 MB L2, so the walk is bounded by
// how many dependent L2 loads a warp keeps in flight.
//
// What the design does about it:
//   * one warp per output row i, no sort and no candidate buffer: the
//     row's live mask columns go to shared memory beside an accumulator of
//     K_M (4,) f32 set to +inf;
//   * for each live A slot (k = A.cols[i, a]) the lanes stride over B row
//     k, 32 slots a step, each a coalesced load of the columns and the
//     float4 values; UNROLL live A slots are loaded before any is folded,
//     so several B-row loads are in flight per warp; a step stops at the
//     first chunk past the row's live slots (empties last);
//   * each lane finds its column j among the mask row's by binary search
//     in shared memory and, where it is there at q, folds the product into
//     acc[q] with fminf.  No atomics: B row k holds each column once, so
//     within one A slot no two lanes touch the same q, and a __syncwarp
//     between A slots orders the rest.  The result does not depend on the
//     order of the walk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;  // live A slots whose B chunks are loaded together
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SHARED = 232448;
// shared bytes a mask slot takes in a warp: its column and its accumulator
constexpr int SLOT_BYTES = 4 + 16;

__device__ __forceinline__ float4 inf4() {
  const float inf = __int_as_float(0x7f800000);
  return make_float4(inf, inf, inf, inf);
}

__device__ __forceinline__ float4 mp_mul(float4 x, float4 y) {
  // [2x+y] = min(a[2x+0] + b[0+y], a[2x+1] + b[2+y])
  return make_float4(fminf(x.x + y.x, x.y + y.z), fminf(x.x + y.y, x.y + y.w),
                     fminf(x.z + y.x, x.w + y.z), fminf(x.z + y.y, x.w + y.w));
}

__device__ __forceinline__ float4 fmin4(float4 x, float4 y) {
  return make_float4(fminf(x.x, y.x), fminf(x.y, y.y), fminf(x.z, y.z),
                     fminf(x.w, y.w));
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                     __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// Slot of column j among the n sorted live columns mc[0..n), or -1.
__device__ __forceinline__ int find_col(const int* mc, int n, int j) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mc[mid] < j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return (lo < n && mc[lo] == j) ? lo : -1;
}

// Dynamic shared memory: WARPS x km float4 accumulators, then WARPS x km
// int mask columns.
__global__ void __launch_bounds__(THREADS)
spgemm_masked_kernel(const int* __restrict__ a_cols,
                     const float4* __restrict__ a_vals,
                     const int* __restrict__ b_cols,
                     const float4* __restrict__ b_vals,
                     const int* __restrict__ m_cols, float4* __restrict__ out,
                     int n, int ka, int nb, int kb, int km) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + w;
  if (row >= n) return;  // a whole warp; the block has no barrier
  float4* acc = smem + static_cast<size_t>(w) * km;
  int* mc = reinterpret_cast<int*>(smem + static_cast<size_t>(WARPS) * km) +
            static_cast<size_t>(w) * km;

  // the mask row's columns (its live ones a prefix) and +inf accumulators
  const int* mrow = m_cols + static_cast<size_t>(row) * km;
  int n_m = 0;
  for (int q0 = 0; q0 < km; q0 += 32) {
    const int q = q0 + lane;
    int c = -1;
    if (q < km) {
      c = mrow[q];
      mc[q] = c;
      acc[q] = inf4();
    }
    n_m += __popc(__ballot_sync(FULL, c >= 0));
  }
  __syncwarp();

  const int* arow = a_cols + static_cast<size_t>(row) * ka;
  const float4* avrow = a_vals + static_cast<size_t>(row) * ka;
  for (int a0 = 0; a0 < ka && n_m > 0; a0 += 32) {
    const int a = a0 + lane;
    int k = a < ka ? arow[a] : -1;
    if (k >= nb) k = -1;  // a column past B's rows selects nothing
    const float4 av = k >= 0 ? avrow[a] : inf4();
    unsigned live = __ballot_sync(FULL, k >= 0);  // the same in every lane
    while (live) {
      int ks[UNROLL];
      float4 xs[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ks[u] = -1;
        xs[u] = inf4();
        if (live) {
          const int t = __ffs(live) - 1;
          live &= live - 1;
          ks[u] = __shfl_sync(FULL, k, t);
          xs[u] = shfl4(av, t);
        }
      }
      for (int b0 = 0; b0 < kb; b0 += 32) {
        const int b = b0 + lane;
        int j[UNROLL];
        float4 y[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          j[u] = -1;
          y[u] = inf4();
          if (ks[u] >= 0 && b < kb) {
            const size_t bi = static_cast<size_t>(ks[u]) * kb + b;
            j[u] = b_cols[bi];
            y[u] = b_vals[bi];
          }
        }
        bool more = false;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int q = j[u] >= 0 ? find_col(mc, n_m, j[u]) : -1;
          if (q >= 0) acc[q] = fmin4(acc[q], mp_mul(xs[u], y[u]));
          more |= j[u] >= 0;
          __syncwarp();
        }
        // B rows keep their empty slots last: a chunk whose last lane is
        // empty in every unit ends the walk of these units
        if (!__shfl_sync(FULL, more, 31)) break;
      }
    }
  }
  __syncwarp();

  float4* orow = out + static_cast<size_t>(row) * km;
  for (int q = lane; q < km; q += 32) orow[q] = acc[q];
}

}  // namespace

extern "C" int spgemm_masked_launch(const void* a_cols, const void* a_vals,
                                    const void* b_cols, const void* b_vals,
                                    const void* m_cols, void* out, int n,
                                    int ka, int nb, int kb, int km,
                                    void* stream) {
  if (n <= 0 || km <= 0) return 0;
  const long long bytes = static_cast<long long>(WARPS) * SLOT_BYTES * km;
  if (bytes > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
  const int shmem = static_cast<int>(bytes);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spgemm_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  spgemm_masked_kernel<<<blocks, THREADS, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a_cols), static_cast<const float4*>(a_vals),
      static_cast<const int*>(b_cols), static_cast<const float4*>(b_vals),
      static_cast<const int*>(m_cols), static_cast<float4*>(out), n, ka, nb,
      kb, km);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spgemm_masked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
