// Banded x-drop seed extension, one warp per pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/xdrop/xdrop.py:xdrop_pallas
// (body _xdrop_kernel), which advanced a (pairs_per_block, band) wavefront
// in VMEM for a fixed max_steps trip count.
//
// What bounds it on this card: neither bytes nor arithmetic peak.  Each
// pair reads its two sequences once (a few KB) and each wavefront step is
// about eight integer operations per band cell, but the steps of one pair
// form a dependent chain: step s needs step s-1 (up/left) and s-2 (diag).
// The kernel is latency bound, and the number of pairs in flight is what
// hides that latency.
//
// What the design does about it: one warp owns one pair, so a pair's whole
// band (65 cells = 3 per lane) lives in registers and a step costs two warp
// shuffles per register for the neighbours, one warp max/argmax and one
// warp vote; 4096 pairs per launch give ~4096 warps, enough to fill the
// 132 SMs.  A pair leaves its loop as soon as all its cells are retired or
// s reaches min(max_steps, la + lb - 1), the oracle's own exit, so the
// trip count follows the data and not max_steps.  Sequences are read from
// global memory through base + step*t, so one kernel serves the forward
// (+1) and backward (-1) extensions.  Index arithmetic uses floor division
// by 2 and a parity test written for negative operands, as in JAX.
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int NEG = -500000000;  // -(10**9) // 2
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;

__device__ __forceinline__ int floor_div2(int x) { return (x - (x & 1)) / 2; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// R = cells per lane; lane l holds band cells d = l + 32 r
template <int R>
__global__ void __launch_bounds__(32 * WARPS)
xdrop_kernel(const uint8_t* __restrict__ a, int lda,
             const int* __restrict__ base_a, const int* __restrict__ step_a,
             const int* __restrict__ len_a,
             const uint8_t* __restrict__ b, int ldb,
             const int* __restrict__ base_b, const int* __restrict__ step_b,
             const int* __restrict__ len_b,
             int e, int band, int max_steps, int xdrop, int match,
             int mismatch, int gap,
             int* __restrict__ score, int* __restrict__ ai_out,
             int* __restrict__ bj_out) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= e) return;  // uniform across the warp
  const uint8_t* arow = a + (size_t)pair * lda;
  const uint8_t* brow = b + (size_t)pair * ldb;
  const int ba = base_a[pair], sa = step_a[pair], la = len_a[pair];
  const int bb = base_b[pair], sb = step_b[pair], lb = len_b[pair];
  const int c = band / 2;
  const int limit = min(max_steps, la + lb - 1);

  int h1[R], h2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    h1[r] = NEG;
    h2[r] = (lane + 32 * r == c) ? 0 : NEG;  // virtual origin at s - 2
  }
  int best = 0, bi = 0, bj = 0;
  bool alive = true;
  for (int s = 0; alive && s < limit; ++s) {
    int y[R], z[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[r] = __shfl_sync(FULL, h1[r], (lane + 31) & 31);  // lane - 1
      z[r] = __shfl_sync(FULL, h1[r], (lane + 1) & 31);   // lane + 1
    }
    int h[R];
    int lbest = INT_MIN, ld = 0;
    bool any_alive = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // up = H[s-1][d-1], left = H[s-1][d+1]; lane 0 / lane 31 take the
      // neighbouring register's value from the far lane
      const int up = lane > 0 ? y[r] : (r > 0 ? y[r > 0 ? r - 1 : 0] : NEG);
      const int left =
          lane < 31 ? z[r] : (r + 1 < R ? z[r + 1 < R ? r + 1 : r] : NEG);
      const int d = lane + 32 * r;
      const int off = d - c;
      const int i = floor_div2(s + off);
      const int j = floor_div2(s - off);
      int hv = NEG;
      if (d < band && ((s + off) & 1) == 0 && i >= 0 && j >= 0 && i < la &&
          j < lb) {
        const int ia = clampi(ba + sa * i, 0, lda - 1);
        const int jb = clampi(bb + sb * j, 0, ldb - 1);
        const int sub = arow[ia] == brow[jb] ? match : mismatch;
        hv = max(h2[r] + sub, max(up + gap, left + gap));
        if (hv < best - xdrop) hv = NEG;  // x-drop retirement
      }
      h[r] = hv;
      if (hv > lbest) {  // r ascending: the lowest d wins ties in a lane
        lbest = hv;
        ld = d;
      }
      any_alive |= hv > NEG;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // warp max, ties to the lowest d
      const int ov = __shfl_xor_sync(FULL, lbest, o);
      const int od = __shfl_xor_sync(FULL, ld, o);
      if (ov > lbest || (ov == lbest && od < ld)) {
        lbest = ov;
        ld = od;
      }
    }
    if (lbest > best) {
      best = lbest;
      const int off = ld - c;
      bi = floor_div2(s + off) + 1;
      bj = floor_div2(s - off) + 1;
    }
    alive = __any_sync(FULL, any_alive);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h2[r] = h1[r];
      h1[r] = h[r];
    }
  }
  if (lane == 0) {
    score[pair] = best;
    ai_out[pair] = bi;
    bj_out[pair] = bj;
  }
}

template <int R>
void launch_r(dim3 grid, dim3 block, cudaStream_t st, const uint8_t* a,
              int lda, const int* base_a, const int* step_a, const int* len_a,
              const uint8_t* b, int ldb, const int* base_b, const int* step_b,
              const int* len_b, int e, int band, int max_steps, int xdrop,
              int match, int mismatch, int gap, int* score, int* ai,
              int* bj) {
  xdrop_kernel<R><<<grid, block, 0, st>>>(
      a, lda, base_a, step_a, len_a, b, ldb, base_b, step_b, len_b, e, band,
      max_steps, xdrop, match, mismatch, gap, score, ai, bj);
}

}  // namespace

extern "C" int xdrop_launch(const void* a, int lda, const void* base_a,
                            const void* step_a, const void* len_a,
                            const void* b, int ldb, const void* base_b,
                            const void* step_b, const void* len_b, int e,
                            int band, int max_steps, int xdrop, int match,
                            int mismatch, int gap, void* score, void* ai,
                            void* bj, void* stream) {
  if (e <= 0) return 0;
  const int r = (band + 31) / 32;
  dim3 grid((e + WARPS - 1) / WARPS), block(32 * WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XDROP_CASE(R)                                                         \
  case R:                                                                     \
    launch_r<R>(grid, block, st, (const uint8_t*)a, lda, (const int*)base_a,  \
                (const int*)step_a, (const int*)len_a, (const uint8_t*)b,     \
                ldb, (const int*)base_b, (const int*)step_b,                  \
                (const int*)len_b, e, band, max_steps, xdrop, match,          \
                mismatch, gap, (int*)score, (int*)ai, (int*)bj);              \
    break;
  switch (r) {
    XDROP_CASE(1)
    XDROP_CASE(2)
    XDROP_CASE(3)
    XDROP_CASE(4)
    XDROP_CASE(5)
    XDROP_CASE(6)
    XDROP_CASE(7)
    XDROP_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XDROP_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xdrop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
