// Banded x-drop seed extension, one warp per pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/xdrop/xdrop.py:xdrop_pallas
// (body _xdrop_kernel), which advanced a (pairs_per_block, band) wavefront
// in VMEM for a fixed max_steps trip count.
//
// What bounds it on this card: neither bytes nor arithmetic peak.  A pair
// reads its two sequences once (a few KB) and a wavefront cell costs about
// eight integer operations, but the steps of one pair form a dependent
// chain: step s needs step s-1 (up/left) and s-2 (diag), and the x-drop
// test of step s needs the best score of step s-1.  A launch cannot end
// before its longest pair's chain (thousands of steps), and with every
// warp busy it is bound by the instructions issued: at band 65 about 58 a
// warp-step (SASS of the <2, 0> instance), against 33 cells of useful work.
// Registers (43-56 a thread, no spills) allow ~40 warps an SM; forcing
// fewer registers for more warps spills and is slower.
//
// What the design does about it:
// * Only the cells that exist are computed.  At step s, band cell d holds a
//   score only when s + d - c is even (c = band / 2), so the cells of a step
//   are d = 2q + p with p = (c + s) & 1, q = 0, 1, ...: band 65 gives 33 or
//   32 cells a step instead of 65.  Lane l holds q = R*l .. R*l + R - 1 in
//   registers.  diag is H[s-2] at the same q (same register); up and left
//   are H[s-1] at q-1 and q (p = 0) or at q and q+1 (p = 1), so a step needs
//   one warp shuffle, up or down by one lane, for the cell at the lane's
//   edge.  Even and odd steps are unrolled in pairs with the parity a
//   template argument, so H[s-2] is overwritten in place by H[s].
// * One-instruction warp reductions: the step maximum by __reduce_max_sync
//   (redux.sync); "alive" is that maximum above NEG, so no vote is needed.
//   The position of the best cell costs no warp operation a step: each lane
//   keeps its own record (its highest score, the first step it reached it,
//   the lowest register there).  The pair's best score was first reached at
//   the step where its last improvement happened, so at the end the lanes
//   holding the best take the earliest step (__reduce_min_sync), and of
//   those the lowest lane (a ballot and __ffs): the lowest q, i.e. the
//   lowest band offset d, at the last improving step, as in the oracle.
// * The bases are off the critical path: each warp keeps a 256-entry ring of
//   each walk's bases in shared memory, stored twice (at t mod 256 and 256
//   above), so a lane's R consecutive bases are read at immediate offsets
//   from one masked address.  Every 64 steps each lane loads the next base
//   of each walk into a register (coalesced, clamped to [0, L) as
//   base + step*t always was) and stores it to the ring 64 steps later, so
//   the load's latency is hidden behind the block of steps.
// * max(diag + sub, up + gap, left + gap) is two __viaddmax_s32 (DPX), exact
//   on int32.
// * A pair stops when no cell is alive or at min(max_steps, la + lb - 1).
// * D directions over the same rows run in one launch: pair w reads row
//   w % rows of a and b.
// * Bands above 256 (more than 4 cells a lane) run xdrop_wide_kernel: one
//   block of WIDE_THREADS per pair, every band cell d a step (WIDE_THREADS
//   apart a thread), H[s-2] and H[s-1] in two rows of `band` ints that
//   step s overwrites in place (dynamic shared memory, or a global scratch
//   row pair per block past WIDE_MAX_SHARED bytes), bases read from the
//   sequences directly, and the step maximum with its lowest offset d as
//   one 64-bit key (score * 2^32 + band - 1 - d) reduced by warp
//   shuffles and across warps through double-buffered shared slots: one
//   __syncthreads a step.  It serves bands the one-warp instance cannot
//   hold in registers; it is right, not fast.
// * Longest first: warp k runs pair order[k], an order by min(la, lb)
//   descending.  The work of a pair follows the shorter text, so the
//   longest chains start in the first wave of warps and the launch does not
//   wait on a long pair that started late.  The order is a counting sort by
//   one block launched just before (order_kernel): ~0.013 ms for 8192
//   pairs, where a torch argsort took ~0.09 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int NEG = -500000000;  // -(10**9) // 2
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;
constexpr int RING = 256;       // bases of one walk held per warp
constexpr int BLOCK_STEPS = 64;  // steps between two ring refills
// the ring holds a at i in [B, B + HELD_A) and b at j in [J - HELD_B, J + 64)
// at the start of each 64-step block (B = i of q = 0, J = s - B); a block
// reads i < B + 32 + 128 and j in (J - 128, J + 32]
constexpr int HELD_A = 192;
constexpr int HELD_B = 128;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Walk {
  const uint8_t* row;
  int ld, base, step;
  __device__ __forceinline__ uint8_t at(int t) const {
    return row[clampi(base + step * t, 0, ld - 1)];
  }
};

// a ring holds base t at t & (RING - 1) and again RING above it
__device__ __forceinline__ void ring_put(uint8_t* ring, int t, uint8_t v) {
  ring[t & (RING - 1)] = v;
  ring[(t & (RING - 1)) + RING] = v;
}

struct Pair {
  const uint8_t* ra;  // ring of a's bases (2 * RING entries)
  const uint8_t* rb;  // ring of b's bases (2 * RING entries)
  int lane, c, la, lb, xdrop, match, mismatch, gap;
  int best;                       // the pair's best score so far
  int lane_best, lane_s, lane_r;  // this lane's record: score, step, register
};

constexpr int ORDER_BINS = 4096;
constexpr int ORDER_THREADS = 1024;

// the bin of a pair's work min(la, lb): one length a bin below 2048, then
// 16 lengths a bin up to 2048 + 16 * 2047
__device__ __forceinline__ int work_bin(int la, int lb) {
  const int w = max(min(la, lb), 0);
  return w < 2048 ? w : 2048 + min((w - 2048) >> 4, 2047);
}

// One block writes order = the pairs by work bin, descending: a counting
// sort (histogram, scan, scatter in shared memory).  Pairs of one bin land
// in no fixed order, which changes no result.
__global__ void __launch_bounds__(ORDER_THREADS)
order_kernel(const int* __restrict__ len_a, const int* __restrict__ len_b,
             int pairs, int* __restrict__ order) {
  constexpr int PER = ORDER_BINS / ORDER_THREADS;
  __shared__ int start[ORDER_BINS];
  __shared__ int warp_sum[ORDER_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  for (int i = t; i < ORDER_BINS; i += ORDER_THREADS) start[i] = 0;
  __syncthreads();
  for (int p = t; p < pairs; p += ORDER_THREADS)
    atomicAdd(&start[work_bin(len_a[p], len_b[p])], 1);
  __syncthreads();
  // exclusive scan over the bins from the highest down: thread t owns bins
  // ORDER_BINS - 1 - (PER * t + u), u < PER
  int cnt[PER], sum = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    cnt[u] = start[ORDER_BINS - 1 - (PER * t + u)];
    sum += cnt[u];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int ws = warp_sum[lane];
    int wi = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += y;
    }
    warp_sum[lane] = wi - ws;
  }
  __syncthreads();
  int base = warp_sum[wid] + incl - sum;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    start[ORDER_BINS - 1 - (PER * t + u)] = base;
    base += cnt[u];
  }
  __syncthreads();
  for (int p = t; p < pairs; p += ORDER_THREADS)
    order[atomicAdd(&start[work_bin(len_a[p], len_b[p])], 1)] = p;
}

// i of cell q = 0 at step s: floor((s - c + 1) / 2)
__device__ __forceinline__ int first_i(int s, int c) { return (s - c + 1) >> 1; }

// One wavefront step of parity P: hd holds H[s-2] and becomes H[s]; hp is
// H[s-1].  Returns false when no cell is alive (the pair stops).
template <int R, int P>
__device__ __forceinline__ bool step(int (&hd)[R], const int (&hp)[R], int s,
                                     int qn, Pair& p) {
  int edge;
  if (P == 0) {  // up = H[s-1][q-1]: lane l-1's last cell
    edge = __shfl_up_sync(FULL, hp[R - 1], 1);
    if (p.lane == 0) edge = NEG;
  } else {  // left = H[s-1][q+1]: lane l+1's first cell
    edge = __shfl_down_sync(FULL, hp[0], 1);
    if (p.lane == 31) edge = NEG;
  }
  const int i0 = first_i(s, p.c);
  // the existing cells inside both sequences: qlo <= q < qhi
  const int qlo = max(max(0, -i0), s - i0 - p.lb + 1);
  const int qhi = min(min(qn, p.la - i0), s - i0 + 1);
  const unsigned span = max(qhi - qlo, 0);  // q - qlo < span, unsigned
  const int thr = p.best - p.xdrop;
  const int ia = i0 + R * p.lane;  // i of the lane's first cell
  const int jb = s - ia;           // and its j
  const uint8_t* ca = p.ra + (ia & (RING - 1));         // ca[r]: a at ia + r
  const uint8_t* cb = p.rb + (jb & (RING - 1)) + RING;  // cb[-r]: b at jb - r
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int up = P == 0 ? (r == 0 ? edge : hp[r > 0 ? r - 1 : 0]) : hp[r];
    const int left =
        P == 0 ? hp[r] : (r == R - 1 ? edge : hp[r + 1 < R ? r + 1 : r]);
    const int q = R * p.lane + r;
    const int sub = ca[r] == cb[-r] ? p.match : p.mismatch;
    const int h = __viaddmax_s32(hd[r], sub,
                                 __viaddmax_s32(up, p.gap, left + p.gap));
    hd[r] = ((unsigned)(q - qlo) < span && h >= thr) ? h : NEG;
  }
  int lmax = hd[0];
#pragma unroll
  for (int r = 1; r < R; ++r) lmax = max(lmax, hd[r]);
  const int m = __reduce_max_sync(FULL, lmax);
  if (m <= NEG) return false;
  p.best = max(p.best, m);
  if (lmax > p.lane_best) {  // the lane's first step at a new high
    int fr = R - 1;
#pragma unroll
    for (int r = R - 2; r >= 0; --r)
      if (hd[r] == lmax) fr = r;
    p.lane_best = lmax;
    p.lane_s = s;
    p.lane_r = fr;
  }
  return true;
}

// R = registers per lane (cells q = R*lane + r); P0 = c & 1, the parity of
// the even steps
template <int R, int P0>
__global__ void __launch_bounds__(32 * WARPS)
xdrop_kernel(const uint8_t* __restrict__ a, int lda,
             const int* __restrict__ base_a, const int* __restrict__ step_a,
             const int* __restrict__ len_a,
             const uint8_t* __restrict__ b, int ldb,
             const int* __restrict__ base_b, const int* __restrict__ step_b,
             const int* __restrict__ len_b,
             const int* __restrict__ order, int rows, int pairs, int band,
             int max_steps, int xdrop, int match, int mismatch, int gap,
             int* __restrict__ score, int* __restrict__ ai_out,
             int* __restrict__ bj_out) {
  __shared__ uint8_t ring_a[WARPS][2 * RING];
  __shared__ uint8_t ring_b[WARPS][2 * RING];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k = blockIdx.x * WARPS + w;
  if (k >= pairs) return;  // uniform across the warp
  const int pair = order[k];
  const int row = pair % rows;
  const Walk wa{a + (size_t)row * lda, lda, base_a[pair], step_a[pair]};
  const Walk wb{b + (size_t)row * ldb, ldb, base_b[pair], step_b[pair]};
  uint8_t* ra = ring_a[w];
  uint8_t* rb = ring_b[w];
  Pair p{ra, rb, lane, band >> 1, len_a[pair], len_b[pair], xdrop, match,
         mismatch, gap, 0, 0, 0, 0};
  const int limit = min(max_steps, p.la + p.lb - 1);
  // cells of each parity: d = 2q + parity < band
  const int qn_even = (band - P0 + 1) >> 1;
  const int qn_odd = (band - (1 - P0) + 1) >> 1;

  if (limit > 0) {
    {
      const int b0 = first_i(0, p.c), j0 = -b0;
#pragma unroll
      for (int u = 0; u < HELD_A / 32; ++u) {
        const int t = b0 + lane + 32 * u;
        ring_put(ra, t, wa.at(t));
      }
#pragma unroll
      for (int u = 0; u < (HELD_B + 64) / 32; ++u) {
        const int t = j0 - HELD_B + lane + 32 * u;
        ring_put(rb, t, wb.at(t));
      }
      __syncwarp();
    }
    int hx[R], hy[R];  // H[s-2] and H[s-1] at the even steps s
#pragma unroll
    for (int r = 0; r < R; ++r) {
      hx[r] = (R * lane + r == (p.c >> 1)) ? 0 : NEG;  // virtual origin
      hy[r] = NEG;
    }
    int s = 0;
    bool go = true;
    while (go) {
      // the bases the next block needs first, fetched ahead
      const int i0 = first_i(s, p.c);
      const int ta = i0 + HELD_A + lane, tb = s - i0 + 64 + lane;
      const uint8_t na = wa.at(ta), nb = wb.at(tb);
      const int s_end = min(s + BLOCK_STEPS, limit);
      for (; s < s_end; s += 2) {
        if (!step<R, P0>(hx, hy, s, qn_even, p) || s + 1 >= s_end) {
          go = false;  // dead, or an odd limit reached
          break;
        }
        if (!step<R, 1 - P0>(hy, hx, s + 1, qn_odd, p)) {
          go = false;
          break;
        }
      }
      if (s >= limit) go = false;
      if (go) {
        ring_put(ra, ta, na);
        ring_put(rb, tb, nb);
        __syncwarp();
      }
    }
  }
  // the best cell: the earliest step at which a lane reached the best
  // score, then the lowest lane, then (the lane's record) the lowest register
  int bi = 0, bj = 0;
  if (p.best > 0) {  // warp-uniform
    const int key = p.lane_best == p.best ? p.lane_s : INT_MAX;
    const int s_best = __reduce_min_sync(FULL, key);
    const int wl = __ffs(__ballot_sync(FULL, key == s_best)) - 1;
    const int i = first_i(s_best, p.c) + R * wl +
                  __shfl_sync(FULL, p.lane_r, wl);
    bi = i + 1;
    bj = s_best - i + 1;
  }
  if (lane == 0) {
    score[pair] = p.best;
    ai_out[pair] = bi;
    bj_out[pair] = bj;
  }
}

constexpr int WIDE_THREADS = 256;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
// the wide instance keeps its two rows in shared memory up to this size,
// else in global scratch (WIDE_GRID blocks, each looping over pairs)
constexpr int WIDE_MAX_SHARED = 200 * 1024;
constexpr int WIDE_GRID = 512;
// a step's key: score * KEY_SCALE + (band - 1 - d), so the maximum key is
// the best score at its lowest offset d
constexpr long long KEY_SCALE = 1LL << 32;

// One pair a block (looping over pairs when hbuf is given): the oracle's
// step, every cell of the band, no parity compaction.
__global__ void __launch_bounds__(WIDE_THREADS)
xdrop_wide_kernel(const uint8_t* __restrict__ a, int lda,
                  const int* __restrict__ base_a, const int* __restrict__ step_a,
                  const int* __restrict__ len_a,
                  const uint8_t* __restrict__ b, int ldb,
                  const int* __restrict__ base_b, const int* __restrict__ step_b,
                  const int* __restrict__ len_b,
                  const int* __restrict__ order, int rows, int pairs, int band,
                  int max_steps, int xdrop, int match, int mismatch, int gap,
                  int* __restrict__ score, int* __restrict__ ai_out,
                  int* __restrict__ bj_out, int* __restrict__ hbuf) {
  extern __shared__ int h_shared[];
  __shared__ long long wkey[2][WIDE_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int* h0 = hbuf ? hbuf + static_cast<size_t>(blockIdx.x) * 2 * band
                 : h_shared;
  int* h1 = h0 + band;
  const int c = band >> 1;
  for (int k = blockIdx.x; k < pairs; k += gridDim.x) {
    const int pair = order[k];
    const int row = pair % rows;
    const Walk wa{a + (size_t)row * lda, lda, base_a[pair], step_a[pair]};
    const Walk wb{b + (size_t)row * ldb, ldb, base_b[pair], step_b[pair]};
    const int la = len_a[pair], lb = len_b[pair];
    const int limit = min(max_steps, la + lb - 1);
    for (int d = tid; d < band; d += WIDE_THREADS) {
      h0[d] = d == c ? 0 : NEG;  // H[-2]: the virtual origin
      h1[d] = NEG;               // H[-1]
    }
    __syncthreads();
    int best = 0, bi = 0, bj = 0;
    for (int s = 0; s < limit; ++s) {
      int* hx = (s & 1) ? h1 : h0;  // H[s-2], overwritten by H[s]
      const int* hy = (s & 1) ? h0 : h1;  // H[s-1]
      const int thr = best - xdrop;
      long long key = LLONG_MIN;
      for (int d = tid; d < band; d += WIDE_THREADS) {
        const int off = d - c;
        const int i = (s + off) >> 1, j = (s - off) >> 1;
        int h = NEG;
        if (((s + off) & 1) == 0 && i >= 0 && i < la && j >= 0 && j < lb) {
          const int sub = wa.at(i) == wb.at(j) ? match : mismatch;
          const int up = (d > 0 ? hy[d - 1] : NEG) + gap;
          const int left = (d < band - 1 ? hy[d + 1] : NEG) + gap;
          h = max(hx[d] + sub, max(up, left));
          if (h < thr) h = NEG;
        }
        hx[d] = h;
        key = max(key, static_cast<long long>(h) * KEY_SCALE + (band - 1 - d));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        key = max(key, __shfl_xor_sync(FULL, key, o));
      if (lane == 0) wkey[s & 1][w] = key;
      __syncthreads();
      key = wkey[s & 1][0];
#pragma unroll
      for (int u = 1; u < WIDE_WARPS; ++u) key = max(key, wkey[s & 1][u]);
      const long long low = key & (KEY_SCALE - 1);  // band - 1 - d
      const int m = static_cast<int>((key - low) / KEY_SCALE);
      if (m <= NEG) break;  // no cell alive (uniform across the block)
      if (m > best) {
        const int d = band - 1 - static_cast<int>(low);
        const int i = (s + d - c) >> 1;
        best = m;
        bi = i + 1;
        bj = s - i + 1;
      }
    }
    if (tid == 0) {
      score[pair] = best;
      ai_out[pair] = bi;
      bj_out[pair] = bj;
    }
    __syncthreads();  // the rows and key slots are reused by the next pair
  }
}

}  // namespace

// Bytes of global scratch the launch needs for `band` (0: the rows fit
// in shared memory).
extern "C" long long xdrop_scratch_bytes(int band) {
  if (band <= 256 || 8LL * band <= WIDE_MAX_SHARED) return 0;
  return 8LL * band * WIDE_GRID;
}

extern "C" int xdrop_launch(const void* a, int lda, const void* base_a,
                            const void* step_a, const void* len_a,
                            const void* b, int ldb, const void* base_b,
                            const void* step_b, const void* len_b,
                            void* order, int rows, int pairs, int band,
                            int max_steps, int xdrop,
                            int match, int mismatch, int gap, void* score,
                            void* ai, void* bj, void* scratch, void* stream) {
  if (pairs <= 0) return 0;
  if (rows <= 0 || lda <= 0 || ldb <= 0 || band < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  order_kernel<<<1, ORDER_THREADS, 0, st>>>(
      (const int*)len_a, (const int*)len_b, pairs, (int*)order);
  if (band > 256) {
    const bool global = xdrop_scratch_bytes(band) > 0;
    if (global && scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t shmem = global ? 0 : 8 * static_cast<size_t>(band);
    if (shmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          xdrop_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int grid = global ? min(pairs, WIDE_GRID) : pairs;
    xdrop_wide_kernel<<<grid, WIDE_THREADS, shmem, st>>>(
        (const uint8_t*)a, lda, (const int*)base_a, (const int*)step_a,
        (const int*)len_a, (const uint8_t*)b, ldb, (const int*)base_b,
        (const int*)step_b, (const int*)len_b, (const int*)order, rows, pairs,
        band, max_steps, xdrop, match, mismatch, gap, (int*)score, (int*)ai,
        (int*)bj, global ? (int*)scratch : nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const int r = ((band + 1) / 2 + 31) / 32;  // cells of the larger parity
  const int p0 = (band / 2) & 1;
  dim3 grid((pairs + WARPS - 1) / WARPS), block(32 * WARPS);
#define XDROP_CASE(R, P0)                                                    \
  case 2 * R + P0:                                                           \
    xdrop_kernel<R, P0><<<grid, block, 0, st>>>(                             \
        (const uint8_t*)a, lda, (const int*)base_a, (const int*)step_a,      \
        (const int*)len_a, (const uint8_t*)b, ldb, (const int*)base_b,       \
        (const int*)step_b, (const int*)len_b, (const int*)order, rows,      \
        pairs, band, max_steps, xdrop, match, mismatch, gap, (int*)score,    \
        (int*)ai, (int*)bj);                                                 \
    break;
  switch (2 * r + p0) {
    XDROP_CASE(1, 0)
    XDROP_CASE(1, 1)
    XDROP_CASE(2, 0)
    XDROP_CASE(2, 1)
    XDROP_CASE(3, 0)
    XDROP_CASE(3, 1)
    XDROP_CASE(4, 0)
    XDROP_CASE(4, 1)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XDROP_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xdrop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
