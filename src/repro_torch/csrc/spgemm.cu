// Ring-SUMMA local SpGEMM stages for Hopper (sm_90a): for every (stage,
// row) of a stacked A panel, rebase its column ids into the stage's B row
// block, enumerate the candidates that exist (a live, in-range A slot times
// a live B slot of the row it selects, whose (x) is not zero), sort them by
// output column *stably*, (+)-combine the runs of equal column in that
// order, and compact the runs whose total is not zero into `capacity` ELL
// slots; runs past `capacity` count as overflow, summed over rows and
// stages.
//
// Replaces the TPU kernel src/repro/kernels/spgemm/spgemm.py:
// spgemm_ring_stages_pallas (body _spgemm_stages_kernel, per stage
// _stage_multiply), which kept a batch of stage panels and their output
// buffers resident in VMEM and ran the oracle's gather / sort / segmented
// scan / compact pipeline over the full K_A x K_B candidate grid.
//
// Two template instances of one kernel:
//   OVERLAP: operands hold `pos` (int32); (x) gives cnt = 1 and the pair
//     (apos, bpos) padded with -1; (+) sums counts and keeps the FIRST
//     NUM_POS_PAIRS = 2 pairs, so the order of a column's candidates
//     matters: it must be a-slot-major, b-slot-minor, as in the oracle.
//   MINPLUS: operands are (4,) f32 orientation vectors, +inf the zero;
//     (x) is out[2x+y] = min_c a[2x+c] + b[2c+y], (+) an elementwise fminf.
//     No fast-math, and no multiply exists that could contract into an FMA.
//
// What bounds it on this card: bytes.  The least work is to read the A
// panel once, only the B rows that a live A slot selects, and write the
// stage buffers once (at 4000 reads 138,123 of the 2^20 B rows, 448 bytes
// each, and ~11 MB of A and output: 0.022 ms on an H100 SXM).
//
// The design sizes every block by the candidates that exist, not by the
// K_A x K_B grid (8960 slots a row at 4000 reads, of which at most 1891
// are live):
//   * spgemm_count_kernel (one block per row, the same walk as pass 1
//     below) finds the launch's most live candidates in a row and its
//     largest output column, and lists the rows too full for shared
//     memory; the wrapper reads the counts once and sizes the main
//     launch's shared memory from the first (blocks of 256 threads,
//     several to an SM) and its radix passes from the second;
//   * the block first lists the row's live A slots (in range of the
//     stage's B block) and the B rows they select in shared memory, so no
//     warp visits a dead slot (at a 4x4 grid three slots in four are);
//   * pass 1 walks units, a unit being one live A slot and one 32-lane
//     chunk of the B row it selects: a warp takes every 8th live slot,
//     UNROLL_* at a time, loads a chunk of each coalesced before it ballots
//     any, so several B-row reads are in flight per warp, and counts each
//     unit's live lanes (column ids only, but for MINPLUS the products,
//     whose zeros are not candidates); a block scan of the per-unit counts
//     gives each unit its place, so pass 2 (the same walk) writes every
//     candidate (its column and its operands: (apos, bpos), or the (x)
//     product) in candidate order, a-slot-major, b-slot-minor;
//   * a stable LSD radix sort of the candidate indices on the column, 4
//     bits a pass, as many passes as the largest column needs: each thread
//     counts the digits of a contiguous chunk, one exclusive scan over the
//     (digit, thread) counts (padded so that neither the counts nor the
//     scan meet a bank conflict), each thread scatters its chunk in order;
//     stability keeps the candidate order inside a column;
//   * the fold, in tiles of 256 sorted positions, needs no serial walk:
//     OVERLAP: a block scan of run heads numbers the runs, each head
//       records its position, and the run's last element reads it: cnt is
//       the run length, the two pairs the run's first two entries;
//     MINPLUS: a segmented inclusive min-scan (warp shuffles, then the
//       warps' aggregates and the previous tile's carry) leaves each run's
//       total at its last element;
//     then a block scan of the kept runs ranks them and the first
//     `capacity` are written;
//   * a row whose candidates do not fit in a block's shared memory (more
//     than `fit`, the wrapper's bound from MAX_SHARED) is not refused: the
//     count launch appends its id to a list, the shared-memory instance
//     returns from it after pass 1, and a second instance of the same row
//     body (spgemm_stages_global_kernel, launched right after by the same
//     call) keeps that row's candidate-sized buffers in a slice of global
//     scratch per block instead, the radix counters still in shared
//     memory, its blocks walking the list.  Same walk, same stable sort,
//     same fold: the same bits, only slower.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OVERLAP = 0;
constexpr int MINPLUS = 1;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX_BITS = 4;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SHARED = 232448;
// live A slots a warp loads a chunk of before it ballots any: four for
// OVERLAP; one for MINPLUS, whose float4 operands cost registers (at four
// it needed 64-80 a thread and ran slower on the TR launch)
constexpr int UNROLL_OVERLAP = 4;
constexpr int UNROLL_MINPLUS = 1;

__device__ __forceinline__ float4 mp_mul(float4 x, float4 y) {
  // [2x+y] = min(a[2x+0] + b[0+y], a[2x+1] + b[2+y])
  return make_float4(fminf(x.x + y.x, x.y + y.z), fminf(x.x + y.y, x.y + y.w),
                     fminf(x.z + y.x, x.w + y.z), fminf(x.z + y.y, x.w + y.w));
}

__device__ __forceinline__ float4 fmin4(float4 x, float4 y) {
  return make_float4(fminf(x.x, y.x), fminf(x.y, y.y), fminf(x.z, y.z),
                     fminf(x.w, y.w));
}

__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) < __int_as_float(0x7f800000);  // false for inf and NaN
}

__device__ __forceinline__ bool mp_is_zero(float4 v) {
  return !finite(v.x) && !finite(v.y) && !finite(v.z) && !finite(v.w);
}

__device__ __forceinline__ float4 inf4() {
  const float inf = __int_as_float(0x7f800000);
  return make_float4(inf, inf, inf, inf);
}

// Shared memory of one block, in bytes from the start of the dynamic
// buffer: the candidates' operands (int2 or float4), columns and two
// permutation buffers (vcap each), the live A slots and the B rows they
// select (ka each), the per-unit counts (ka x chunks(kb)), the radix
// counters (RADIX x THREADS, one pad word every 32) and the scan scratch.
struct Layout {
  size_t pay, cols, perm0, perm1, live_a, live_br, u_off, digits, scratch,
      total;
};

// 32-lane chunks of a B row of kb slots
__host__ __device__ inline int chunks(int kb) { return (kb + 31) / 32; }

__host__ __device__ inline Layout layout(int sr, int vcap, int ka, int kb) {
  Layout s;
  size_t o = 0;
  s.pay = o;
  o += (sr == OVERLAP ? 8 : 16) * static_cast<size_t>(vcap);
  s.cols = o;
  o += 4 * static_cast<size_t>(vcap);
  s.perm0 = o;
  o += 4 * static_cast<size_t>(vcap);
  s.perm1 = o;
  o += 4 * static_cast<size_t>(vcap);
  s.live_a = o;
  o += 4 * static_cast<size_t>(ka);
  s.live_br = o;
  o += 4 * static_cast<size_t>(ka);
  s.u_off = o;
  o += 4 * static_cast<size_t>(ka) * chunks(kb);
  o = (o + 15) & ~static_cast<size_t>(15);
  s.digits = o;
  o += 4 * static_cast<size_t>(RADIX * THREADS + RADIX * THREADS / 32);
  s.scratch = o;
  o += 4 * 64;
  s.total = o;
  return s;
}

// Exclusive block scan of `x`; writes the block total to *total.  Every
// thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    int s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = (w > 0 ? warp_sums[w - 1] : 0) + incl - x;
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

// One stage row's operands: the A row, the stage's B panel and offset.
struct Row {
  const int* ac;      // the A row's K_A column ids
  const void* a_vals;
  size_t a_row;       // index of the row's first A slot
  const int* bcs;     // the stage's B panel column ids
  const void* b_vals;
  size_t b_base;      // index of the stage's first B slot
  int off, nb, kb;
};

__device__ __forceinline__ Row stage_row(const int* offsets, const int* a_cols,
                                         const void* a_vals, const int* b_cols,
                                         const void* b_vals, int n, int ka,
                                         int nb, int kb, int row, int s) {
  Row r;
  r.a_row = (static_cast<size_t>(s) * n + row) * ka;
  r.ac = a_cols + r.a_row;
  r.a_vals = a_vals;
  r.b_base = static_cast<size_t>(s) * nb * kb;
  r.bcs = b_cols + r.b_base;
  r.b_vals = b_vals;
  r.off = offsets[s];
  r.nb = nb;
  r.kb = kb;
  return r;
}

template <int SR>
struct Pay;
template <>
struct Pay<OVERLAP> {
  using T = int2;  // (apos, bpos)
};
template <>
struct Pay<MINPLUS> {
  using T = float4;  // the (x) product
};

// The row's live A slots (not empty, inside the stage's row block) in
// ascending order: live_a[i] is the slot, live_br[i] the B row it selects.
// Returns their count; every thread of the block calls it (`scan` is
// block_scan's scratch), and it ends with a barrier.
__device__ __forceinline__ int stage_live(const Row& r, int ka, int* live_a,
                                          int* live_br, int* scan) {
  int n_live = 0;
  for (int base = 0; base < ka; base += THREADS) {
    const int a = base + threadIdx.x;
    int br = -1;
    if (a < ka) {
      const int c = r.ac[a];
      if (c >= 0 && c - r.off >= 0 && c - r.off < r.nb) br = c - r.off;
    }
    int tile;
    const int pos = n_live + block_scan(br >= 0, scan, &tile);
    if (br >= 0) {
      live_a[pos] = a;
      live_br[pos] = br;
    }
    n_live += tile;
  }
  __syncthreads();
  return n_live;
}

// The walk of passes 1 and 2 over the row's units u = i * nch + k (live A
// slot i, lanes [32k, 32k + 32) of the B row it selects): a warp takes
// every WARPS-th live slot, UNROLL of them at a time, and loads a chunk of
// all of them before it ballots any.  Calls f(u, mask, live, col, pay) on
// every lane of the warp for each of its units, `mask` the unit's ballot
// of live candidates (for MINPLUS, those whose (x) product is not zero).
// `pay` is the candidate's operands (OVERLAP: only with PAY) or product.
template <int SR, bool PAY, class F>
__device__ __forceinline__ void for_units(const Row& r, const int* live_a,
                                          const int* live_br, int n_live,
                                          int nch, F f) {
  using P = typename Pay<SR>::T;
  constexpr int UNROLL = SR == OVERLAP ? UNROLL_OVERLAP : UNROLL_MINPLUS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i0 = w; i0 < n_live; i0 += WARPS * UNROLL) {
    int br[UNROLL];
    P a_op[UNROLL];  // OVERLAP: apos in .x; MINPLUS: the A slot's vector
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = i0 + j * WARPS;
      br[j] = -1;
      a_op[j] = P{};
      if (i < n_live) {
        br[j] = live_br[i];
        const size_t ai = r.a_row + live_a[i];
        if constexpr (SR == MINPLUS)
          a_op[j] = reinterpret_cast<const float4*>(r.a_vals)[ai];
        else if constexpr (PAY)
          a_op[j].x = reinterpret_cast<const int*>(r.a_vals)[ai];
      }
    }
    for (int k = 0; k < nch; ++k) {
      const int b = 32 * k + lane;
      int col[UNROLL];
      P b_op[UNROLL];  // OVERLAP: bpos in .x; MINPLUS: the B slot's vector
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        col[j] = -1;
        b_op[j] = P{};
        if (br[j] >= 0 && b < r.kb) {
          const size_t bi = static_cast<size_t>(br[j]) * r.kb + b;
          col[j] = r.bcs[bi];
          if constexpr (SR == MINPLUS)
            b_op[j] = reinterpret_cast<const float4*>(r.b_vals)[r.b_base + bi];
          else if constexpr (PAY)
            b_op[j].x = reinterpret_cast<const int*>(r.b_vals)[r.b_base + bi];
        }
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int i = i0 + j * WARPS;
        if (i >= n_live) break;  // uniform across the warp
        bool live = col[j] >= 0;
        P p = P{};
        if constexpr (SR == MINPLUS) {
          if (live) {
            p = mp_mul(a_op[j], b_op[j]);
            live = !mp_is_zero(p);
          }
        } else if constexpr (PAY) {
          p = make_int2(a_op[j].x, b_op[j].x);
        }
        f(i * nch + k, __ballot_sync(FULL, live), live, col[j], p);
      }
    }
  }
}

// Per row of the launch, its live candidates: the most of the rows that
// hold at most `fit` (maxes[0]) and of the rest (maxes[3]), the largest live
// output column (maxes[1]), and the rest's ids (stage * n + row) appended
// to full[] (their count in maxes[2]); maxes zeroed by the caller.
// Dynamic shared memory: 2 ka ints (the live A slots and their B rows).
template <int SR>
__global__ void __launch_bounds__(THREADS)
spgemm_count_kernel(const int* __restrict__ offsets,
                    const int* __restrict__ a_cols,
                    const void* __restrict__ a_vals,
                    const int* __restrict__ b_cols,
                    const void* __restrict__ b_vals, int* maxes,
                    int* __restrict__ full, int fit, int n, int ka, int nb,
                    int kb) {
  using P = typename Pay<SR>::T;
  extern __shared__ int live_a[];
  __shared__ int scan[WARPS], total, cmax_all;
  if (threadIdx.x == 0) {
    total = 0;
    cmax_all = -1;
  }
  const Row r = stage_row(offsets, a_cols, a_vals, b_cols, b_vals, n, ka, nb,
                          kb, blockIdx.x, blockIdx.y);
  int* live_br = live_a + ka;
  const int n_live = stage_live(r, ka, live_a, live_br, scan);
  int sum = 0, cmax = -1;
  for_units<SR, false>(r, live_a, live_br, n_live, chunks(kb),
                       [&](int, unsigned mask, bool live, int col, const P&) {
                         sum += __popc(mask);
                         if (live) cmax = max(cmax, col);
                       });
  cmax = __reduce_max_sync(FULL, cmax);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&total, sum);
    atomicMax(&cmax_all, cmax);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (total > fit) {
      full[atomicAdd(maxes + 2, 1)] = blockIdx.y * n + blockIdx.x;
      atomicMax(maxes + 3, total);
    } else {
      atomicMax(maxes, total);
    }
    atomicMax(maxes + 1, cmax_all);
  }
}

// Where a row's buffers live: in the shared-memory instance all of them
// in the block's dynamic shared memory (`layout`); in the global instance
// the candidate-sized ones (operands, columns, the two permutations, the
// live A slots, the unit offsets) in the block's slice of a global scratch
// buffer, the radix counters and the scan scratch in shared memory.
struct Bufs {
  void* pay;
  int *cols, *perm0, *perm1, *live_a, *live_br, *u_off;
  unsigned* digits;
  int* scratch;
};

__device__ __forceinline__ Bufs row_bufs(unsigned char* base, const Layout& lay,
                                         unsigned* digits, int* scratch) {
  Bufs b;
  b.pay = base + lay.pay;
  b.cols = reinterpret_cast<int*>(base + lay.cols);
  b.perm0 = reinterpret_cast<int*>(base + lay.perm0);
  b.perm1 = reinterpret_cast<int*>(base + lay.perm1);
  b.live_a = reinterpret_cast<int*>(base + lay.live_a);
  b.live_br = reinterpret_cast<int*>(base + lay.live_br);
  b.u_off = reinterpret_cast<int*>(base + lay.u_off);
  b.digits = digits;
  b.scratch = scratch;
  return b;
}

// One stage row, start to end, by the whole block: `vcap` candidates fit
// in its buffers.  With FIT_ONLY, a row holding more than `vcap` returns
// after pass 1 and writes nothing: the global instance computes it.
template <int SR, bool FIT_ONLY>
__device__ __forceinline__ void stage_multiply(
    const Row& r, const Bufs& bf, size_t out_row, int* __restrict__ out_cols,
    void* __restrict__ out0, int* __restrict__ out_apos,
    int* __restrict__ out_bpos, int* __restrict__ overflow, int ka, int kb,
    int cap, int vcap, int col_bits) {
  using P = typename Pay<SR>::T;
  P* pay = reinterpret_cast<P*>(bf.pay);
  int* cols = bf.cols;
  int* perm0 = bf.perm0;
  int* perm1 = bf.perm1;
  int* live_a = bf.live_a;
  int* live_br = bf.live_br;
  int* u_off = bf.u_off;
  unsigned* digits = bf.digits;
  int* scratch = bf.scratch;
  // scratch: [0, 16) block_scan; MINPLUS: [16, 48) the warps' aggregates
  // (8 float4), [48, 52) the carry into the next tile, [56, 64) the warps'
  // head flags
  float4* w_x = reinterpret_cast<float4*>(scratch + 16);
  int* w_f = scratch + 56;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

  // --- 1. live candidates per unit, their places in candidate order ---
  const int n_live = stage_live(r, ka, live_a, live_br, scratch);
  const int nch = chunks(kb), units = n_live * nch;
  for_units<SR, false>(r, live_a, live_br, n_live, nch,
                       [&](int u, unsigned mask, bool, int, const P&) {
                         if (lane == 0) u_off[u] = __popc(mask);
                       });
  __syncthreads();
  int v_total = 0;
  for (int base = 0; base < units; base += THREADS) {
    const int i = base + tid;
    int tile;
    const int ex = block_scan(i < units ? u_off[i] : 0, scratch, &tile);
    if (i < units) u_off[i] = v_total + ex;
    v_total += tile;
  }
  if (FIT_ONLY && v_total > vcap) return;  // uniform: a block-scan total
  const int V = v_total;
  __syncthreads();

  // --- 2. the candidates, in candidate order ---
  for_units<SR, true>(r, live_a, live_br, n_live, nch,
                      [&](int u, unsigned mask, bool live, int col,
                          const P& p) {
                        const int pos =
                            u_off[u] + __popc(mask & ((1u << lane) - 1));
                        if (live && pos < vcap) {
                          cols[pos] = col;
                          pay[pos] = p;
                        }
                      });
  for (int i = tid; i < V; i += THREADS) perm0[i] = i;
  __syncthreads();

  // --- 3. stable LSD radix sort of the candidate indices on the column ---
  int* src = perm0;
  int* dst = perm1;
  {
    const int ipt = (V + THREADS - 1) / THREADS;
    const int lo = min(tid * ipt, V), hi = min(lo + ipt, V);
    // counter (d, t) sits at e = d * THREADS + t, stored at pad(e): a warp's
    // counters of one digit are 32 banks in a row, and so are the 16
    // counters each thread scans (e = 16 t + j for lanes t)
    auto pad = [](int e) { return e + (e >> 5); };
    for (int shift = 0; shift < col_bits; shift += RADIX_BITS) {
#pragma unroll
      for (int d = 0; d < RADIX; ++d) digits[pad(d * THREADS + tid)] = 0;
      for (int i = lo; i < hi; ++i)
        ++digits[pad(((cols[src[i]] >> shift) & (RADIX - 1)) * THREADS + tid)];
      __syncthreads();
      unsigned run = 0;
#pragma unroll
      for (int j = 0; j < RADIX; ++j) {
        unsigned& c = digits[pad(tid * RADIX + j)];
        const unsigned x = c;
        c = run;
        run += x;
      }
      int all;
      const unsigned ex = block_scan(static_cast<int>(run), scratch, &all);
#pragma unroll
      for (int j = 0; j < RADIX; ++j) digits[pad(tid * RADIX + j)] += ex;
      __syncthreads();
      for (int i = lo; i < hi; ++i) {
        const int q = src[i];
        dst[digits[pad(((cols[q] >> shift) & (RADIX - 1)) * THREADS + tid)]++] =
            q;
      }
      __syncthreads();
      int* t = src;
      src = dst;
      dst = t;
    }
  }
  const int* srt = src;

  // --- 4. fold the runs, rank the kept ones, compact to `cap` ---
  int kept_total = 0;
  float4 carry = inf4();  // MINPLUS: the open run's value so far
  for (int base = 0; base < V; base += THREADS) {
    const int p = base + tid;
    const bool in = p < V;
    const int col = in ? cols[srt[p]] : -1;
    const bool head = in && (p == 0 || cols[srt[p - 1]] != col);
    const bool tail = in && (p == V - 1 || cols[srt[p + 1]] != col);
    if (SR == OVERLAP) {
      // every run is kept (cnt >= 1): the run number is the rank
      int tile;
      const int rid = kept_total + block_scan(head, scratch, &tile) + head - 1;
      if (head) dst[rid] = p;  // the run's first position
      __syncthreads();
      if (tail && rid < cap) {
        const int hp = dst[rid];
        const int cnt = p - hp + 1;
        const int2 f0 = reinterpret_cast<const int2*>(pay)[srt[hp]];
        const int2 f1 = cnt > 1 ? reinterpret_cast<const int2*>(pay)[srt[hp + 1]]
                                : make_int2(-1, -1);
        const size_t o = out_row + rid;
        out_cols[o] = col;
        reinterpret_cast<int*>(out0)[o] = cnt;
        out_apos[2 * o] = f0.x;
        out_apos[2 * o + 1] = f1.x;
        out_bpos[2 * o] = f0.y;
        out_bpos[2 * o + 1] = f1.y;
      }
      kept_total += tile;
    } else {
      // segmented inclusive min-scan; f: a run starts at or before me
      // within my warp's window
      float4 x = in ? reinterpret_cast<const float4*>(pay)[srt[p]] : inf4();
      bool f = head || !in;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        float4 y;
        y.x = __shfl_up_sync(FULL, x.x, o);
        y.y = __shfl_up_sync(FULL, x.y, o);
        y.z = __shfl_up_sync(FULL, x.z, o);
        y.w = __shfl_up_sync(FULL, x.w, o);
        const bool g = __shfl_up_sync(FULL, f, o);
        if (lane >= o) {
          if (!f) x = fmin4(y, x);
          f = f || g;
        }
      }
      if (lane == 31) {
        w_x[w] = x;
        w_f[w] = f;
      }
      __syncthreads();
      if (!f) {
        float4 pre = carry;
        for (int j = 0; j < w; ++j) pre = w_f[j] ? w_x[j] : fmin4(pre, w_x[j]);
        x = fmin4(pre, x);
      }
      const bool kept = tail && !mp_is_zero(x);
      if (tid == THREADS - 1) w_x[WARPS] = x;  // the carry into the next tile
      int tile;
      const int rank = kept_total + block_scan(kept, scratch, &tile);
      if (kept && rank < cap) {
        const size_t o = out_row + rank;
        out_cols[o] = col;
        reinterpret_cast<float4*>(out0)[o] = x;
      }
      carry = w_x[WARPS];
      kept_total += tile;
    }
  }

  // --- 5. empty slots, overflow ---
  for (int k = kept_total + tid; k < cap; k += THREADS) {
    const size_t o = out_row + k;
    out_cols[o] = -1;
    if (SR == OVERLAP) {
      reinterpret_cast<int*>(out0)[o] = 0;
      out_apos[2 * o] = -1;
      out_apos[2 * o + 1] = -1;
      out_bpos[2 * o] = -1;
      out_bpos[2 * o + 1] = -1;
    } else {
      reinterpret_cast<float4*>(out0)[o] = inf4();
    }
  }
  if (tid == 0 && kept_total > cap) atomicAdd(overflow, kept_total - cap);
}

// The shared-memory instance: one block per (row, stage), every buffer in
// dynamic shared memory sized for `vcap` candidates; rows holding more
// return after pass 1.
template <int SR>
__global__ void __launch_bounds__(THREADS)
spgemm_stages_kernel(const int* __restrict__ offsets,
                     const int* __restrict__ a_cols,
                     const void* __restrict__ a_vals,
                     const int* __restrict__ b_cols,
                     const void* __restrict__ b_vals,
                     int* __restrict__ out_cols, void* __restrict__ out0,
                     int* __restrict__ out_apos, int* __restrict__ out_bpos,
                     int* __restrict__ overflow, int n, int ka, int nb, int kb,
                     int cap, int vcap, int col_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(SR, vcap, ka, kb);
  const Bufs bf = row_bufs(smem, lay,
                           reinterpret_cast<unsigned*>(smem + lay.digits),
                           reinterpret_cast<int*>(smem + lay.scratch));
  const Row r = stage_row(offsets, a_cols, a_vals, b_cols, b_vals, n, ka, nb,
                          kb, blockIdx.x, blockIdx.y);
  const size_t out_row =
      (static_cast<size_t>(blockIdx.y) * n + blockIdx.x) * cap;
  stage_multiply<SR, true>(r, bf, out_row, out_cols, out0, out_apos, out_bpos,
                           overflow, ka, kb, cap, vcap, col_bits);
}

// The global instance: the rows too full for a block's shared memory
// (full[0 .. n_full), ids stage * n + row), a block each at a time, the
// grid walking the list; block b's candidate-sized buffers are the
// `lay.digits` bytes at gscratch + b * lay.digits.
template <int SR>
__global__ void __launch_bounds__(THREADS)
spgemm_stages_global_kernel(const int* __restrict__ offsets,
                            const int* __restrict__ a_cols,
                            const void* __restrict__ a_vals,
                            const int* __restrict__ b_cols,
                            const void* __restrict__ b_vals,
                            int* __restrict__ out_cols, void* __restrict__ out0,
                            int* __restrict__ out_apos,
                            int* __restrict__ out_bpos,
                            int* __restrict__ overflow,
                            const int* __restrict__ full, int n_full,
                            unsigned char* __restrict__ gscratch, int n,
                            int ka, int nb, int kb, int cap, int vcap,
                            int col_bits) {
  __shared__ unsigned digits[RADIX * THREADS + RADIX * THREADS / 32];
  __shared__ __align__(16) int scratch[64];
  const Layout lay = layout(SR, vcap, ka, kb);
  const Bufs bf = row_bufs(gscratch + blockIdx.x * lay.digits, lay, digits,
                           scratch);
  for (int q = blockIdx.x; q < n_full; q += gridDim.x) {
    const int id = full[q];
    const int s = id / n, row = id - s * n;
    const Row r = stage_row(offsets, a_cols, a_vals, b_cols, b_vals, n, ka,
                            nb, kb, row, s);
    stage_multiply<SR, false>(r, bf, static_cast<size_t>(id) * cap, out_cols,
                              out0, out_apos, out_bpos, overflow, ka, kb, cap,
                              vcap, col_bits);
    __syncthreads();  // the buffers are the next row's
  }
}

template <int SR>
cudaError_t set_shared(size_t shmem) {
  if (shmem > static_cast<size_t>(MAX_SHARED)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(spgemm_stages_kernel<SR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shmem));
}

}  // namespace

// Bytes of dynamic shared memory a block of the main kernel uses for
// `vcap` candidates and K_A slots.
extern "C" long long spgemm_shared_bytes(int semiring, int vcap, int ka,
                                        int kb) {
  return static_cast<long long>(layout(semiring, vcap, ka, kb).total);
}

// Blocks of the main kernel an SM holds at that shared memory.
extern "C" int spgemm_blocks_per_sm(int semiring, int vcap, int ka, int kb,
                                    int* blocks) {
  const size_t shmem = layout(semiring, vcap, ka, kb).total;
  cudaError_t err;
  if (semiring == OVERLAP) {
    err = set_shared<OVERLAP>(shmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, spgemm_stages_kernel<OVERLAP>, THREADS, shmem);
  } else if (semiring == MINPLUS) {
    err = set_shared<MINPLUS>(shmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, spgemm_stages_kernel<MINPLUS>, THREADS, shmem);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Per row, the live candidates; the most of the rows that fit (at most
// `fit`) and of the rest, the largest live output column, and the rest's
// ids in full[] (room for stages * n): see spgemm_count_kernel.
extern "C" int spgemm_count(int semiring, const void* offsets,
                            const void* a_cols, const void* a_vals,
                            const void* b_cols, const void* b_vals,
                            void* maxes, void* full, int fit, int stages,
                            int n, int ka, int nb, int kb, void* stream) {
  if (stages <= 0 || n <= 0) return 0;
  if (ka < 0 || ka > MAX_SHARED / 8 - 64 ||
      static_cast<long long>(stages) * n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int*>(offsets);
  const auto* ac = static_cast<const int*>(a_cols);
  const auto* bc = static_cast<const int*>(b_cols);
  auto* mx = static_cast<int*>(maxes);
  auto* fl = static_cast<int*>(full);
  const dim3 grid(n, stages);
  const int shmem = 8 * ka;  // the live A slots and their B rows
  cudaError_t err;
  if (semiring == OVERLAP) {
    err = cudaFuncSetAttribute(spgemm_count_kernel<OVERLAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    spgemm_count_kernel<OVERLAP><<<grid, THREADS, shmem, st>>>(
        off, ac, a_vals, bc, b_vals, mx, fl, fit, n, ka, nb, kb);
  } else if (semiring == MINPLUS) {
    err = cudaFuncSetAttribute(spgemm_count_kernel<MINPLUS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    spgemm_count_kernel<MINPLUS><<<grid, THREADS, shmem, st>>>(
        off, ac, a_vals, bc, b_vals, mx, fl, fit, n, ka, nb, kb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int SR>
cudaError_t launch_instances(const int* off, const int* ac, const void* av,
                             const int* bc, const void* bv, int* oc,
                             void* out0, int* out1, int* out2, int* ovf,
                             const int* full, int n_full, void* gscratch,
                             int g_blocks, int stages, int n, int ka, int nb,
                             int kb, int cap, int vcap, int vcap_g,
                             int col_bits, cudaStream_t st) {
  if (vcap > 0) {
    const size_t shmem = layout(SR, vcap, ka, kb).total;
    const cudaError_t err = set_shared<SR>(shmem);
    if (err != cudaSuccess) return err;
    spgemm_stages_kernel<SR><<<dim3(n, stages), THREADS, shmem, st>>>(
        off, ac, av, bc, bv, oc, out0, out1, out2, ovf, n, ka, nb, kb, cap,
        vcap, col_bits);
  }
  if (n_full > 0) {
    spgemm_stages_global_kernel<SR><<<g_blocks, THREADS, 0, st>>>(
        off, ac, av, bc, bv, oc, out0, out1, out2, ovf, full, n_full,
        static_cast<unsigned char*>(gscratch), n, ka, nb, kb, cap, vcap_g,
        col_bits);
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of global scratch one block of the global instance uses for
// `vcap` candidates (its candidate-sized buffers).
extern "C" long long spgemm_global_bytes(int semiring, int vcap, int ka,
                                         int kb) {
  return static_cast<long long>(layout(semiring, vcap, ka, kb).digits);
}

// The main launch: the shared-memory instance over every (row, stage),
// `vcap` candidates a block (0: no row fits, no launch), and, when n_full
// rows are too full for it (their ids in full[]), the global instance in
// g_blocks blocks of `vcap_g` candidates each, their buffers in gscratch
// (g_blocks * spgemm_global_bytes(semiring, vcap_g, ka, kb) bytes);
// `col_bits` is the bit width of the largest output column.
extern "C" int spgemm_launch(int semiring, const void* offsets,
                             const void* a_cols, const void* a_vals,
                             const void* b_cols, const void* b_vals,
                             void* out_cols, void* out0, void* out1,
                             void* out2, void* overflow, const void* full,
                             int n_full, void* gscratch, int g_blocks,
                             int vcap_g, int stages, int n, int ka, int nb,
                             int kb, int cap, int vcap, int col_bits,
                             void* stream) {
  if (stages <= 0 || n <= 0) return 0;
  if (vcap < 0 || cap < 1 || col_bits < 0 || col_bits > 31 || n_full < 0 ||
      (n_full > 0 && (g_blocks < 1 || vcap_g < 0 || gscratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int*>(offsets);
  const auto* ac = static_cast<const int*>(a_cols);
  const auto* bc = static_cast<const int*>(b_cols);
  auto* oc = static_cast<int*>(out_cols);
  auto* ovf = static_cast<int*>(overflow);
  const auto* fl = static_cast<const int*>(full);
  cudaError_t err;
  if (semiring == OVERLAP) {
    err = launch_instances<OVERLAP>(
        off, ac, a_vals, bc, b_vals, oc, out0, static_cast<int*>(out1),
        static_cast<int*>(out2), ovf, fl, n_full, gscratch, g_blocks, stages,
        n, ka, nb, kb, cap, vcap, vcap_g, col_bits, st);
  } else if (semiring == MINPLUS) {
    err = launch_instances<MINPLUS>(
        off, ac, a_vals, bc, b_vals, oc, out0, nullptr, nullptr, ovf, fl,
        n_full, gscratch, g_blocks, stages, n, ka, nb, kb, cap, vcap, vcap_g,
        col_bits, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* spgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
