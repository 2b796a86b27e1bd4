// Banded pileup with the +-4 coherence gate and the strict-majority vote,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pileup/pileup.py:pileup_pallas
// (body _pileup_kernel), which tiled (contig, column band) blocks and kept a
// (4, band) count block in VMEM while looping over the contig's pieces.
//
// What bounds it on this card: the pass over (contig, column, piece).
// Every column must test every piece of its contig for overlap, and each
// overlapping base reads a 9-wide window of the piece and of the draft;
// the outputs are 9 bytes a column and the pieces are read about once, so
// bytes are not the limit — the integer work of the coherence windows and
// the piece loop are.
//
// What the design does about it: one thread per contig column (blocks of
// 256 columns, grid (column blocks, contigs)), so counts stay in four
// registers, no atomics are needed and the result is deterministic.  The
// block stages its contig's piece starts and lengths through shared memory
// in chunks of 256 and skips, uniformly across the block, every piece that
// does not reach its column range; the vote epilogue runs in registers and
// writes the three outputs once.  Piece and draft reads of neighbouring
// threads are neighbouring bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COH_WIN = 4;
constexpr int COH_NUM = 3, COH_DEN = 4;
constexpr int COH_MIN_VALID = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(THREADS)
pileup_kernel(const uint8_t* __restrict__ draft,
              const uint8_t* __restrict__ pieces,
              const int* __restrict__ start, const int* __restrict__ plen,
              uint8_t* __restrict__ pol, int* __restrict__ dep,
              int* __restrict__ agr, int l, int m, int lr, int min_depth) {
  __shared__ int s_start[THREADS];
  __shared__ int s_len[THREADS];
  const int c = blockIdx.y;
  const int lo = blockIdx.x * THREADS;
  const int hi = min(lo + THREADS, l);
  const int col = lo + threadIdx.x;
  const uint8_t* drow = draft + (size_t)c * l;
  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;

  for (int t0 = 0; t0 < m; t0 += THREADS) {
    const int nt = min(THREADS, m - t0);
    __syncthreads();
    if (threadIdx.x < nt) {
      s_start[threadIdx.x] = start[(size_t)c * m + t0 + threadIdx.x];
      s_len[threadIdx.x] = plen[(size_t)c * m + t0 + threadIdx.x];
    }
    __syncthreads();
    for (int u = 0; u < nt; ++u) {
      const int s = s_start[u], ln = s_len[u];
      if (ln <= 0 || s >= hi || s + ln <= lo) continue;  // block-uniform
      const int idx = col - s;
      if (col >= l || idx < 0 || idx >= ln || idx >= lr) continue;
      const uint8_t* prow = pieces + ((size_t)c * m + t0 + u) * lr;
      int match = 0, valid = 0;
#pragma unroll
      for (int w = -COH_WIN; w <= COH_WIN; ++w) {
        if (w == 0) continue;
        const int rb = idx + w, cb = col + w;
        if (rb >= 0 && rb < ln && cb >= 0 && cb < l) {
          ++valid;
          match += prow[clampi(rb, 0, lr - 1)] == drow[clampi(cb, 0, l - 1)];
        }
      }
      if (COH_DEN * match >= COH_NUM * valid && valid >= COH_MIN_VALID) {
        const int base = min((int)prow[clampi(idx, 0, lr - 1)], 3);
        n0 += base == 0;
        n1 += base == 1;
        n2 += base == 2;
        n3 += base == 3;
      }
    }
  }
  if (col < l) {
    const int depth = n0 + n1 + n2 + n3;
    int best = n0, winner = 0;  // first maximum wins ties
    if (n1 > best) { best = n1; winner = 1; }
    if (n2 > best) { best = n2; winner = 2; }
    if (n3 > best) { best = n3; winner = 3; }
    const int d = drow[col];
    const int p = (depth >= min_depth && 2 * best > depth) ? winner : d;
    const int agree = p == 0 ? n0 : p == 1 ? n1 : p == 2 ? n2 : p == 3 ? n3 : 0;
    const size_t o = (size_t)c * l + col;
    pol[o] = static_cast<uint8_t>(p);
    dep[o] = depth;
    agr[o] = agree;
  }
}

}  // namespace

extern "C" int pileup_launch(const void* draft, const void* pieces,
                             const void* start, const void* plen, void* pol,
                             void* dep, void* agr, int c, int l, int m, int lr,
                             int min_depth, void* stream) {
  if (c <= 0 || l <= 0) return 0;
  if (c > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid((l + THREADS - 1) / THREADS, c), block(THREADS);
  pileup_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(draft), static_cast<const uint8_t*>(pieces),
      static_cast<const int*>(start), static_cast<const int*>(plen),
      static_cast<uint8_t*>(pol), static_cast<int*>(dep),
      static_cast<int*>(agr), l, m, lr, min_depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pileup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
