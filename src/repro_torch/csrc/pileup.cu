// Banded pileup with the +-4 coherence gate and the strict-majority vote,
// for Hopper (sm_90a): a piece list per column tile, on the packed layout.
//
// Replaces the TPU kernel src/repro/kernels/pileup/pileup.py:pileup_pallas
// (body _pileup_kernel), which tiled (contig, column band) blocks of a
// draft padded to the longest contig and kept a (4, band) count block in
// VMEM while looping over all M piece slots of the contig, M the longest
// chain's.
//
// The layout holds live slots only: the contigs' columns lie end to end in
// one flat draft (contig c's at first[c] .. first[c] + lengths[c]), the
// pieces are rows of LR bytes, each naming its contig, and a contig of L_c
// columns has ceil(L_c / TILE) tiles, numbered contig after contig
// (tile_first[c] is its first; tile_contig[k] the contig of tile k, C past
// the last).  The coherence window still runs to L, the longest contig's
// length, and reads code 0 past a contig's end: what a draft padded to L
// columns with zeros holds there, so the votes are the padded layout's.
//
// What bounds it on this card: neither bytes nor operations, but the pass
// over (tile, piece).  A piece votes on at most LR consecutive columns of
// its contig, so a tile of TILE columns meets only the few pieces whose
// vote columns reach it (5-6 at depth 14), while a walk over every piece
// of the contig (2048 at 4000 reads) tests and skips the rest; the bytes
// are the draft and the pieces once and 9 bytes a column out.
//
// What the design does about it, in three launches and no host read:
//   * pileup_bin_kernel<false> (one thread a piece) counts, for every tile,
//     the pieces whose vote columns
//         [max(s, 0), min(s + min(ln, LR), L_c))
//     reach the tile; the wrapper turns the counts into the end of each
//     tile's list (an inclusive cumsum on the device);
//     pileup_bin_kernel<true> (the same walk) writes each piece's index
//     into the lists of its tiles, its place taken by an atomicSub on the
//     tile's count.  The order inside a list is arbitrary: votes are
//     integer counts, so it changes no result.  A piece reaches at most
//     ceil(LR / TILE) + 1 tiles, so the lists need at most P times that
//     many entries, sized from shapes alone.
//   * pileup_vote_kernel, one block of TILE threads per tile, one column a
//     thread, visits only its tile's listed pieces (their index, start and
//     length staged in shared memory, TILE at a time).  For each it forms
//     one bit per column, "the piece's base == the draft base", inside the
//     piece's window range [max(s, 0), min(s + ln, L)) (a byte past LR
//     reads byte LR - 1, as the oracle's clip does); the bits of a warp are
//     one ballot, and warps 0 and TILE/32 - 1 also ballot the 4 halo
//     columns on either side.  A vote's 8-wide coherence count is then one
//     __popcll over a 64-bit window of three neighbouring ballot words, and
//     the count of comparable positions follows in closed form from the
//     window range.  The piece bytes of neighbouring threads are
//     neighbouring bytes (coalesced loads); the draft byte of a thread's
//     column sits in a register.  Counts stay in four registers a thread,
//     and the vote epilogue writes the three outputs once, coalesced.
//     The grid is sized from shapes alone (B / TILE + C blocks); the
//     blocks past the last tile return at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COH_WIN = 4;
constexpr int COH_NUM = 3, COH_DEN = 4;
constexpr int COH_MIN_VALID = 4;
constexpr int TILE = 256;  // columns a tile: threads of a vote block
constexpr int WARPS = TILE / 32;
constexpr int BIN_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the window bits of a vote: the 4 columns on either side, not the centre
constexpr unsigned long long WINDOW = 0x1EFull;
static_assert(COH_WIN == 4, "the ballot window is 4 columns a side");

// The columns a piece of start s and length ln votes on: [lo, hi), empty
// when hi <= lo.
__device__ __forceinline__ void vote_range(int s, int ln, int l, int lr,
                                           int& lo, int& hi) {
  lo = max(s, 0);
  const long long e = static_cast<long long>(s) + min(ln, lr);
  hi = static_cast<int>(min(e, static_cast<long long>(l)));
}

// The byte of a piece of start s at column x >= s: x - s, clipped to LR - 1
// (the oracle's clip, for pieces longer than LR).
__device__ __forceinline__ long long piece_index(int x, int s, int lr) {
  return min(static_cast<long long>(x) - s, static_cast<long long>(lr) - 1);
}

// FILL = false: cnt[k] += 1 for every tile k a piece reaches.  FILL = true:
// the same walk writes the piece's index into those tiles' lists, ends[]
// being the inclusive cumsum of the counts (which this pass takes back down
// to 0).
template <bool FILL>
__global__ void __launch_bounds__(BIN_THREADS)
pileup_bin_kernel(const int* __restrict__ start, const int* __restrict__ plen,
                  const int* __restrict__ contig,
                  const int* __restrict__ lengths,
                  const long long* __restrict__ tile_first,
                  int* __restrict__ cnt, const int* __restrict__ ends,
                  int* __restrict__ list, int np, int lr) {
  const long long p = static_cast<long long>(blockIdx.x) * BIN_THREADS +
                      threadIdx.x;
  if (p >= np) return;
  const int c = contig[p];
  int lo, hi;
  vote_range(start[p], plen[p], lengths[c], lr, lo, hi);
  if (lo >= hi) return;
  const long long k0 = tile_first[c];
  for (int t = lo / TILE; t <= (hi - 1) / TILE; ++t) {
    const long long k = k0 + t;
    if (FILL)
      list[ends[k] - atomicSub(&cnt[k], 1)] = static_cast<int>(p);
    else
      atomicAdd(&cnt[k], 1);
  }
}

__global__ void __launch_bounds__(TILE)
pileup_vote_kernel(const uint8_t* __restrict__ draft,
                   const uint8_t* __restrict__ pieces,
                   const int* __restrict__ start, const int* __restrict__ plen,
                   const int* __restrict__ tile_contig,
                   const long long* __restrict__ tile_first,
                   const long long* __restrict__ first,
                   const int* __restrict__ lengths,
                   const int* __restrict__ ends, const int* __restrict__ list,
                   uint8_t* __restrict__ pol, int* __restrict__ dep,
                   int* __restrict__ agr, int n_contigs, int l, int lr,
                   int min_depth) {
  __shared__ int s_piece[TILE], s_start[TILE], s_len[TILE];
  // the ballot words of a piece, double-buffered by piece: [0] the left
  // halo (bits 28..31: columns t0-4 .. t0-1), [1 + w] warp w's columns,
  // [WARPS + 1] the right halo (bits 0..3: columns t0+TILE .. t0+TILE+3)
  __shared__ unsigned words[2][WARPS + 2];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long blk = blockIdx.x;
  const int c = tile_contig[blk];
  if (c >= n_contigs) return;  // past the last tile: the whole block
  const int lc = lengths[c];
  const int t0 = static_cast<int>(blk - tile_first[c]) * TILE;
  const int col = t0 + tid;
  const uint8_t* drow = draft + first[c];
  // past the contig's end, up to L, the draft reads 0 (the padded layout)
  const int d_own = col < lc ? drow[col] : 0;
  // the halo column this lane ballots for its warp, if any
  int hx = -1;
  if (w == 0 && lane >= 32 - COH_WIN) hx = t0 - 32 + lane;
  if (w == WARPS - 1 && lane < COH_WIN) hx = t0 + TILE + lane;
  const bool has_halo = hx >= 0 && hx < l;
  const int d_halo = has_halo && hx < lc ? drow[hx] : 0;

  const int b0 = blk > 0 ? ends[blk - 1] : 0, b1 = ends[blk];
  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
  for (int k0 = b0; k0 < b1; k0 += TILE) {
    const int nk = min(TILE, b1 - k0);
    __syncthreads();  // the previous chunk's pieces are done with
    if (tid < nk) {
      const int p = list[k0 + tid];
      s_piece[tid] = p;
      s_start[tid] = start[p];
      s_len[tid] = plen[p];
    }
    __syncthreads();
    for (int u = 0; u < nk; ++u) {
      const int s = s_start[u], ln = s_len[u];
      const uint8_t* prow =
          pieces + static_cast<long long>(s_piece[u]) * lr;
      // the window range: columns x with 0 <= x - s < ln and 0 <= x < L
      const int lo = max(s, 0);
      const int hi = static_cast<int>(
          min(static_cast<long long>(s) + ln, static_cast<long long>(l)));
      const bool in = col >= lo && col < hi;
      const int pb = in ? prow[piece_index(col, s, lr)] : 0;
      const bool eq = in && pb == d_own;
      const bool heq = has_halo && hx >= lo && hx < hi &&
                       prow[piece_index(hx, s, lr)] == d_halo;
      const unsigned wb = __ballot_sync(FULL, eq);
      const unsigned hb = __ballot_sync(FULL, heq);
      unsigned* wd = words[u & 1];
      if (lane == 0) {
        wd[w + 1] = wb;
        if (w == 0) wd[0] = hb;
        if (w == WARPS - 1) wd[WARPS + 1] = hb;
      }
      __syncthreads();
      // a vote needs 0 <= col - s < min(ln, LR) and col < L_c
      int vlo, vhi;
      vote_range(s, ln, lc, lr, vlo, vhi);
      if (col >= vlo && col < vhi) {
        const int valid = min(col + COH_WIN + 1, hi) -
                          max(col - COH_WIN, lo) - 1;
        const unsigned long long big =
            (static_cast<unsigned long long>(wd[w + 2]) << 36) |
            (static_cast<unsigned long long>(wd[w + 1]) << 4) |
            (wd[w] >> 28);
        const int match = __popcll((big >> lane) & WINDOW);
        if (COH_DEN * match >= COH_NUM * valid && valid >= COH_MIN_VALID) {
          const int base = min(pb, 3);
          n0 += base == 0;
          n1 += base == 1;
          n2 += base == 2;
          n3 += base == 3;
        }
      }
    }
  }
  if (col < lc) {
    const int depth = n0 + n1 + n2 + n3;
    int best = n0, winner = 0;  // first maximum wins ties
    if (n1 > best) { best = n1; winner = 1; }
    if (n2 > best) { best = n2; winner = 2; }
    if (n3 > best) { best = n3; winner = 3; }
    const int p = (depth >= min_depth && 2 * best > depth) ? winner : d_own;
    const int agree = p == 0 ? n0 : p == 1 ? n1 : p == 2 ? n2 : p == 3 ? n3 : 0;
    const long long o = first[c] + col;
    pol[o] = static_cast<uint8_t>(p);
    dep[o] = depth;
    agr[o] = agree;
  }
}

template <bool FILL>
int bin_launch(const void* start, const void* plen, const void* contig,
               const void* lengths, const void* tile_first, void* cnt,
               const void* ends, void* list, int np, int lr, void* stream) {
  if (np <= 0) return 0;
  const int blocks = (np + BIN_THREADS - 1) / BIN_THREADS;
  pileup_bin_kernel<FILL><<<blocks, BIN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const int*>(plen),
      static_cast<const int*>(contig), static_cast<const int*>(lengths),
      static_cast<const long long*>(tile_first), static_cast<int*>(cnt),
      static_cast<const int*>(ends), static_cast<int*>(list), np, lr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Columns of a tile (the wrapper sizes its buffers by it).
extern "C" int pileup_tile() { return TILE; }

// The count pass: cnt (one int a tile, zeroed by the caller).
extern "C" int pileup_bin_count(const void* start, const void* plen,
                                const void* contig, const void* lengths,
                                const void* tile_first, void* cnt, int np,
                                int lr, void* stream) {
  return bin_launch<false>(start, plen, contig, lengths, tile_first, cnt,
                           nullptr, nullptr, np, lr, stream);
}

// The fill pass: ends = the inclusive cumsum of cnt; list has room for
// ends[last] entries.
extern "C" int pileup_bin_fill(const void* start, const void* plen,
                               const void* contig, const void* lengths,
                               const void* tile_first, void* cnt,
                               const void* ends, void* list, int np, int lr,
                               void* stream) {
  return bin_launch<true>(start, plen, contig, lengths, tile_first, cnt, ends,
                          list, np, lr, stream);
}

// The vote launch: one block per tile of the grid's `tiles` (the bound the
// wrapper sizes from shapes; blocks past the last tile return).
extern "C" int pileup_launch(const void* draft, const void* pieces,
                             const void* start, const void* plen,
                             const void* tile_contig, const void* tile_first,
                             const void* first, const void* lengths,
                             const void* ends, const void* list, void* pol,
                             void* dep, void* agr, int c, int tiles, int l,
                             int lr, int min_depth, void* stream) {
  if (c <= 0 || tiles <= 0) return 0;
  pileup_vote_kernel<<<tiles, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(draft), static_cast<const uint8_t*>(pieces),
      static_cast<const int*>(start), static_cast<const int*>(plen),
      static_cast<const int*>(tile_contig),
      static_cast<const long long*>(tile_first),
      static_cast<const long long*>(first), static_cast<const int*>(lengths),
      static_cast<const int*>(ends), static_cast<const int*>(list),
      static_cast<uint8_t*>(pol), static_cast<int*>(dep),
      static_cast<int*>(agr), c, l, lr, min_depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pileup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
