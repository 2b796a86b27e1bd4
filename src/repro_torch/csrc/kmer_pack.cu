// Canonical k-mer packing for Hopper (sm_90a): every k-mer instance of
// every read, straight from the read codes.
//
//   hi[i, p], lo[i, p]  the canonical k-mer at position p of read i: the
//                       smaller (int32 (hi, lo) order) of the forward
//                       k-mer codes[i, p : p + k] and its reverse
//                       complement, 15 bases a word, 2 bits a base,
//                       big-endian and left aligned (1 <= k <= 30);
//   strand[i, p]        1 where the reverse complement was taken;
//   valid[i, p]         p < lengths[i] - k + 1;
//
// at every p < P = L - k + 1, pad positions included.  Codes are uint8
// (A=0, C=1, G=2, T=3).  The words are the plain version's int32
// arithmetic (kernels/kmer_pack/ref.py `_pack`: hi = hi * 4 + code over
// the k-mer's bases, then * 4^(15 - bases)) in the ring of integers mod
// 2^32, where that Horner sum is the sum of code << 2 (14 - t) over the
// word's bases t, in any order; the complement of a code is 3 - code.  So
// the kernel is exact for every byte, codes past 3 included.
//
// Replaces no TPU kernel: the JAX package extracts k-mers in array code
// (repro.assembly.kmers.extract_kmers), and the plain version gathers an
// (n, P, k) int32 window tensor, its flip and its complement and packs
// them with 2k strided multiply-adds.  This kernel allocates nothing of
// size (n, P, k).
//
// What bounds it on this card: bytes.  It reads the codes once (n L bytes)
// and writes 13 bytes an instance (three int32 words and a bool); at the
// benchmark's one-card cell (14,863 reads x 13,216 columns, k = 15) that is
// 2.75 GB, 0.82 ms at 3.35 TB/s.  The arithmetic has to stay well below
// that: a window's 2k codes read one at a time would cost more than the
// stores.
//
// What the design does about it:
//   * one block a (read, tile of TILE positions): the tile's codes and
//     their k - 1 halo go to shared memory once (coalesced byte loads);
//   * where every code of the tile is 0..3 (the block agrees with
//     __syncthreads_or), each 16 codes are packed into one 32-bit word,
//     and the reverse complement of the whole tile is the same words in
//     the opposite order with their 2-bit digits reversed (__brev and a
//     swap of each bit pair) and inverted (3 - c is c ^ 3).  A position's
//     forward k-mer is then a 64-bit window of the forward stream and its
//     reverse complement a window of the reverse stream: three word loads,
//     two funnel shifts and a mask each, no loop over k;
//   * a tile that holds a code past 3 sums code << shift over the window
//     instead (the ring sum above), which is the plain version's
//     arithmetic for every byte;
//   * thread t of the block takes positions t, t + THREADS, ...: a warp's
//     stores are 32 consecutive words of each output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;  // positions a block
constexpr int MAX_K = 30;
// the tile's codes, halo included, as whole 16-code words (1056 >= TILE +
// MAX_K - 1), and two zero words past the end for a window's third load
constexpr int WORDS = (TILE + MAX_K - 1 + 15) / 16;
constexpr int CODES = 16 * WORDS;
constexpr int MAX_TILES = 65535;  // gridDim.y

// The 64-bit window of a 2-bit stream that starts at digit `start`:
// digit start + d at bits 63 - 2d and 62 - 2d of (w_hi : w_lo).
__device__ __forceinline__ void window(const uint32_t* s, int start,
                                       uint32_t& w_hi, uint32_t& w_lo) {
  const int w = start >> 4;
  const int sh = (start & 15) * 2;
  const uint32_t a0 = s[w], a1 = s[w + 1], a2 = s[w + 2];
  w_hi = __funnelshift_l(a1, a0, sh);
  w_lo = __funnelshift_l(a2, a1, sh);
}

// The (hi, lo) words of a window: digits 0..14 left aligned in hi (bits 29
// down), digits 15..29 in lo, each cut to the k-mer's digits by its mask.
__device__ __forceinline__ void split(uint32_t w_hi, uint32_t w_lo,
                                      uint32_t hi_mask, uint32_t lo_mask,
                                      uint32_t& hi, uint32_t& lo) {
  hi = (w_hi >> 2) & hi_mask;
  lo = (((w_hi & 3u) << 28) | (w_lo >> 4)) & lo_mask;
}

// 2-bit digits of x in the opposite order, each complemented (3 - c).
__device__ __forceinline__ uint32_t revcomp_digits(uint32_t x) {
  const uint32_t y = __brev(x);  // digits reversed, each digit's bits swapped
  return ~(((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1));
}

__global__ void __launch_bounds__(THREADS)
    kmer_pack_kernel(const uint8_t* __restrict__ codes,
                     const int* __restrict__ lengths, int* __restrict__ hi,
                     int* __restrict__ lo, int* __restrict__ strand,
                     bool* __restrict__ valid, int L, int k) {
  __shared__ __align__(16) uint8_t code_s[CODES];
  __shared__ uint32_t fwd_s[WORDS + 2];
  __shared__ uint32_t rev_s[WORDS + 2];

  const int row = blockIdx.x;
  const int p0 = blockIdx.y * TILE;
  const int P = L - k + 1;
  const int tid = threadIdx.x;
  const uint8_t* crow = codes + static_cast<long long>(row) * L;

  int outside = 0;  // a code of the tile past 3
  for (int c = tid; c < CODES; c += THREADS) {
    const int g = p0 + c;
    const uint8_t v = g < L ? crow[g] : 0;
    code_s[c] = v;
    outside |= v > 3;
  }
  const bool general = __syncthreads_or(outside);

  if (!general) {
    // forward word w and reverse word WORDS - 1 - w from the same codes
    if (tid < WORDS) {
      const uint4 q = reinterpret_cast<const uint4*>(code_s)[tid];
      const uint32_t part[4] = {q.x, q.y, q.z, q.w};
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          word = (word << 2) | ((part[j] >> (8 * b)) & 3u);
      fwd_s[tid] = word;
      rev_s[WORDS - 1 - tid] = revcomp_digits(word);
    } else if (tid < WORDS + 2) {
      fwd_s[tid] = 0;
      rev_s[tid] = 0;
    }
    __syncthreads();
  }

  const int kh = k < 15 ? k : 15;
  const uint32_t hi_mask = 0xffffffffu << (2 * (15 - kh));
  const uint32_t lo_mask = k > 15 ? 0xffffffffu << (2 * (30 - k)) : 0u;
  const int len = lengths[row];
  // lengths[i] - k + 1 in int32, as the plain version computes it
  const int limit = static_cast<int>(static_cast<uint32_t>(len) -
                                     static_cast<uint32_t>(k) + 1u);
  const long long base = static_cast<long long>(row) * P;

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int o = tid + j * THREADS;
    const int p = p0 + o;
    if (p >= P) break;
    uint32_t fh, fl, rh, rl;
    if (!general) {
      uint32_t a, b;
      window(fwd_s, o, a, b);
      split(a, b, hi_mask, lo_mask, fh, fl);
      // the reverse stream's digit j is 3 - code[CODES - 1 - j], so the
      // window's reverse complement starts at CODES - o - k
      window(rev_s, CODES - o - k, a, b);
      split(a, b, hi_mask, lo_mask, rh, rl);
    } else {
      fh = fl = rh = rl = 0;
      for (int t = 0; t < k; ++t) {
        const uint32_t c = code_s[o + t];
        if (t < 15) fh += c << (28 - 2 * t);
        else fl += c << (58 - 2 * t);
        const int u = k - 1 - t;  // the base's place in the complement
        if (u < 15) rh += (3u - c) << (28 - 2 * u);
        else rl += (3u - c) << (58 - 2 * u);
      }
    }
    const int sfh = static_cast<int>(fh), sfl = static_cast<int>(fl);
    const int srh = static_cast<int>(rh), srl = static_cast<int>(rl);
    const bool fwd = sfh < srh || (sfh == srh && sfl <= srl);
    const long long e = base + p;
    hi[e] = fwd ? sfh : srh;
    lo[e] = fwd ? sfl : srl;
    strand[e] = fwd ? 0 : 1;
    valid[e] = p < limit;
  }
}

}  // namespace

extern "C" int kmer_pack_launch(const void* codes, const void* lengths,
                                void* hi, void* lo, void* strand, void* valid,
                                int n, int L, int k, void* stream) {
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int P = L - k + 1;
  if (n <= 0 || P <= 0) return 0;
  const int tiles = (P + TILE - 1) / TILE;
  if (tiles > MAX_TILES) return static_cast<int>(cudaErrorInvalidValue);
  kmer_pack_kernel<<<dim3(n, tiles), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(lengths),
      static_cast<int*>(hi), static_cast<int*>(lo), static_cast<int*>(strand),
      static_cast<bool*>(valid), L, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmer_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
