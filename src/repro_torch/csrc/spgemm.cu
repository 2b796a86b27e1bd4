// Ring-SUMMA local SpGEMM stages for Hopper (sm_90a): for every (stage,
// row) of a stacked A panel, rebase its column ids into the stage's B row
// block, expand the K_A x K_B candidate grid against the B panel, apply the
// semiring's (x), sort the valid candidates by output column *stably*,
// (+)-combine runs of equal column in that order, and compact the runs
// whose total is not zero into `capacity` ELL slots; runs past `capacity`
// count as overflow, summed over rows and stages.
//
// Replaces the TPU kernel src/repro/kernels/spgemm/spgemm.py:
// spgemm_ring_stages_pallas (body _spgemm_stages_kernel, per stage
// _stage_multiply), which kept a batch of stage panels and their output
// buffers resident in VMEM and ran the oracle's gather / sort / segmented
// scan / compact pipeline on them.
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
// each, and ~11 MB of A and output: 0.022 ms on an H100 SXM); the sort
// needs only V log2 V comparisons for a row of V live candidates.  This
// simple form is two orders of magnitude above that: a block gathers
// random B rows and holds up to 128 KB of keys, one block per SM.
//
// What the design does about it (simple and exact first): one block per
// (stage, row).  The valid candidates go into dynamic shared memory as
// 64-bit keys (col << 32) | candidate_index, compacted in candidate order
// by a block scan (most of the K_A x K_B slots are empty: 1186 of 8960 a
// row on the 4000-read overlap launch) and padded to a power of two with
// all-ones keys; a bitonic sort on those keys is stable by construction
// because the index breaks every tie.  A segmented pass then walks the
// sorted keys in tiles of blockDim: the thread at the start of a run folds
// the run in order (re-reading the operand values by candidate index), a
// block scan ranks the runs kept, and the first `capacity` are written.
// The launch sizes the shared buffer from K_A * K_B, the most keys a row
// can have (128 KB for 8960 candidates, above the 48 KB static limit,
// hence cudaFuncSetAttribute).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OVERLAP = 0;
constexpr int MINPLUS = 1;
constexpr uint32_t NO_COL = 0xffffffffu;

__device__ __forceinline__ float4 mp_mul(float4 x, float4 y) {
  // [2x+y] = min(a[2x+0] + b[0+y], a[2x+1] + b[2+y])
  return make_float4(fminf(x.x + y.x, x.y + y.z), fminf(x.x + y.y, x.y + y.w),
                     fminf(x.z + y.x, x.w + y.z), fminf(x.z + y.y, x.w + y.w));
}

__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) < __int_as_float(0x7f800000);  // false for inf and NaN
}

__device__ __forceinline__ bool mp_is_zero(float4 v) {
  return !finite(v.x) && !finite(v.y) && !finite(v.z) && !finite(v.w);
}

__device__ __forceinline__ uint32_t key_col(uint64_t k) {
  return static_cast<uint32_t>(k >> 32);
}

// Exclusive block scan of `flag` (0/1); returns the exclusive prefix and
// writes the block total to *total.  Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int flag, int* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = flag;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = (w > 0 ? warp_sums[w - 1] : 0) + x - flag;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

template <int SR>
__global__ void spgemm_stages_kernel(
    const int* __restrict__ offsets, const int* __restrict__ a_cols,
    const void* __restrict__ a_vals, const int* __restrict__ b_cols,
    const void* __restrict__ b_vals, int* __restrict__ out_cols,
    void* __restrict__ out0, int* __restrict__ out_apos,
    int* __restrict__ out_bpos, int* __restrict__ overflow, int n, int ka,
    int nb, int kb, int cap, int qp) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;
  int* scratch = reinterpret_cast<int*>(keys + qp);  // 32 warp sums

  const int tid = threadIdx.x, nt = blockDim.x;
  const int row = blockIdx.x, s = blockIdx.y;
  const int q_total = ka * kb;
  const int off = offsets[s];
  const size_t a_row = (static_cast<size_t>(s) * n + row) * ka;
  const int* ac = a_cols + a_row;
  const int* bcs = b_cols + static_cast<size_t>(s) * nb * kb;
  const size_t b_base = static_cast<size_t>(s) * nb * kb;

  // --- 1. the valid candidates' keys, compacted in candidate order ---
  int n_valid = 0;
  for (int base = 0; base < q_total; base += nt) {
    const int q = base + tid;
    uint32_t col = NO_COL;
    if (q < q_total) {
      const int a = q / kb, b = q - a * kb;
      const int c = ac[a];
      const int r = c - off;
      if (c >= 0 && r >= 0 && r < nb) {
        const size_t bi = static_cast<size_t>(r) * kb + b;
        const int bc = bcs[bi];
        if (bc >= 0) {
          bool ok = true;
          if (SR == MINPLUS) {
            const float4 av = reinterpret_cast<const float4*>(a_vals)[a_row + a];
            const float4 bv = reinterpret_cast<const float4*>(b_vals)[b_base + bi];
            ok = !mp_is_zero(mp_mul(av, bv));
          }
          if (ok) col = static_cast<uint32_t>(bc);
        }
      }
    }
    const int valid = col != NO_COL;
    int tile_total;
    const int pos = n_valid + block_scan(valid, scratch, &tile_total);
    if (valid)
      keys[pos] = (static_cast<uint64_t>(col) << 32) | static_cast<uint32_t>(q);
    n_valid += tile_total;
  }
  int vp = 1;  // sort the next power of two, padded with all-ones keys
  while (vp < n_valid) vp <<= 1;
  for (int p = n_valid + tid; p < vp; p += nt) keys[p] = ~0ull;
  __syncthreads();

  // --- 2. bitonic sort, ascending; keys are unique, so it is stable ---
  for (int k = 2; k <= vp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < vp; p += nt) {
        const int ixj = p ^ j;
        if (ixj > p) {
          const uint64_t x = keys[p], y = keys[ixj];
          const bool up = (p & k) == 0;
          if ((x > y) == up) {
            keys[p] = y;
            keys[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // --- 3. segmented (+) over runs of equal column, rank, compact ---
  const size_t out_row = (static_cast<size_t>(s) * n + row) * cap;
  int carry = 0;
  for (int base = 0; base < n_valid; base += nt) {
    const int p = base + tid;
    int kept = 0;
    uint32_t col = 0;
    int cnt = 0, a0 = -1, a1 = -1, b0 = -1, b1 = -1;
    const float inf = __int_as_float(0x7f800000);
    float4 acc = make_float4(inf, inf, inf, inf);
    if (p < n_valid) {
      col = key_col(keys[p]);
      if (p == 0 || key_col(keys[p - 1]) != col) {
        for (int p2 = p; p2 < n_valid && key_col(keys[p2]) == col; ++p2) {
          const int q = static_cast<int>(static_cast<uint32_t>(keys[p2]));
          const int a = q / kb, b = q - a * kb;
          const size_t bi = static_cast<size_t>(ac[a] - off) * kb + b;
          if (SR == OVERLAP) {
            const int ap = reinterpret_cast<const int*>(a_vals)[a_row + a];
            const int bp = reinterpret_cast<const int*>(b_vals)[b_base + bi];
            if (cnt == 0) {
              a0 = ap;
              b0 = bp;
            } else if (cnt == 1) {
              a1 = ap;
              b1 = bp;
            }
            cnt += 1;
          } else {
            const float4 av = reinterpret_cast<const float4*>(a_vals)[a_row + a];
            const float4 bv = reinterpret_cast<const float4*>(b_vals)[b_base + bi];
            const float4 m = mp_mul(av, bv);
            acc = make_float4(fminf(acc.x, m.x), fminf(acc.y, m.y),
                              fminf(acc.z, m.z), fminf(acc.w, m.w));
          }
        }
        kept = SR == OVERLAP ? (cnt != 0) : !mp_is_zero(acc);
      }
    }
    int tile_total;
    const int rank = carry + block_scan(kept, scratch, &tile_total);
    if (kept && rank < cap) {
      const size_t o = out_row + rank;
      out_cols[o] = static_cast<int>(col);
      if (SR == OVERLAP) {
        reinterpret_cast<int*>(out0)[o] = cnt;
        out_apos[2 * o] = a0;
        out_apos[2 * o + 1] = a1;
        out_bpos[2 * o] = b0;
        out_bpos[2 * o + 1] = b1;
      } else {
        reinterpret_cast<float4*>(out0)[o] = acc;
      }
    }
    carry += tile_total;
  }

  // --- 4. empty slots, overflow ---
  const float inf = __int_as_float(0x7f800000);
  for (int r = carry + tid; r < cap; r += nt) {
    const size_t o = out_row + r;
    out_cols[o] = -1;
    if (SR == OVERLAP) {
      reinterpret_cast<int*>(out0)[o] = 0;
      out_apos[2 * o] = -1;
      out_apos[2 * o + 1] = -1;
      out_bpos[2 * o] = -1;
      out_bpos[2 * o + 1] = -1;
    } else {
      reinterpret_cast<float4*>(out0)[o] = make_float4(inf, inf, inf, inf);
    }
  }
  if (tid == 0 && carry > cap) atomicAdd(overflow, carry - cap);
}

template <int SR>
cudaError_t launch(const int* offsets, const int* a_cols, const void* a_vals,
                   const int* b_cols, const void* b_vals, int* out_cols,
                   void* out0, int* out_apos, int* out_bpos, int* overflow,
                   int stages, int n, int ka, int nb, int kb, int cap,
                   cudaStream_t stream) {
  int qp = 1;
  while (qp < ka * kb) qp <<= 1;
  int threads = qp / 2;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  const size_t shmem = 8 * static_cast<size_t>(qp) + 4 * 40;
  cudaError_t err = cudaFuncSetAttribute(
      spgemm_stages_kernel<SR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  dim3 grid(n, stages);
  spgemm_stages_kernel<SR><<<grid, threads, shmem, stream>>>(
      offsets, a_cols, a_vals, b_cols, b_vals, out_cols, out0, out_apos,
      out_bpos, overflow, n, ka, nb, kb, cap, qp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spgemm_launch(int semiring, const void* offsets,
                             const void* a_cols, const void* a_vals,
                             const void* b_cols, const void* b_vals,
                             void* out_cols, void* out0, void* out1,
                             void* out2, void* overflow, int stages, int n,
                             int ka, int nb, int kb, int cap, void* stream) {
  if (stages <= 0 || n <= 0) return 0;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int*>(offsets);
  const auto* ac = static_cast<const int*>(a_cols);
  const auto* bc = static_cast<const int*>(b_cols);
  auto* oc = static_cast<int*>(out_cols);
  auto* ovf = static_cast<int*>(overflow);
  cudaError_t err;
  if (semiring == OVERLAP) {
    err = launch<OVERLAP>(off, ac, a_vals, bc, b_vals, oc, out0,
                          static_cast<int*>(out1), static_cast<int*>(out2),
                          ovf, stages, n, ka, nb, kb, cap, st);
  } else if (semiring == MINPLUS) {
    err = launch<MINPLUS>(off, ac, a_vals, bc, b_vals, oc, out0, nullptr,
                          nullptr, ovf, stages, n, ka, nb, kb, cap, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* spgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
