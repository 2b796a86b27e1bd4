// Dense orientation-resolved min-plus product, tiled like an SGEMM, for
// Hopper (sm_90a):  out[i,j][2x+y] = min_k min_c a[i,k][2x+c] + b[k,j][2c+y].
//
// Replaces the TPU kernel src/repro/kernels/minplus/minplus.py:minplus_pallas
// (body _minplus_kernel), which reduced (BM, BK)·(BK, BN) panels in VMEM on
// the VPU, accumulating the output block across the k grid axis.
//
// What bounds it on this card: operations.  Each (i, j, k) does 8 f32 adds
// and 8 f32 mins (16 operations) on 32 bytes of operands, and min-plus is
// not a (+, x) ring, so the tensor cores cannot help: the ceiling is the
// CUDA cores' f32 rate.  With M = N = K = n the operands are 16 n^2 bytes
// each, read from memory once per tile row/column.
//
// What the design does about it: a 64 x 64 output tile per block of 256
// threads, each thread holding a 4 x 4 micro-tile of 4-orientation minima
// in registers (64 accumulators), so every (a, b) float4 pair loaded from
// shared memory feeds 16 operations per orientation cell and every operand
// loaded from device memory is reused 64 times.  A and B tiles of 16 k
// columns go through shared memory (coalesced float4 loads, A padded by one
// float4 per row against bank conflicts).  Ragged edges load +inf, the
// additive identity.  Sums are single IEEE f32 adds and minima are exact,
// so the result equals the plain version bit for bit (no fast-math).
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16, each a 4 x 4 micro-tile

__device__ __forceinline__ float4 inf4() {
  const float inf = __int_as_float(0x7f800000);
  return make_float4(inf, inf, inf, inf);
}

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
               float4* __restrict__ out, int m, int n, int k) {
  __shared__ float4 as[BK][BM + 1];
  __shared__ float4 bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][v][q] = __int_as_float(0x7f800000);

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int t = tid + THREADS * q;
      const int ii = t / BK, kk = t % BK;
      const int gi = i0 + ii, gk = k0 + kk;
      as[kk][ii] = (gi < m && gk < k) ? a[(size_t)gi * k + gk] : inf4();
    }
#pragma unroll
    for (int q = 0; q < (BN * BK) / THREADS; ++q) {
      const int t = tid + THREADS * q;
      const int kk = t / BN, jj = t % BN;
      const int gk = k0 + kk, gj = j0 + jj;
      bs[kk][jj] = (gk < k && gj < n) ? b[(size_t)gk * n + gj] : inf4();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float4 av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = as[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 x = av[u], y = bv[v];
          // [2x+y] = min(a[2x+0] + b[0+y], a[2x+1] + b[2+y])
          acc[u][v][0] = fminf(acc[u][v][0], fminf(x.x + y.x, x.y + y.z));
          acc[u][v][1] = fminf(acc[u][v][1], fminf(x.x + y.y, x.y + y.w));
          acc[u][v][2] = fminf(acc[u][v][2], fminf(x.z + y.x, x.w + y.z));
          acc[u][v][3] = fminf(acc[u][v][3], fminf(x.z + y.y, x.w + y.w));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (i < m && j < n)
        out[(size_t)i * n + j] = make_float4(acc[u][v][0], acc[u][v][1],
                                             acc[u][v][2], acc[u][v][3]);
    }
  }
}

}  // namespace

extern "C" int minplus_launch(const void* a, const void* b, void* out, int m,
                              int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM), block(THREADS);
  minplus_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
