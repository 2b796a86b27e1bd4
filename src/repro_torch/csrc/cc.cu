// Fused hook / in-hook / pointer-jump connected-components rounds, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cc/cc.py:cc_rounds_pallas (body
// _cc_rounds_kernel), which kept the label row and both ELL neighbour
// blocks in VMEM inside one program and ran `rounds` rounds there:
//
//   l1 = min(l,  min over out-neighbours u of l[u])
//   l2 = min(l1, min over in-neighbours  u of l1[u])
//   l3 = l2[l2]
//
// with empty (-1) slots counting as 2^30, returning the labels and a flag
// set if any round changed any label (l3 != l at the start of the round).
//
// What bounds it on this card: the bytes of oc, ic and the labels, read
// once per call (each input once, the labels and the flag written once).
// Within a call the rounds re-read the ELL blocks and the 3n label words
// from L2 (50 MB holds the state graphs of the main path many times over),
// so the floor is the one pass over device memory, against which the
// rounds' L2 traffic and the grid barriers between steps compete.
//
// Why the launch is cooperative: every step reads a whole vector written
// by the step before (step 1 all of l, step 2 all of l1, step 3 all of
// l2).  Updating in place without a barrier still converges to the same
// final labels, but it changes the per-call changed flag, hence the number
// of rounds the driver executes and reports, and the labels of a run cut
// short by max_iters.  So the kernel double-buffers: l lives in `lab` (the
// wrapper's copy of the input labels), l1 and l2 in two scratch vectors,
// and a grid-wide barrier (cooperative_groups::this_grid().sync())
// separates the steps.  That needs every block resident at once, so the
// wrapper launches with cudaLaunchCooperativeKernel on a grid sized from
// the occupancy calculator times the SM count, and each thread walks its
// vertices with a grid-stride loop.  This works at any n that fits on the
// card; a one-block shared-memory version would stop at ~29 k vertices.
//
// Step 3 writes l3 into `lab` in place: during step 3 no thread reads
// `lab` except its own vertex's old label (for the changed test), and the
// next round's step 1 starts only after the barrier.  The flag is set with
// one atomicOr per thread that saw a change, into an int the wrapper
// zeroes.  Masked slots are never dereferenced; a column >= n is clamped
// to n - 1, as the TPU kernel clips its indices.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BIG = 1 << 30;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cc_rounds_kernel(const int* __restrict__ oc, const int* __restrict__ ic,
                 int* lab, int* l1, int* l2, int* changed, int n, int k_out,
                 int k_in, int rounds) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool chg = false;
  for (int r = 0; r < rounds; ++r) {
    // step 1: hook over out-neighbours
    for (long long v = first; v < n; v += stride) {
      int m = lab[v];
      const int* row = oc + v * k_out;
      for (int s = 0; s < k_out; ++s) {
        const int u = row[s];
        const int x = u >= 0 ? lab[min(u, n - 1)] : BIG;
        m = min(m, x);
      }
      l1[v] = m;
    }
    grid.sync();
    // step 2: hook over in-neighbours (the oracle's scatter-min push)
    for (long long v = first; v < n; v += stride) {
      int m = l1[v];
      const int* row = ic + v * k_in;
      for (int s = 0; s < k_in; ++s) {
        const int u = row[s];
        const int x = u >= 0 ? l1[min(u, n - 1)] : BIG;
        m = min(m, x);
      }
      l2[v] = m;
    }
    grid.sync();
    // step 3: shortcut, compared with the label at the start of the round
    for (long long v = first; v < n; v += stride) {
      const int l3 = l2[l2[v]];
      chg |= l3 != lab[v];
      lab[v] = l3;
    }
    grid.sync();
  }
  if (chg) atomicOr(changed, 1);
}

}  // namespace

extern "C" int cc_launch(const void* oc, const void* ic, void* lab, void* l1,
                         void* l2, void* changed, int n, int k_out, int k_in,
                         int rounds, void* stream) {
  if (k_out < 0 || k_in < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || rounds <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cc_rounds_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long want = ((long long)n + THREADS - 1) / THREADS;
  const long long cap = (long long)per_sm * sms;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const int* oc_p = static_cast<const int*>(oc);
  const int* ic_p = static_cast<const int*>(ic);
  int* lab_p = static_cast<int*>(lab);
  int* l1_p = static_cast<int*>(l1);
  int* l2_p = static_cast<int*>(l2);
  int* chg_p = static_cast<int*>(changed);
  void* args[] = {&oc_p, &ic_p, &lab_p, &l1_p, &l2_p, &chg_p,
                  &n, &k_out, &k_in, &rounds};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cc_rounds_kernel), dim3(blocks), dim3(THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
