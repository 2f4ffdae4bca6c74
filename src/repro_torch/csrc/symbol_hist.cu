// Integer-symbol histogram, for sm_90a.
//
// Replaces: src/repro/kernels/group_hist.py::symbol_hist (Pallas), reached
// through repro/kernels/ops.py::symbol_hist_op.  Computes hist[v] += 1 for
// every int32 symbol v in [0, n_bins); values outside are ignored (the
// reference sends them to a sentinel bin it then drops).  HuffmanCodec.fit
// counts each lane's shifted Lorenzo codes with it.
//
// What bounds it on the H100: bytes, in principle -- 4 B read per symbol
// plus 4 B written per bin; one 64^3 lane is 1 MiB, 0.31 us at 3.35 TB/s.
// At that size the launch itself (a few us) dominates, and a skewed
// alphabet piles atomics onto a few bins.
//
// Design: the TPU kernel summed a [rows, 128, bins] one-hot into a VMEM
// accumulator revisited by sequential grid steps.  Here each block keeps
// private bins in shared memory (shared-memory atomics absorb the skew),
// walks the input grid-stride, and merges its nonzero bins into the global
// histogram once with global atomics.  Alphabets wider than 48 KB of
// shared memory (12,288 bins, up to the codec's dense span of 2^22) count
// straight into global memory with atomics, so no dense lane falls back to
// the host.  The wrapper zeroes `hist`; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_BINS = 48 * 1024 / 4;

__global__ void __launch_bounds__(THREADS)
symbol_hist_shared(const int32_t* __restrict__ s, long long n, int n_bins,
                   int32_t* __restrict__ hist) {
  extern __shared__ int32_t bins[];
  for (int i = threadIdx.x; i < n_bins; i += THREADS) bins[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int32_t v = s[i];
    if (v >= 0 && v < n_bins) atomicAdd(&bins[v], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += THREADS) {
    const int32_t c = bins[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

__global__ void __launch_bounds__(THREADS)
symbol_hist_global(const int32_t* __restrict__ s, long long n, int n_bins,
                   int32_t* __restrict__ hist) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int32_t v = s[i];
    if (v >= 0 && v < n_bins) atomicAdd(&hist[v], 1);
  }
}

}  // namespace

extern "C" int symbol_hist(const void* s, long long n, int n_bins, void* hist, void* stream) {
  if (n <= 0 || n_bins <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (n + THREADS * 8 - 1) / (THREADS * 8);  // ~8 symbols a thread
  if (blocks > 1024) blocks = 1024;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int32_t*>(s);
  auto* hp = static_cast<int32_t*>(hist);
  if (n_bins <= SMEM_BINS)
    symbol_hist_shared<<<static_cast<unsigned>(blocks), THREADS, n_bins * sizeof(int32_t), st>>>(
        sp, n, n_bins, hp);
  else
    symbol_hist_global<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(sp, n, n_bins, hp);
  return static_cast<int>(cudaGetLastError());
}
