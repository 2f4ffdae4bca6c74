// Integer-symbol histograms of many lanes in one launch, for sm_90a.
//
// Replaces: src/repro/kernels/group_hist.py::symbol_hist (Pallas), reached
// through repro/kernels/ops.py::symbol_hist_op.  Computes, for every lane l
// of codes [L, n] int32 and its base lo[l] (NULL: 0),
//     hist[l, v - lo[l]] += 1   for each symbol v of row l with
//                               0 <= v - lo[l] < n_bins,
// the difference taken exactly (no int32 wrap); other values are ignored.
// The TPU kernel computes one row with lo = 0 (it sends out-of-range values
// to a sentinel bin it drops).  The tiled encode counts all 512 lanes of a
// 512^3 field in one launch (sz/entropy.py::encode_codes_lanes); one stream
// is its L = 1 call.
//
// What bounds it on the H100: bytes -- 4 B read per symbol and 4 B written
// per bin; the 512 lanes of 262,144 symbols are 512 MiB, 0.160 ms at
// 3.35 TB/s.  Lorenzo codes of a smooth field pile onto a few bins, and
// counting them must not make the blocks wait on one another there.
//
// Design: the TPU kernel summed a [rows, 128, bins] one-hot into a VMEM
// accumulator revisited by sequential grid steps.  Here:
// * Loads are int4 (a row's few elements before its first 16-byte boundary
//   and after its last are counted by the row's first block one a thread),
//   UNROLL of them in flight a thread, with the streaming hint.
// * Skew: each warp counts into its own copy of the bins (up to WARPS
//   copies, as many as fit COPY_BYTES), so warps never meet on a hot bin;
//   lanes of one warp on one bin are left to the shared-memory atomic unit,
//   which on the H100 takes them at close to the load rate (folding them
//   first with __match_any_sync was tried and was slower on skewed codes).
// * Grid: `parts` blocks a lane, so that the grid fills the card's resident
//   blocks once.  With parts == 1 -- the batched tiled call: 512 lanes on
//   132 SMs -- a block owns its lane's whole row and stores it with plain
//   stores, zeros included: no memset and no global atomics.  With
//   parts > 1 (one stream) the blocks merge their nonzero bins into the
//   zeroed row with global atomics.
// * Spans past SMEM_BINS (one copy in the 227 KB a block may opt in to) up
//   to the codec's dense span of 2^22 count straight into the zeroed global
//   row with global atomics.
// The entry point zeroes `hist` itself (cudaMemsetAsync) when the launch does
// not store whole rows; it allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                  // int4 loads in flight a thread
constexpr int COPY_BYTES = 48 * 1024;      // private copies of the bins fit in this
constexpr int SMEM_OPTIN = 232448;         // dynamic shared memory a block may opt in to
constexpr int SMEM_BINS = SMEM_OPTIN / 4;  // widest span counted in shared memory

// The bin of v in a lane based at lo, or -1 outside [0, n_bins).
__device__ __forceinline__ int bin_of(int32_t v, int32_t lo, int n_bins) {
  const uint32_t d = static_cast<uint32_t>(v) - static_cast<uint32_t>(lo);
  return (v >= lo && d < static_cast<uint32_t>(n_bins)) ? static_cast<int>(d) : -1;
}

__device__ __forceinline__ void count(int32_t* bins, int32_t v, int32_t lo, int n_bins) {
  const int b = bin_of(v, lo, n_bins);
  if (b >= 0) atomicAdd(&bins[b], 1);
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
symbol_hist_lanes_kernel(const int32_t* __restrict__ codes, long long n,
                         const int32_t* __restrict__ lo, int n_bins, int parts, int copies,
                         int32_t* __restrict__ hist) {
  extern __shared__ int32_t smem[];
  const long long l = blockIdx.x / parts;
  const int part = static_cast<int>(blockIdx.x % parts);
  const int32_t base = lo ? lo[l] : 0;
  const int32_t* row = codes + l * n;
  int32_t* out = hist + l * n_bins;
  int32_t* bins = out;
  if (kShared) {
    for (int i = threadIdx.x; i < copies * n_bins; i += THREADS) smem[i] = 0;
    __syncthreads();
    bins = smem + ((threadIdx.x >> 5) % copies) * n_bins;
  }

  // head: elements before the row's first 16-byte boundary; then int4s;
  // then a tail of fewer than 4
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const long long head = min(n, static_cast<long long>((4 - mis) & 3));
  const long long nv = (n - head) / 4;
  const long long tail0 = head + 4 * nv;
  const int4* vec = reinterpret_cast<const int4*>(row + head);
  if (part == 0 && threadIdx.x < 8) {
    const long long i = threadIdx.x < head ? threadIdx.x : tail0 + threadIdx.x - head;
    if (threadIdx.x < head || i < n) count(bins, row[i], base, n_bins);
  }

  const long long step = static_cast<long long>(parts) * THREADS;
  for (long long j = static_cast<long long>(part) * THREADS + threadIdx.x; j < nv;
       j += UNROLL * step) {
    int4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      q[u] = j + u * step < nv ? __ldcs(vec + j + u * step) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j + u * step >= nv) break;
      count(bins, q[u].x, base, n_bins);
      count(bins, q[u].y, base, n_bins);
      count(bins, q[u].z, base, n_bins);
      count(bins, q[u].w, base, n_bins);
    }
  }

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_bins; i += THREADS) {
      int32_t s = 0;
      for (int k = 0; k < copies; ++k) s += smem[k * n_bins + i];
      if (parts == 1) out[i] = s;
      else if (s) atomicAdd(&out[i], s);
    }
  }
}

}  // namespace

// codes: [n_lanes, n] int32; lo: [n_lanes] int32 or NULL (all 0); hist:
// [n_lanes, n_bins] int32, written whole (no need to zero it).
extern "C" int symbol_hist_lanes(const void* codes, long long n_lanes, long long n, const void* lo,
                                 int n_bins, void* hist, void* stream) {
  if (n_lanes <= 0 || n <= 0 || n_bins <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const bool shared = n_bins <= SMEM_BINS;
  int copies = 1;
  while (shared && copies * 2 <= WARPS &&
         static_cast<long long>(copies) * 2 * n_bins * 4 <= COPY_BYTES)
    copies *= 2;
  const size_t smem = shared ? static_cast<size_t>(copies) * n_bins * sizeof(int32_t) : 0;
  void (*kernel)(const int32_t*, long long, const int32_t*, int, int, int, int32_t*) =
      shared ? symbol_hist_lanes_kernel<true> : symbol_hist_lanes_kernel<false>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  // the resident blocks over all lanes, at least UNROLL int4s a thread
  long long parts = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) / n_lanes;
  const long long most = n / 4 / (THREADS * UNROLL);
  if (parts > most) parts = most;
  if (parts < 1) parts = 1;
  if (n_lanes * parts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (!shared || parts > 1) {
    e = cudaMemsetAsync(hist, 0, static_cast<size_t>(n_lanes) * n_bins * sizeof(int32_t), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(n_lanes * parts), THREADS, smem, st>>>(
      static_cast<const int32_t*>(codes), n, static_cast<const int32_t*>(lo), n_bins,
      static_cast<int>(parts), copies, static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}
