// Boundary pass of a legacy (hf/hz) canonical-Huffman stream, for sm_90a.
//
// Replaces: no Pallas kernel.  The reference reads the legacy tags with a
// host bit walk, src/repro/sz/entropy.py::HuffmanCodec.decode_bitwalk
// (:467-492).  A legacy stream is one MSB-first run of codes with no chunk
// table, so its symbols cannot be decoded in parallel until each chunk's
// start bit is known.  This pass finds them: out[c] = the bit position of
// symbol c * chunk_size for every chunk c, and out[C] = the position after
// the last symbol (the host checks it against the stream's bit count).  The
// chunked decode kernel (huffman_decode.cu) then decodes all chunks in
// parallel from those offsets, so a legacy stream decodes to the same ids
// as a chunked one.
//
// What bounds it on the H100: in bytes, next to nothing (the stream's words
// read once, 8 B written per chunk).  Finding a boundary is a serial chain
// (each code's end is the next one's start), so the work is in breaking
// that chain.  A first form walked the stream in one thread with the packed
// multi-symbol LUT: 7.70 ms for a 64^3 lane of 262,144 symbols and 62.2 ms
// for a 2^21-symbol stream, slower than the plain version's pointer doubling
// on the same card (2.32 and 36.5 ms; chip_smoke.py, NVIDIA H100 80GB HBM3
// at 700 W), since one GPU thread spends ~150 ns on each dependent probe.
//
// Design: pointer doubling, every step over all P bit positions of the
// padded words (P = n_words * 32, a sink at P):
//   1. next[p] = min(p + length of the code starting at bit p, P), one
//      thread a position; the length from the binary search over the
//      left-aligned canonical codewords (the chunked decode's escape
//      search, mid <= n-1 clamp; cw_map and len_sorted in shared memory for
//      alphabets of up to 4,096 symbols);
//   2. J = next^chunk_size by repeated squaring (chunk_size a power of two:
//      log2 passes of out[p] = a[a[p]]), then J16 = J^16 by four more;
//   3. one thread walks J16 from bit 0, writing the start of every 16th
//      chunk (C / 16 dependent loads, J16 held in L2);
//   4. one thread a group of 16 chunks walks J from its start (15 loads);
//   5. one thread walks next from the last chunk's start for its symbols:
//      the end position.
// Positions are int32 when P < 2^31, int64 past it.  The wrapper allocates
// the four P + 1 position arrays and the group starts; every launch is on
// the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ESC_SMEM = 4096;  // alphabets up to this keep cw_map/len_sorted in shared memory
constexpr int GROUP = 16;       // chunks a group: J16 = J^GROUP

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ words,
                                            unsigned long long n_words,
                                            unsigned long long wi) {
  return wi < n_words ? __ldg(words + wi) : 0u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
next_kernel(const uint32_t* __restrict__ words, long long n_words, long long P,
            const int32_t* __restrict__ cw_map, const int32_t* __restrict__ len_sorted, int n,
            int search_iters, int esc_smem, T* __restrict__ next) {
  extern __shared__ int32_t smem32[];
  int32_t* cw_s = smem32;
  int32_t* len_s = smem32 + (esc_smem ? n : 0);
  if (esc_smem)
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      cw_s[i] = __ldg(cw_map + i);
      len_s[i] = __ldg(len_sorted + i);
    }
  __syncthreads();
  const int32_t* cw = esc_smem ? cw_s : cw_map;
  const int32_t* lens = esc_smem ? len_s : len_sorted;
  const unsigned long long nw = static_cast<unsigned long long>(n_words);
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p <= P;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (p == P) {
      next[p] = static_cast<T>(P);
      continue;
    }
    const unsigned long long wi = static_cast<unsigned long long>(p) >> 5;
    const uint32_t w = __funnelshift_l(word_at(words, nw, wi + 1), word_at(words, nw, wi),
                                       static_cast<uint32_t>(p & 31));
    const int32_t wm = static_cast<int32_t>(w ^ 0x80000000u);
    int low = 0, high = n;
    for (int it = 0; it < search_iters; ++it) {
      const int mid = min((low + high) >> 1, n - 1);
      const bool go = cw[mid] <= wm;
      low = go ? mid + 1 : low;
      high = go ? high : mid;
    }
    const long long to = p + static_cast<uint32_t>(lens[max(low - 1, 0)]);
    next[p] = static_cast<T>(to < P ? to : P);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
square_kernel(const T* __restrict__ a, T* __restrict__ out, long long m) {
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < m;
       p += static_cast<long long>(gridDim.x) * blockDim.x)
    out[p] = a[a[p]];
}

template <typename T>
__global__ void group_walk_kernel(const T* __restrict__ j16, long long groups,
                                  long long* __restrict__ starts) {
  long long s = 0;
  starts[0] = 0;
  for (long long g = 1; g < groups; ++g) {
    s = static_cast<long long>(j16[s]);
    starts[g] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fill_kernel(const T* __restrict__ j, const long long* __restrict__ starts, long long groups,
            long long chunks, long long* __restrict__ out) {
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long s = starts[g];
    const long long c0 = g * GROUP;
    for (int i = 0; i < GROUP && c0 + i < chunks; ++i) {
      out[c0 + i] = s;
      s = static_cast<long long>(j[s]);
    }
  }
}

template <typename T>
__global__ void end_kernel(const T* __restrict__ next, long long chunks, long long steps,
                           long long* __restrict__ out) {
  long long s = out[chunks - 1];
  for (long long i = 0; i < steps; ++i) s = static_cast<long long>(next[s]);
  out[chunks] = s;
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

unsigned grid_for(long long m, int sms) {
  long long b = (m + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * 16;
  if (b > cap) b = cap;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

template <typename T>
int run(const uint32_t* words, long long n_words, long long n_symbols, int log2_cs,
        const int32_t* cw_map, const int32_t* len_sorted, int n, void* work, long long* out,
        cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long P = n_words * 32;
  const long long m = P + 1;
  T* next = static_cast<T*>(work);
  T* j = next + m;
  T* t1 = j + m;
  T* t2 = t1 + m;
  long long* starts = reinterpret_cast<long long*>(t2 + m);
  int iters = 0;
  for (int v = n; v > 0; v >>= 1) ++iters;  // n.bit_length()
  const int esc_smem = n <= ESC_SMEM;
  const size_t smem = esc_smem ? size_t{8} * n : 0;
  const unsigned grid = grid_for(m, sms);
  next_kernel<T><<<grid, THREADS, smem, stream>>>(words, n_words, P, cw_map, len_sorted, n,
                                                  iters < 1 ? 1 : iters, esc_smem, next);
  // J = next^(2^log2_cs): ping-pong between j and t1, ending in j
  const T* src = next;
  for (int i = 0; i < log2_cs; ++i) {
    T* dst = ((log2_cs - i) % 2 == 1) ? j : t1;
    square_kernel<T><<<grid, THREADS, 0, stream>>>(src, dst, m);
    src = dst;
  }
  if (log2_cs == 0) {
    cudaError_t e = cudaMemcpyAsync(j, next, sizeof(T) * m, cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // J16 = J^16: four squarings, t1 -> t2 -> t1 -> t2
  square_kernel<T><<<grid, THREADS, 0, stream>>>(j, t1, m);
  square_kernel<T><<<grid, THREADS, 0, stream>>>(t1, t2, m);
  square_kernel<T><<<grid, THREADS, 0, stream>>>(t2, t1, m);
  square_kernel<T><<<grid, THREADS, 0, stream>>>(t1, t2, m);
  const long long cs = 1ll << log2_cs;
  const long long chunks = (n_symbols + cs - 1) / cs;
  const long long groups = (chunks + GROUP - 1) / GROUP;
  group_walk_kernel<T><<<1, 1, 0, stream>>>(t2, groups, starts);
  fill_kernel<T><<<grid_for(groups, sms), THREADS, 0, stream>>>(j, starts, groups, chunks, out);
  end_kernel<T><<<1, 1, 0, stream>>>(next, chunks, n_symbols - (chunks - 1) * cs, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the workspace huffman_legacy_bounds needs: four arrays of
// n_words * 32 + 1 positions (int32 below 2^31 positions, else int64) and
// one int64 start per group of 16 chunks.
extern "C" long long huffman_legacy_workspace(long long n_words, long long n_symbols,
                                              long long chunk_size) {
  const long long m = n_words * 32 + 1;
  const long long item = m < (1ll << 31) ? 4 : 8;
  const long long chunks = (n_symbols + chunk_size - 1) / chunk_size;
  const long long groups = (chunks + GROUP - 1) / GROUP;
  return ((4 * m * item + 7) / 8) * 8 + 8 * (groups < 1 ? 1 : groups);
}

extern "C" int huffman_legacy_bounds(const void* words, long long n_words, long long n_symbols,
                                     long long chunk_size, const void* cw_map,
                                     const void* len_sorted, int n, void* work, void* out,
                                     void* stream) {
  if (n_symbols <= 0) return static_cast<int>(cudaGetLastError());
  int log2_cs = 0;
  while ((1ll << log2_cs) < chunk_size) ++log2_cs;
  if (n < 1 || n_words < 1 || chunk_size < 1 || (1ll << log2_cs) != chunk_size)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = n_words * 32 + 1;
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* cw = static_cast<const int32_t*>(cw_map);
  const auto* ls = static_cast<const int32_t*>(len_sorted);
  auto* o = static_cast<long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (m < (1ll << 31)) return run<int32_t>(w, n_words, n_symbols, log2_cs, cw, ls, n, work, o, st);
  return run<long long>(w, n_words, n_symbols, log2_cs, cw, ls, n, work, o, st);
}
