// Chunked multi-symbol-LUT canonical-Huffman decode, for sm_90a.
//
// Replaces: src/repro/kernels/huffman_decode.py::huffman_decode_probe
// (Pallas).  Per chunk c, starting at bit offsets[c] of the big-endian u32
// word stream, until counts[c] symbols are out: take the 32-bit window at
// the bit position, probe the k-bit multi-symbol LUT (lut_count / lut_bits
// / lut_ids: up to S complete codes per probe); when the first code is
// longer than k bits (count 0) resolve it by a binary search over the
// left-aligned canonical codewords cw_map (XOR 0x80000000-mapped so int32
// order is unsigned order), keeping the reference's mid <= n-1 clamp
// (huffman_decode.py:58-67).  Writes alphabet ids [C, chunk_size] int32,
// zero past each chunk's count.  Tables: HuffmanCodec._device_tables.
//
// What bounds it on the H100: bytes in principle -- the stream words, the
// tables and 4 B of ids per symbol (about 1.1 MiB for a 64^3 lane, ~0.35 us
// at 3.35 TB/s) -- but in practice latency: each chunk's probes form a
// dependent chain of global loads (window -> LUT -> next window).
//
// Design: the TPU kernel moved all lanes in lockstep under a fori_loop and
// placed ids with one-hot adds.  Chunks are independent, so here one thread
// owns one chunk and loops until its count is met (no lockstep, no
// masking); the window is one funnel shift of two words; tables are read
// through __ldg (the read-only path; a shared-memory copy of the tables is
// later work).  Reads past the stream clamp to zero words, so a damaged
// stream cannot fault; the loop yields >= 1 symbol per probe, so it ends.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
huffman_decode_probe_kernel(const uint32_t* __restrict__ words, long long n_words,
                            const int32_t* __restrict__ offsets,
                            const int32_t* __restrict__ counts, long long n_chunks,
                            const int32_t* __restrict__ lut_count,
                            const int32_t* __restrict__ lut_bits,
                            const int32_t* __restrict__ lut_ids, int S, int k,
                            const int32_t* __restrict__ cw_map,
                            const int32_t* __restrict__ order,
                            const int32_t* __restrict__ len_sorted, int n, int search_iters,
                            int chunk_size, int32_t* __restrict__ out) {
  const long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= n_chunks) return;
  int32_t* o = out + c * chunk_size;
  const int count = min(max(__ldg(counts + c), 0), chunk_size);
  const size_t lut_size = size_t{1} << k;
  uint32_t pos = static_cast<uint32_t>(__ldg(offsets + c));
  int cur = 0;
  while (cur < count) {
    const uint32_t wi = pos >> 5, sh = pos & 31u;
    const uint32_t hi = wi < n_words ? __ldg(words + wi) : 0u;
    const uint32_t nx = wi + 1 < n_words ? __ldg(words + wi + 1) : 0u;
    const uint32_t w = __funnelshift_l(nx, hi, sh);  // top 32 bits of (hi:nx) << sh
    const uint32_t idx = w >> (32 - k);
    const int cnt = __ldg(lut_count + idx);
    if (cnt == 0) {
      const int32_t wm = static_cast<int32_t>(w ^ 0x80000000u);
      int low = 0, high = n;
      for (int it = 0; it < search_iters; ++it) {
        const int mid = min((low + high) >> 1, n - 1);
        const bool go = __ldg(cw_map + mid) <= wm;
        low = go ? mid + 1 : low;
        high = go ? high : mid;
      }
      const int e = max(low - 1, 0);
      o[cur] = __ldg(order + e);
      pos += static_cast<uint32_t>(__ldg(len_sorted + e));
      cur += 1;
    } else {
      const int take = min(cnt, count - cur);
      for (int j = 0; j < take; ++j) o[cur + j] = __ldg(lut_ids + j * lut_size + idx);
      pos += static_cast<uint32_t>(__ldg(lut_bits + idx));
      cur += take;
    }
  }
  for (int j = count; j < chunk_size; ++j) o[j] = 0;
}

}  // namespace

extern "C" int huffman_decode_probe(const void* words, long long n_words, const void* offsets,
                                    const void* counts, long long n_chunks, const void* lut_count,
                                    const void* lut_bits, const void* lut_ids, int S, int k,
                                    const void* cw_map, const void* order,
                                    const void* len_sorted, int n, int chunk_size, void* out,
                                    void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  int search_iters = 0;
  for (int m = n; m > 0; m >>= 1) ++search_iters;  // n.bit_length()
  if (search_iters < 1) search_iters = 1;
  const long long blocks = (n_chunks + THREADS - 1) / THREADS;
  huffman_decode_probe_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(counts), n_chunks, static_cast<const int32_t*>(lut_count),
      static_cast<const int32_t*>(lut_bits), static_cast<const int32_t*>(lut_ids), S, k,
      static_cast<const int32_t*>(cw_map), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(len_sorted), n, search_iters, chunk_size,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
