// Chunk-parallel canonical-Huffman encode pack, for sm_90a.
//
// Replaces: src/repro/kernels/huffman_encode.py::huffman_encode_pack
// (Pallas).  Input: per chunk of cs symbols, code lengths (1..32; 0 marks a
// pad slot of a short last chunk) and canonical codewords, [C, cs] int32.
// Output: words [C, cs] -- the chunk's bit stream MSB-first across
// big-endian u32 words, zero past its last bit -- and chunk_bits [C], the
// chunk's total bit count.  The host splices the chunks into the continuous
// hc/hZ stream (sz/entropy.py::_splice_chunks).
//
// What bounds it on the H100: bytes -- 8 B read and 4 B written per
// symbol, 3 MiB for a 64^3 lane (1024 chunks of 256), 0.94 us at
// 3.35 TB/s.  A launch costs more than that; the scan's barriers and the
// shared-memory atomics are the kernel's own cost.
//
// Design: the TPU kernel ran a Hillis-Steele scan and accumulated a
// [BB, CS, CS] one-hot to place the words (adding disjoint bits = OR).  Here
// one block of 256 threads owns one chunk: a warp-shuffle inclusive scan of
// the lengths plus a scan of the 8 warp totals gives each symbol its start
// bit; each thread left-aligns its codeword and atomicOr's it into the <= 2
// shared-memory words it straddles; then the block writes all cs words and
// the total.  Chunks longer than 256 symbols are walked in strips of 256
// with a running bit carry.  All arithmetic is uint32_t, and no shift
// reaches 32 (len in [1, 32] -> shift in [0, 31]; the spill is computed
// only for sh > 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
huffman_encode_pack_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ codes,
                           int cs, int32_t* __restrict__ words, int32_t* __restrict__ chunk_bits) {
  extern __shared__ uint32_t sw[];  // cs words of this chunk
  __shared__ uint32_t warp_tot[WARPS];
  const size_t c = blockIdx.x;
  const int32_t* L = lens + c * cs;
  const int32_t* K = codes + c * cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < cs; i += THREADS) sw[i] = 0u;
  __syncthreads();

  uint32_t carry = 0;  // bits of the strips before this one
  for (int base = 0; base < cs; base += THREADS) {
    const int i = base + threadIdx.x;
    const uint32_t len = i < cs ? static_cast<uint32_t>(L[i]) : 0u;
    const uint32_t code = i < cs ? static_cast<uint32_t>(K[i]) : 0u;
    uint32_t incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    uint32_t warp_off = 0, strip_bits = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t t = warp_tot[w];
      warp_off += w < warp ? t : 0u;
      strip_bits += t;
    }
    if (len > 0) {
      const uint32_t start = carry + warp_off + incl - len;
      const uint32_t aligned = code << (32u - len);
      const uint32_t w0 = start >> 5, sh = start & 31u;
      atomicOr(&sw[w0], aligned >> sh);
      if (sh > 0u) {
        const uint32_t spill = aligned << (32u - sh);
        if (spill != 0u && w0 + 1 < static_cast<uint32_t>(cs)) atomicOr(&sw[w0 + 1], spill);
      }
    }
    carry += strip_bits;
    __syncthreads();  // warp_tot is rewritten by the next strip
  }

  int32_t* W = words + c * cs;
  for (int i = threadIdx.x; i < cs; i += THREADS) W[i] = static_cast<int32_t>(sw[i]);
  if (threadIdx.x == 0) chunk_bits[c] = static_cast<int32_t>(carry);
}

}  // namespace

extern "C" int huffman_encode_pack(const void* lens, const void* codes, long long n_chunks,
                                   int cs, void* words, void* chunk_bits, void* stream) {
  if (n_chunks <= 0 || cs <= 0) return static_cast<int>(cudaGetLastError());
  huffman_encode_pack_kernel<<<static_cast<unsigned>(n_chunks), THREADS,
                               static_cast<size_t>(cs) * sizeof(uint32_t),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(codes), cs,
      static_cast<int32_t*>(words), static_cast<int32_t*>(chunk_bits));
  return static_cast<int>(cudaGetLastError());
}
