// Chunk-parallel canonical-Huffman encode pack, for sm_90a.
//
// Replaces: src/repro/kernels/huffman_encode.py::huffman_encode_pack
// (Pallas).  Input: per chunk of cs symbols, code lengths (1..32; 0 marks a
// pad slot of a short last chunk) and canonical codewords, [C, cs] int32.
// Output: words [C, cs] -- the chunk's bit stream MSB-first across
// big-endian u32 words, zero past its last bit -- and chunk_bits [C], the
// chunk's total bit count.  The host splices the chunks into the continuous
// hc/hZ stream (sz/entropy.py::_splice_chunks).  The tiled encode packs
// every lane's chunks in one launch (sz/entropy.py::encode_codes_lanes).
//
// What bounds it on the H100: bytes -- 8 B read and 4 B written per
// symbol: the 512 lanes of a 512^3 field (524,288 chunks of 256) are
// 1.5 GiB, 0.48 ms at 3.35 TB/s.
//
// Design: the TPU kernel ran a Hillis-Steele scan and accumulated a
// [BB, CS, CS] one-hot to place the words (adding disjoint bits = OR).  Here
// a launch takes one of two forms, chosen by cs:
// * cs <= WARP_MAX_CS (1,024): a warp a chunk, WARPS chunks a block, no
//   __syncthreads.  The chunk is walked in strips of 256 symbols; in a strip
//   each lane owns 8 consecutive symbols (two int4 loads each of lengths and
//   codes when cs % 4 == 0 and the rows are 16-byte aligned, else scalar
//   loads with pad slots past cs), sums their lengths serially, and one
//   5-step shuffle scan gives its first bit; a running carry joins strips.
//   The lane ORs its codewords into a register word and flushes it with one
//   shared atomicOr each time its bits cross into the next word, into the
//   warp's zeroed slab of cs words; the slab leaves as coalesced int4 stores
//   (zeros included).
// * cs > WARP_MAX_CS (up to MAX_CHUNK, 12,288): a block of 256 threads a
//   chunk, the chunk's words in shared memory, strips of 256 symbols scanned
//   by warp shuffles plus a scan of the 8 warp totals.
// All arithmetic is uint32_t, and no shift reaches 32 (len in [1, 32] ->
// shift in [0, 31]; the spill is computed only for sh > 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARP_MAX_CS = 1024;  // kernels/huffman_encode.py::WARP_MAX_CS
constexpr int WARPS = 8;       // chunks a block in the warp form
constexpr int PER_LANE = 8;    // symbols a lane owns in a strip
constexpr int STRIP = 32 * PER_LANE;
constexpr int THREADS = 256;   // the block form
constexpr int BLOCK_WARPS = THREADS / 32;

template <bool kVec>
__global__ void __launch_bounds__(WARPS * 32)
huffman_encode_warp_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ codes,
                           long long n_chunks, int cs, int32_t* __restrict__ words,
                           int32_t* __restrict__ chunk_bits) {
  extern __shared__ uint4 slabs[];  // WARPS slabs of cs_pad words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (c >= n_chunks) return;  // the whole warp
  const int cs_pad = (cs + 3) & ~3;
  uint32_t* slab = reinterpret_cast<uint32_t*>(slabs) + warp * cs_pad;
  for (int i = 4 * lane; i < cs_pad; i += 128)
    *reinterpret_cast<uint4*>(slab + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();

  const int32_t* L = lens + c * cs;
  const int32_t* K = codes + c * cs;
  uint32_t carry = 0;  // bits of the strips before this one
  for (int strip = 0; strip < cs; strip += STRIP) {
    const int first = strip + lane * PER_LANE;
    uint32_t ln[PER_LANE], cw[PER_LANE];
    if (kVec && first + PER_LANE <= cs) {
      const int4 a = *reinterpret_cast<const int4*>(L + first);
      const int4 b = *reinterpret_cast<const int4*>(L + first + 4);
      const int4 p = *reinterpret_cast<const int4*>(K + first);
      const int4 q = *reinterpret_cast<const int4*>(K + first + 4);
      ln[0] = a.x; ln[1] = a.y; ln[2] = a.z; ln[3] = a.w;
      ln[4] = b.x; ln[5] = b.y; ln[6] = b.z; ln[7] = b.w;
      cw[0] = p.x; cw[1] = p.y; cw[2] = p.z; cw[3] = p.w;
      cw[4] = q.x; cw[5] = q.y; cw[6] = q.z; cw[7] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const bool in = first + k < cs;
        ln[k] = in ? static_cast<uint32_t>(L[first + k]) : 0u;
        cw[k] = in ? static_cast<uint32_t>(K[first + k]) : 0u;
      }
    }
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) sum += ln[k];
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    uint32_t pos = carry + incl - sum;
    uint32_t cur = pos >> 5, acc = 0u;  // the word being assembled, its bits
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const uint32_t len = ln[k];
      if (len == 0u) continue;
      const uint32_t aligned = cw[k] << (32u - len);
      const uint32_t w0 = pos >> 5, sh = pos & 31u;
      if (w0 != cur) {
        if (acc) atomicOr(&slab[cur], acc);
        cur = w0;
        acc = 0u;
      }
      acc |= aligned >> sh;
      if (sh + len > 32u) {  // spills into the next word (so sh > 0)
        atomicOr(&slab[cur], acc);
        cur = w0 + 1;
        acc = aligned << (32u - sh);
      }
      pos += len;
    }
    if (acc) atomicOr(&slab[cur], acc);
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();

  int32_t* W = words + c * cs;
  if (kVec) {
    for (int i = 4 * lane; i < cs; i += 128)
      *reinterpret_cast<uint4*>(W + i) = *reinterpret_cast<const uint4*>(slab + i);
  } else {
    for (int i = lane; i < cs; i += 32) W[i] = static_cast<int32_t>(slab[i]);
  }
  if (lane == 0) chunk_bits[c] = static_cast<int32_t>(carry);
}

__global__ void __launch_bounds__(THREADS)
huffman_encode_block_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ codes,
                            int cs, int32_t* __restrict__ words,
                            int32_t* __restrict__ chunk_bits) {
  extern __shared__ uint32_t sw[];  // cs words of this chunk
  __shared__ uint32_t warp_tot[BLOCK_WARPS];
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
    for (int w = 0; w < BLOCK_WARPS; ++w) {
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
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const int32_t*>(lens);
  const auto* kp = static_cast<const int32_t*>(codes);
  auto* wp = static_cast<int32_t*>(words);
  auto* bp = static_cast<int32_t*>(chunk_bits);
  if (cs <= WARP_MAX_CS) {
    const size_t smem = static_cast<size_t>(WARPS) * ((cs + 3) & ~3) * sizeof(uint32_t);
    const long long blocks = (n_chunks + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = cs % 4 == 0 && reinterpret_cast<uintptr_t>(lens) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    if (vec)
      huffman_encode_warp_kernel<true><<<static_cast<unsigned>(blocks), WARPS * 32, smem, st>>>(
          lp, kp, n_chunks, cs, wp, bp);
    else
      huffman_encode_warp_kernel<false><<<static_cast<unsigned>(blocks), WARPS * 32, smem, st>>>(
          lp, kp, n_chunks, cs, wp, bp);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(cs) * sizeof(uint32_t);
  // a block past 48 KB of shared memory in all (warp_tot is static) must opt in
  if (smem + BLOCK_WARPS * sizeof(uint32_t) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        huffman_encode_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  huffman_encode_block_kernel<<<static_cast<unsigned>(n_chunks), THREADS, smem, st>>>(
      lp, kp, cs, wp, bp);
  return static_cast<int>(cudaGetLastError());
}
