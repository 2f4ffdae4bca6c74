// Chunked multi-symbol-LUT canonical-Huffman decode, for sm_90a.
//
// Replaces: src/repro/kernels/huffman_decode.py::huffman_decode_probe
// (Pallas).  Per chunk c, starting at bit offsets[c] of the big-endian u32
// word stream, until counts[c] symbols are out: take the 32-bit window at
// the bit position, probe the k-bit multi-symbol LUT (up to S complete codes
// per probe); when the first code is longer than k bits (count 0) resolve it
// by a binary search over the left-aligned canonical codewords cw_map
// (XOR 0x80000000-mapped so int32 order is unsigned order), keeping the
// reference's mid <= n-1 clamp (huffman_decode.py:58-67).  Writes alphabet
// ids [C, chunk_size] int32, zero past each chunk's count.  Bit positions
// are 64-bit: offsets come as int32 or int64, and a stream may run past
// 2^32 bits.
//
// What bounds it on the H100: bytes in principle -- the stream words read
// and 4 B of ids written per symbol (the ids are ~90% of them; a 2^27-symbol
// stream moves ~0.57 GB, ~0.17 ms at 3.35 TB/s) -- but a chunk is a serial
// chain (window -> LUT entry -> next window), so in practice the latency of
// each step of that chain, and how many chains run at once.  The first
// version (one thread per chunk, tables and stream words through __ldg,
// ids stored by each thread into its own row) paid two trips to L2 a step,
// stored 32 rows 1 KB apart per warp instruction (32 sectors where 4 do),
// and filled 8 SMs with a 1,024-chunk lane.
//
// Design.  One warp decodes 32 consecutive chunks, one lane a chunk; a
// block of W warps loads the tables into shared memory once and its warps
// then walk over groups of 32 chunks (a persistent grid of about one block
// per SM for a big stream; W and the grid shrink for a small launch so that
// a lane's 32 groups spread over 16 SMs).
//   * Tables in shared memory: the LUT packed one 64-bit entry per window
//     (count | consumed bits << 8 | S ids of B bits from bit 16, or one
//     32-bit id from bit 32 -- the host's _multi_lut layout, packed by the
//     launcher once per codec: 32 KB at k = 12); the first 12 levels of the
//     escape search as an implicit tree of the cw_map values that those
//     levels probe (node i's children 2i, 2i+1), so the search visits the
//     same indices in the same order as the plain version and reads shared
//     memory for them; order and len_sorted when the alphabet has <= 4096
//     symbols.  Deeper search levels, larger alphabets and a LUT of more
//     than 12 bits stay behind __ldg.
//   * Stream words staged: a group's chunks are one contiguous run of
//     words, copied with cp.async into the warp's 1,024-word buffer.  A
//     word outside the staged run (a chunk that overruns it, a damaged
//     offset) is read from global memory, and a word past the stream is 0,
//     so no offset can fault.  Warps on one SM overlap each other's copies,
//     which is what double buffering would buy, at half the shared memory
//     a warp.
//   * Ids out coalesced: each lane decodes 32 ids of its chunk into its
//     row of a shared [32, 41] buffer (a probe may spill up to S - 1 more,
//     carried into the next round), then the warp stores the 32 rows as
//     32 lines of 128 contiguous bytes.  Ids past a chunk's count are 0.
//   * Every probe yields at least one symbol and each round stops at the
//     chunk's count, so a damaged stream still ends.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_WARPS = 14;             // threads a block: 32 .. 448
constexpr int SEG = 32;                   // ids a lane decodes a round
constexpr int MAX_S = 8;                  // ids one probe yields at most (launcher checks)
constexpr int ROW = SEG + MAX_S + 1;      // 41: odd, so a warp's row writes miss no bank
constexpr int STAGE = 1024;               // stream words a warp stages
constexpr int LUT_SMEM_BITS = 12;         // 2^12 x 8 B = 32 KB
constexpr int TREE_LEVELS = 12;           // search levels read from shared memory
constexpr int ESC_SMEM = 4096;            // alphabets up to this keep order/len_sorted there
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const uint32_t* words;
  long long n_words;
  const void* offsets;
  int off64;
  const int32_t* counts;
  long long n_chunks;
  const unsigned long long* lut;
  int k, B, id_base;
  const int32_t* cw_map;
  const int32_t* order;
  const int32_t* len_sorted;
  int n, search_iters, levels;
  int lut_smem, esc_smem;
  int chunk_size;
  int32_t* out;
};

__device__ __forceinline__ long long offset_at(const void* offsets, int off64, long long c) {
  return off64 ? __ldg(static_cast<const long long*>(offsets) + c)
               : static_cast<long long>(__ldg(static_cast<const int32_t*>(offsets) + c));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// stream word wi: from the warp's staged run when it holds it, else from
// global memory, 0 past the stream
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ words,
                                            unsigned long long n_words, const uint32_t* stage,
                                            unsigned long long ws, int staged,
                                            unsigned long long wi) {
  const unsigned long long rel = wi - ws;
  if (rel < static_cast<unsigned long long>(staged)) return stage[rel];
  return wi < n_words ? __ldg(words + wi) : 0u;
}

__global__ void __launch_bounds__(MAX_WARPS * WARP)
huffman_decode_probe_kernel(const Params p) {
  extern __shared__ unsigned long long smem64[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem64);
  const int warps = blockDim.x / WARP;
  unsigned long long* lut_s = reinterpret_cast<unsigned long long*>(base);
  size_t off = p.lut_smem ? (size_t{8} << p.k) : 0;
  int32_t* tree_s = reinterpret_cast<int32_t*>(base + off);
  off += size_t{4} << p.levels;
  int32_t* order_s = reinterpret_cast<int32_t*>(base + off);
  off += p.esc_smem ? size_t{4} * p.n : 0;
  int32_t* len_s = reinterpret_cast<int32_t*>(base + off);
  off += p.esc_smem ? size_t{4} * p.n : 0;
  uint32_t* warp_mem = reinterpret_cast<uint32_t*>(base + off);

  const int tid = threadIdx.x;
  // the tables: asynchronous copies, so a thread's loads do not wait on one
  // another (the LUT in 16-byte pieces: 2^k >= 2 entries of 8 bytes)
  if (p.lut_smem)
    for (int i = tid; i < (1 << p.k) / 2; i += blockDim.x)
      cp_async16(lut_s + 2 * i, p.lut + 2 * i);
  if (p.esc_smem)
    for (int i = tid; i < p.n; i += blockDim.x) {
      cp_async4(order_s + i, p.order + i);
      cp_async4(len_s + i, p.len_sorted + i);
    }
  asm volatile("cp.async.commit_group;\n" ::);
  // node i of the search tree: the cw_map entry that the (depth i) probe
  // reaches after the go/stay decisions spelt by i's bits below its top bit
  for (int i = tid + 1; i < (1 << p.levels); i += blockDim.x) {
    int low = 0, high = p.n;
    for (int d = 30 - __clz(i); d >= 0; --d) {
      const int mid = min((low + high) >> 1, p.n - 1);
      if ((i >> d) & 1) low = mid + 1; else high = mid;
    }
    tree_s[i] = __ldg(p.cw_map + min((low + high) >> 1, p.n - 1));
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int warp = tid / WARP, lane = tid % WARP;
  uint32_t* stage = warp_mem + static_cast<size_t>(warp) * (STAGE + WARP * ROW);
  int32_t* rows = reinterpret_cast<int32_t*>(stage + STAGE);
  int32_t* row = rows + lane * ROW;
  const unsigned long long* lut = p.lut_smem ? lut_s : p.lut;
  const int32_t* ord = p.esc_smem ? order_s : p.order;
  const int32_t* lens = p.esc_smem ? len_s : p.len_sorted;
  const unsigned long long id_mask = (1ull << p.B) - 1;
  const int cs = p.chunk_size;
  const long long n_groups = (p.n_chunks + WARP - 1) / WARP;

  for (long long g = static_cast<long long>(blockIdx.x) * warps + warp; g < n_groups;
       g += static_cast<long long>(gridDim.x) * warps) {
    const long long c0 = g * WARP;
    const long long c = c0 + lane;
    const bool live = c < p.n_chunks;

    // stage the words from the group's first chunk to the next group's start
    const long long ws = offset_at(p.offsets, p.off64, c0) >> 5;
    long long end = c0 + WARP < p.n_chunks
                        ? (offset_at(p.offsets, p.off64, c0 + WARP) >> 5) + 2
                        : p.n_words;
    end = min(end, p.n_words);
    const int staged = ws < 0 ? 0 : static_cast<int>(max(0ll, min(end - ws,
                                                                   static_cast<long long>(STAGE))));
    for (int i = lane; i < staged; i += WARP) cp_async4(stage + i, p.words + ws + i);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();

    const int count = live ? min(max(__ldg(p.counts + c), 0), cs) : 0;
    unsigned long long pos =
        live ? static_cast<unsigned long long>(offset_at(p.offsets, p.off64, c)) : 0;
    const unsigned long long wsu = static_cast<unsigned long long>(ws);
    const unsigned long long nw = static_cast<unsigned long long>(p.n_words);

    int cur = 0, fill = 0;
    for (int seg = 0; seg < cs; seg += SEG) {
      while (fill < SEG && cur < count) {
        const unsigned long long wi = pos >> 5;
        const uint32_t sh = static_cast<uint32_t>(pos & 31u);
        const uint32_t w = __funnelshift_l(word_at(p.words, nw, stage, wsu, staged, wi + 1),
                                           word_at(p.words, nw, stage, wsu, staged, wi), sh);
        const uint32_t idx = w >> (32 - p.k);
        const unsigned long long e = lut[idx];
        const int cnt = static_cast<int>(e & 0xFFu);
        if (cnt == 0) {
          const int32_t wm = static_cast<int32_t>(w ^ 0x80000000u);
          int low = 0, high = p.n;
          unsigned node = 1;
          for (int it = 0; it < p.search_iters; ++it) {
            const int mid = min((low + high) >> 1, p.n - 1);
            const int32_t v = it < p.levels ? tree_s[node] : __ldg(p.cw_map + mid);
            const bool go = v <= wm;
            low = go ? mid + 1 : low;
            high = go ? high : mid;
            node = 2 * node + (go ? 1u : 0u);
          }
          const int ei = max(low - 1, 0);
          row[fill++] = ord[ei];
          pos += static_cast<unsigned long long>(static_cast<uint32_t>(lens[ei]));
          cur += 1;
        } else {
          const int take = min(cnt, count - cur);
          for (int j = 0; j < take; ++j)
            row[fill + j] = static_cast<int32_t>((e >> (p.id_base + j * p.B)) & id_mask);
          fill += take;
          cur += take;
          pos += (e >> 8) & 0xFFu;
        }
      }
      __syncwarp();
      const int width = min(SEG, cs - seg);
      const int n_rows = static_cast<int>(min(static_cast<long long>(WARP), p.n_chunks - c0));
#pragma unroll 8
      for (int r = 0; r < WARP; ++r) {
        const int f = __shfl_sync(FULL, fill, r);
        if (r < n_rows && lane < width)
          p.out[(c0 + r) * cs + seg + lane] = lane < f ? rows[r * ROW + lane] : 0;
      }
      __syncwarp();
      const int left = fill - width;  // ids a probe spilled past this round
      for (int j = 0; j < left; ++j) row[j] = row[width + j];
      fill = max(left, 0);
    }
    __syncwarp();
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

}  // namespace

extern "C" int huffman_decode_probe(const void* words, long long n_words, const void* offsets,
                                    int off64, const void* counts, long long n_chunks,
                                    const void* lut, int k, int B, int id_base,
                                    const void* cw_map, const void* order,
                                    const void* len_sorted, int n, int chunk_size, void* out,
                                    void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > 32 || B < 1 || B > 32 || n < 1 || chunk_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.words = static_cast<const uint32_t*>(words);
  p.n_words = n_words;
  p.offsets = offsets;
  p.off64 = off64;
  p.counts = static_cast<const int32_t*>(counts);
  p.n_chunks = n_chunks;
  p.lut = static_cast<const unsigned long long*>(lut);
  p.k = k;
  p.B = B;
  p.id_base = id_base;
  p.cw_map = static_cast<const int32_t*>(cw_map);
  p.order = static_cast<const int32_t*>(order);
  p.len_sorted = static_cast<const int32_t*>(len_sorted);
  p.n = n;
  int iters = 0;
  for (int m = n; m > 0; m >>= 1) ++iters;  // n.bit_length()
  p.search_iters = iters < 1 ? 1 : iters;
  p.levels = p.search_iters < TREE_LEVELS ? p.search_iters : TREE_LEVELS;
  p.lut_smem = k <= LUT_SMEM_BITS;
  p.esc_smem = n <= ESC_SMEM;
  p.chunk_size = chunk_size;
  p.out = static_cast<int32_t*>(out);

  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long n_groups = (n_chunks + WARP - 1) / WARP;
  long long w = (n_groups + sms - 1) / sms;
  const int warps = static_cast<int>(w < 2 ? 2 : (w > MAX_WARPS ? MAX_WARPS : w));
  const size_t smem = (p.lut_smem ? (size_t{8} << k) : 0) + (size_t{4} << p.levels) +
                      (p.esc_smem ? size_t{8} * n : 0) +
                      static_cast<size_t>(warps) * 4 * (STAGE + WARP * ROW);
  cudaError_t e = cudaFuncSetAttribute(huffman_decode_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, huffman_decode_probe_kernel, warps * WARP, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  long long blocks = (n_groups + warps - 1) / warps;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  huffman_decode_probe_kernel<<<static_cast<unsigned>(blocks), warps * WARP, smem,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
