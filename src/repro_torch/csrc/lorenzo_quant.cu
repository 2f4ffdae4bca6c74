// Fused prequantize + 3-axis Lorenzo difference, for sm_90a: one kernel
// for a batch of tiles and for a whole volume.
//
// Replaces: src/repro/kernels/lorenzo_quant.py::lorenzo_quant_tiles and
// ::lorenzo_quant (Pallas).  Both compute, for a volume (or each tile of a
// batch) [Z, Y, X] float32:
//   q = rint(x / two_eb)                     (IEEE division, half to even)
//   d = q - q[z-1] - q[y-1] - q[x-1] + q[z-1,y-1] + q[z-1,x-1] + q[y-1,x-1]
//         - q[z-1,y-1,x-1]                   (zero outside the domain)
// which is the three first differences of the oracle
// (repro/kernels/ref.py::lorenzo_quant_ref) in int32, wrapping mod 2^32.
// The Pallas kernels difference in float32 and part from the oracle above
// |q| = 2^24; this kernel follows the oracle.  Volumes of rank 1 or 2 come
// in as [1, 1, X] / [1, Y, X] and a whole volume as a batch of one: a
// difference along a size-1 axis is the identity, so one kernel serves
// every rank up to 3, tiled or not.
//
// What bounds it on the H100: bytes.  Each element is read once (4 B) and
// written once (4 B); 2^27 values move 1.07 GB, 0.32 ms at 3.35 TB/s.  The
// division is ~10 instructions, below the card's arithmetic rate.  So the
// design keeps many loads in flight and no thread waiting on another.
//
// Design.  The TPU kernels carry the previous z-plane in VMEM across
// sequential grid steps.  Blocks on the GPU run in no order, so each warp
// owns a window of WY rows by 32 x VEC cells of one domain and marches a
// segment of SEG_Z planes down z itself:
//   * a lane owns VEC consecutive x-cells of each row, loaded as one float4
//     (float2, float) and stored as one int4 (int2, int), streaming;
//   * per plane the warp first issues the loads of all WY rows plus the
//     halo row y0-1 (WY+1 independent loads a lane in flight), then
//     quantizes row after row: h = q - q[x-1], with q[x-1] from the lane
//     below by __shfl_up_sync (lane 0 takes the cell x0-1 from its own
//     scalar load, or 0 at the row's start), and p = h - h[y-1] with h[y-1]
//     carried in registers from the row above;
//   * p of the plane before stays in registers (WY x VEC a lane), so the
//     output is p - p_prev; a segment's first p_prev is the 2-D difference
//     of the plane before it (zero at the domain's face), which re-reads
//     1/SEG_Z of the input;
//   * no shared memory and no block barrier: a warp never waits for
//     another.  The halo row re-reads 1/WY of the input, mostly from L2
//     (the warp of the window above loads it at about the same time).
// What limits it is loads in flight: unrolled, the divisions and loads
// take ~100 registers a thread, so the register cap (MIN_BLOCKS) trades
// loads in flight a warp for warps an SM; short windows with more warps
// were the fastest timed, the halo's extra L2 reads and divisions
// notwithstanding.  Rows whose cells are not 8- or 16-byte aligned (X odd,
// or a tile batch such as 5x13x37) take VEC = 1; X = 64 (the 64^3 tiles)
// runs VEC = 2, one warp a row; X >= 128 runs VEC = 4.  The arithmetic is
// uint32_t, because signed overflow is undefined in C++ and the reference
// wraps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;   // warps a block
constexpr int SEG_Z = 32;  // planes a warp marches
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t quant(float v, float two_eb) {
  return static_cast<uint32_t>(static_cast<int32_t>(rintf(__fdiv_rn(v, two_eb))));
}

// VEC cells of a row from cell cx (0 where the row or the cells are outside
// the domain; with VEC > 1, X % VEC == 0, so a vector is all in or all out).
template <int VEC>
__device__ __forceinline__ void load_cells(const float* __restrict__ row, bool in,
                                           float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = in ? __ldg(reinterpret_cast<const float4*>(row))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = in ? __ldg(reinterpret_cast<const float2*>(row)) : make_float2(0.f, 0.f);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = in ? __ldg(row) : 0.f;
  }
}

template <int VEC>
__device__ __forceinline__ void store_cells(int32_t* __restrict__ row,
                                            const uint32_t (&d)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<int4*>(row),
           make_int4(static_cast<int>(d[0]), static_cast<int>(d[1]), static_cast<int>(d[2]),
                     static_cast<int>(d[3])));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<int2*>(row),
           make_int2(static_cast<int>(d[0]), static_cast<int>(d[1])));
  } else {
    __stcs(row, static_cast<int>(d[0]));
  }
}

// One plane ``xp`` [Y, X] of this lane's cells in rows y0 .. y0+WY-1 (the
// whole warp calls it together): its 2-D Lorenzo difference
// p = q - q[y-1] - q[x-1] + q[y-1,x-1] replaces p_prev, and with STORE the
// z-difference p - p_prev is written to ``op`` [Y, X].  Cells outside the
// plane read as 0.
template <int VEC, int WY, bool STORE>
__device__ __forceinline__ void plane_step(const float* __restrict__ xp, int32_t* __restrict__ op,
                                           int Y, int X, int x0, int y0, int lane, float two_eb,
                                           uint32_t (&p_prev)[WY][VEC]) {
  const int cx = x0 + lane * VEC;
  float v[WY + 1][VEC];
  float left[WY + 1];
#pragma unroll
  for (int r = 0; r <= WY; ++r) {  // every load first: WY + 1 in flight
    const int y = y0 - 1 + r;
    const bool row_in = y >= 0 && y < Y;
    const float* row = xp + static_cast<size_t>(row_in ? y : 0) * X;
    load_cells<VEC>(row + cx, row_in && cx < X, v[r]);
    left[r] = (row_in && lane == 0 && x0 > 0) ? __ldg(row + x0 - 1) : 0.f;
  }
  uint32_t h_up[VEC];
#pragma unroll
  for (int r = 0; r <= WY; ++r) {
    uint32_t q[VEC], h[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[e] = quant(v[r][e], two_eb);
    uint32_t ql = __shfl_up_sync(FULL, q[VEC - 1], 1);
    if (lane == 0) ql = x0 > 0 ? quant(left[r], two_eb) : 0u;
    h[0] = q[0] - ql;
#pragma unroll
    for (int e = 1; e < VEC; ++e) h[e] = q[e] - q[e - 1];
    if (r > 0) {
      uint32_t d[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t pe = h[e] - h_up[e];
        d[e] = pe - p_prev[r - 1][e];
        p_prev[r - 1][e] = pe;
      }
      if (STORE && y0 + r - 1 < Y && cx < X)
        store_cells<VEC>(op + static_cast<size_t>(y0 + r - 1) * X + cx, d);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) h_up[e] = h[e];
  }
}

// Warp g of the grid owns domain b, z segment zs, row window wy and x
// segment xs (g = ((b * nzs + zs) * nwy + wy) * nxs + xs).
template <int VEC, int WY, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
lorenzo_rows_kernel(const float* __restrict__ x, int32_t* __restrict__ out, long long B, int Z,
                    int Y, int X, int nzs, int nwy, int nxs, float two_eb) {
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int xs = static_cast<int>(g % nxs);
  long long t = g / nxs;
  const int wy = static_cast<int>(t % nwy);
  t /= nwy;
  const int zs = static_cast<int>(t % nzs);
  const long long b = t / nzs;
  if (b >= B) return;  // the whole warp: the shuffles stay full-warp
  const int x0 = xs * 32 * VEC, y0 = wy * WY, z0 = zs * SEG_Z;
  const int z1 = min(z0 + SEG_Z, Z);
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t base = static_cast<size_t>(b) * Z * plane;
  const float* xb = x + base;
  int32_t* ob = out + base;

  uint32_t p_prev[WY][VEC];
#pragma unroll
  for (int r = 0; r < WY; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) p_prev[r][e] = 0u;
  if (z0 > 0)  // seed: p of the plane before the segment
    plane_step<VEC, WY, false>(xb + static_cast<size_t>(z0 - 1) * plane, nullptr, Y, X, x0, y0,
                               lane, two_eb, p_prev);
  for (int z = z0; z < z1; ++z)
    plane_step<VEC, WY, true>(xb + static_cast<size_t>(z) * plane,
                              ob + static_cast<size_t>(z) * plane, Y, X, x0, y0, lane, two_eb,
                              p_prev);
}

template <int VEC, int WY, int MIN_BLOCKS>
int launch_rows(const float* x, int32_t* out, long long B, int Z, int Y, int X, float two_eb,
                cudaStream_t stream) {
  const int nzs = (Z + SEG_Z - 1) / SEG_Z;
  const int nwy = (Y + WY - 1) / WY;
  const int nxs = (X + 32 * VEC - 1) / (32 * VEC);
  const long long blocks = (B * nzs * nwy * nxs + WARPS - 1) / WARPS;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  lorenzo_rows_kernel<VEC, WY, MIN_BLOCKS>
      <<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(x, out, B, Z, Y, X, nzs, nwy,
                                                                 nxs, two_eb);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector the rows allow: every row of every domain starts at a
// multiple of X cells from the (aligned) base pointers.  Window heights and
// register caps (MIN_BLOCKS blocks an SM: 64 or 80 registers) are the
// fastest of those timed at [512,64,64,64] and 512^3 (PERF.md §6).
int launch(const void* x, void* out, long long B, int Z, int Y, int X, float two_eb,
           void* stream) {
  if (B <= 0 || Z <= 0 || Y <= 0 || X <= 0) return static_cast<int>(cudaGetLastError());
  const auto xf = static_cast<const float*>(x);
  const auto o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (X % 4 == 0 && X >= 128 && addr % 16 == 0)
    return launch_rows<4, 2, 8>(xf, o, B, Z, Y, X, two_eb, s);
  if (X % 2 == 0 && X >= 64 && addr % 8 == 0)
    return launch_rows<2, 4, 6>(xf, o, B, Z, Y, X, two_eb, s);
  return launch_rows<1, 4, 6>(xf, o, B, Z, Y, X, two_eb, s);
}

}  // namespace

extern "C" int lorenzo_quant_tiles(const void* x, void* out, long long B, int Z, int Y,
                                   int X, float two_eb, void* stream) {
  return launch(x, out, B, Z, Y, X, two_eb, stream);
}

extern "C" int lorenzo_quant_volume(const void* x, void* out, int Z, int Y, int X,
                                    float two_eb, void* stream) {
  return launch(x, out, 1, Z, Y, X, two_eb, stream);
}
