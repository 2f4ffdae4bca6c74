// Fused prequantize + per-tile 3-axis Lorenzo difference, for sm_90a.
//
// Replaces: src/repro/kernels/lorenzo_quant.py::lorenzo_quant_tiles (Pallas).
// Computes, for a batch of B tiles [B, Z, Y, X] float32:
//   q = rint(x / two_eb)                     (IEEE division, half to even)
//   d = q - q[z-1] - q[y-1] - q[x-1] + q[z-1,y-1] + q[z-1,x-1] + q[y-1,x-1]
//         - q[z-1,y-1,x-1]                   (zero outside the tile)
// which is the three first differences of the oracle
// (repro/kernels/ref.py::lorenzo_quant_ref) in int32, wrapping mod 2^32.
// The Pallas kernel differences in float32 and parts from the oracle above
// |q| = 2^24; this kernel follows the oracle.  Tiles of rank 1 or 2 come in
// as [B, 1, 1, X] / [B, 1, Y, X]: a difference along a size-1 axis is the
// identity, so one kernel serves every rank up to 3.
//
// What bounds it on the H100: bytes.  Each element is read once (4 B) and
// written once (4 B); 512 tiles of 64^3 move 1.07 GB, 0.32 ms at 3.35 TB/s.
// The division is ~20 instructions, far below the card's arithmetic rate.
//
// Design: the TPU kernel carried the previous z-plane in VMEM across
// sequential grid steps.  Blocks on the GPU run in no order, so each block
// owns a 32x8 (x, y) window of one tile and marches down z itself.  Per
// plane it quantizes its window plus a one-cell halo (row y0-1, column x0-1)
// into shared memory, forms the 2-D difference p = q - q[y-1] - q[x-1] +
// q[y-1,x-1] per thread and emits p - p_prev, keeping p_prev in a register.
// Loads are coalesced 128-byte rows; the halo re-reads 41 of 256 cells.
// The arithmetic is uint32_t, because signed overflow is undefined in C++
// and the reference wraps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ uint32_t quant(float v, float two_eb) {
  return static_cast<uint32_t>(static_cast<int32_t>(rintf(__fdiv_rn(v, two_eb))));
}

__global__ void __launch_bounds__(BX * BY)
lorenzo_quant_tiles_kernel(const float* __restrict__ x, int32_t* __restrict__ out,
                           int Z, int Y, int X, int nbx, int nby, float two_eb) {
  __shared__ uint32_t q[BY + 1][BX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long blk = blockIdx.x;
  const int bxi = static_cast<int>(blk % nbx);
  const int byi = static_cast<int>((blk / nbx) % nby);
  const long long b = blk / (static_cast<long long>(nbx) * nby);
  const int x0 = bxi * BX, y0 = byi * BY;
  const int gx = x0 + tx, gy = y0 + ty;
  const bool inside = gx < X && gy < Y;
  const size_t plane = static_cast<size_t>(Y) * X;
  const float* xt = x + static_cast<size_t>(b) * Z * plane;
  int32_t* ot = out + static_cast<size_t>(b) * Z * plane;

  uint32_t p_prev = 0;
  for (int z = 0; z < Z; ++z) {
    const float* xp = xt + static_cast<size_t>(z) * plane;
    q[ty + 1][tx + 1] = inside ? quant(xp[static_cast<size_t>(gy) * X + gx], two_eb) : 0u;
    if (ty == 0)
      q[0][tx + 1] = (y0 > 0 && gx < X)
          ? quant(xp[static_cast<size_t>(y0 - 1) * X + gx], two_eb) : 0u;
    if (tx == 0)
      q[ty + 1][0] = (x0 > 0 && gy < Y)
          ? quant(xp[static_cast<size_t>(gy) * X + x0 - 1], two_eb) : 0u;
    if (tx == 0 && ty == 0)
      q[0][0] = (x0 > 0 && y0 > 0)
          ? quant(xp[static_cast<size_t>(y0 - 1) * X + x0 - 1], two_eb) : 0u;
    __syncthreads();
    const uint32_t p = q[ty + 1][tx + 1] - q[ty][tx + 1] - q[ty + 1][tx] + q[ty][tx];
    if (inside)
      ot[static_cast<size_t>(z) * plane + static_cast<size_t>(gy) * X + gx] =
          static_cast<int32_t>(p - p_prev);
    p_prev = p;
    __syncthreads();  // the next plane overwrites q
  }
}

}  // namespace

extern "C" int lorenzo_quant_tiles(const void* x, void* out, long long B, int Z, int Y,
                                   int X, float two_eb, void* stream) {
  const int nbx = (X + BX - 1) / BX;
  const int nby = (Y + BY - 1) / BY;
  const long long blocks = B * nbx * nby;
  if (blocks <= 0 || Z <= 0) return static_cast<int>(cudaGetLastError());
  lorenzo_quant_tiles_kernel<<<static_cast<unsigned>(blocks), dim3(BX, BY), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(out), Z, Y, X, nbx, nby, two_eb);
  return static_cast<int>(cudaGetLastError());
}
