// Fused prequantize + 3-axis Lorenzo difference, for sm_90a: the
// tile-batched kernel and the whole-volume kernel.
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
// |q| = 2^24; these kernels follow the oracle.  Volumes of rank 1 or 2 come
// in as [1, 1, X] / [1, Y, X]: a difference along a size-1 axis is the
// identity, so one kernel serves every rank up to 3.
//
// What bounds them on the H100: bytes.  Each element is read once (4 B) and
// written once (4 B); 2^27 values move 1.07 GB, 0.32 ms at 3.35 TB/s.  The
// division is ~20 instructions, far below the card's arithmetic rate.
//
// Design.  The TPU kernels carry the previous z-plane in VMEM across
// sequential grid steps.  Blocks on the GPU run in no order, so a block
// owns a 32x8 (x, y) window and marches down z itself.  Per plane it
// quantizes its window plus a one-cell halo (row y0-1, column x0-1) into
// shared memory, forms the 2-D difference p = q - q[y-1] - q[x-1] +
// q[y-1,x-1] per thread and emits p - p_prev, keeping p_prev in a register.
// Loads are coalesced 128-byte rows; the halo re-reads 41 of 256 cells.
// The arithmetic is uint32_t, because signed overflow is undefined in C++
// and the reference wraps.
//
// The tiles kernel gives each (tile, window) one block that walks the whole
// tile.  A whole 512^3 volume walked that way would have 1,024 blocks, one
// wave on 132 SMs, each marching 512 planes in series.  So the volume
// kernel also splits z into segments of SEG_Z planes, one block per
// (segment, window): a block first forms p of the plane before its segment
// (zero at the volume's face) to seed p_prev, re-reading 1/SEG_Z of the
// input, and the grid grows by Z / SEG_Z (16,384 blocks at 512^3).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int SEG_Z = 32;  // planes per block of the volume kernel

__device__ __forceinline__ uint32_t quant(float v, float two_eb) {
  return static_cast<uint32_t>(static_cast<int32_t>(rintf(__fdiv_rn(v, two_eb))));
}

// 2-D Lorenzo difference of this thread's cell of plane ``xp`` (all threads
// of the block call it together; it syncs twice, so ``q`` is free again on
// return).  Cells outside the plane read as 0.
__device__ __forceinline__ uint32_t plane_diff(const float* __restrict__ xp,
                                               uint32_t (*q)[BX + 1], int Y, int X,
                                               int x0, int y0, float two_eb) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = x0 + tx, gy = y0 + ty;
  q[ty + 1][tx + 1] = (gx < X && gy < Y)
      ? quant(xp[static_cast<size_t>(gy) * X + gx], two_eb) : 0u;
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
  __syncthreads();  // the next plane overwrites q
  return p;
}

// z-difference of planes [z_begin, z_end) of one domain [Z, Y, X] at ``xt``,
// seeded with p_prev (the 2-D difference of plane z_begin - 1, or 0).
__device__ __forceinline__ void march_z(const float* __restrict__ xt,
                                        int32_t* __restrict__ ot, uint32_t (*q)[BX + 1],
                                        int z_begin, int z_end, uint32_t p_prev, int Y,
                                        int X, int x0, int y0, float two_eb) {
  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  const bool inside = gx < X && gy < Y;
  const size_t plane = static_cast<size_t>(Y) * X;
  for (int z = z_begin; z < z_end; ++z) {
    const uint32_t p = plane_diff(xt + static_cast<size_t>(z) * plane, q, Y, X, x0, y0,
                                  two_eb);
    if (inside)
      ot[static_cast<size_t>(z) * plane + static_cast<size_t>(gy) * X + gx] =
          static_cast<int32_t>(p - p_prev);
    p_prev = p;
  }
}

__global__ void __launch_bounds__(BX * BY)
lorenzo_quant_tiles_kernel(const float* __restrict__ x, int32_t* __restrict__ out,
                           int Z, int Y, int X, int nbx, int nby, float two_eb) {
  __shared__ uint32_t q[BY + 1][BX + 1];
  const long long blk = blockIdx.x;
  const int bxi = static_cast<int>(blk % nbx);
  const int byi = static_cast<int>((blk / nbx) % nby);
  const long long b = blk / (static_cast<long long>(nbx) * nby);
  const size_t tile = static_cast<size_t>(Z) * Y * X;
  march_z(x + static_cast<size_t>(b) * tile, out + static_cast<size_t>(b) * tile, q, 0, Z,
          0u, Y, X, bxi * BX, byi * BY, two_eb);
}

__global__ void __launch_bounds__(BX * BY)
lorenzo_quant_volume_kernel(const float* __restrict__ x, int32_t* __restrict__ out,
                            int Z, int Y, int X, int nbx, int nby, float two_eb) {
  __shared__ uint32_t q[BY + 1][BX + 1];
  const long long blk = blockIdx.x;
  const int bxi = static_cast<int>(blk % nbx);
  const int byi = static_cast<int>((blk / nbx) % nby);
  const int seg = static_cast<int>(blk / (static_cast<long long>(nbx) * nby));
  const int x0 = bxi * BX, y0 = byi * BY;
  const int z0 = seg * SEG_Z;
  const int z1 = min(z0 + SEG_Z, Z);
  const uint32_t seed = z0 > 0
      ? plane_diff(x + static_cast<size_t>(z0 - 1) * Y * X, q, Y, X, x0, y0, two_eb) : 0u;
  march_z(x, out, q, z0, z1, seed, Y, X, x0, y0, two_eb);
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

extern "C" int lorenzo_quant_volume(const void* x, void* out, int Z, int Y, int X,
                                    float two_eb, void* stream) {
  const int nbx = (X + BX - 1) / BX;
  const int nby = (Y + BY - 1) / BY;
  const long long blocks = static_cast<long long>((Z + SEG_Z - 1) / SEG_Z) * nbx * nby;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  lorenzo_quant_volume_kernel<<<static_cast<unsigned>(blocks), dim3(BX, BY), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(out), Z, Y, X, nbx, nby, two_eb);
  return static_cast<int>(cudaGetLastError());
}
