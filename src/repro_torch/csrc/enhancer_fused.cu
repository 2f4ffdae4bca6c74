// Group-wise fused GWLZ enhancer forward, for sm_90a.
//
// Replaces: src/repro/kernels/enhancer_fused.py::enhancer_fused (Pallas),
// which runs ONE enhancer on [B, H, W] slices: conv3x3 (1->C), BN folded
// into scale/shift, ReLU, conv3x3 (C->1), zero SAME padding.  This kernel
// adds a group axis: for every pixel p of group g = ids[p] it returns
//   pred[p] = model_g applied to xin_g = (x - lo_g) / scale_g on the pixels
//             of group g and 0 elsewhere (the masked input of
//             repro/core/trainer.py::_enhance_slices),
// then an epilogue chosen by `mode`:
//   0  pred                              (raw; the gate and the G = 1 op)
//   1  x + pred * rscale_g, x where rscale_g == 0   (residual learning)
//   2  pred * scale_g + lo_g             (direct prediction)
// and, with `clamp`, a clip to [x - eb, x + eb].  The reference runs all G
// models over every pixel and masks; this kernel runs only the pixel's own
// model over its 5x5 receptive field.
//
// Borders: conv1's input is 0 outside the slice (and off the group); conv2's
// input h is 0 outside the slice.  Inside the slice h is the model's hidden
// value whatever the neighbour's group, as in the reference.
//
// What bounds it on the H100: operations.  The function needs each hidden
// value h_g(q) (9C FMAs) once per pixel q and group g of q's 3x3
// neighbourhood, plus 9C FMAs of conv2 a pixel: 162 FMA a pixel at C = 9
// where a neighbourhood is one group, 2^27 pixels in ~0.65 ms at 67 TFLOP/s
// (the bytes, x, ids and out, take ~0.48 ms).  This kernel recomputes each
// h for each of the 9 pixels that read it, 9 x 9C + 9C = 810 FMA a pixel:
// five times that work.
//
// Design: one block per (slice, 32x32 output block), 32x8 threads, four
// output rows a thread.  The block stages x and ids for its block plus a
// 2-cell halo (36x36) in shared memory, and every group's packed parameters
// ([G, 4 + 21C] floats: lo, scale, b2, rscale, w1[9][C], b1, bn scale,
// bn shift, w2[9][C]).  A thread gathers its pixel's 25 normalised inputs
// into registers (25 IEEE divisions, __fdiv_rn), then for each channel
// loads that channel's 9 conv1 taps once and reuses them for the 9
// neighbours.  Each pixel is computed in one fixed loop order, so any
// subset of slices enhances bit-identically to the full batch (the region
// decode relies on it).  Built without --use_fast_math; the residual and
// direct epilogues use __fmul_rn/__fadd_rn so nothing is contracted there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;           // output block width  (threads in x)
constexpr int BY = 8;            // threads in y
constexpr int ROWS = 4;          // output rows per thread: block height BY * ROWS
constexpr int BH = BY * ROWS;    // 32
constexpr int WIN_W = BX + 4;    // 2-cell halo each side
constexpr int WIN_H = BH + 4;
constexpr int WIN = WIN_W * WIN_H;

__global__ void __launch_bounds__(BX * BY)
enhancer_grouped_kernel(const float* __restrict__ x, const int32_t* __restrict__ ids,
                        int H, int W, int nbx, int nby,
                        const float* __restrict__ params, int G, int C, int mode,
                        int clamp, float eb, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int P = 4 + 21 * C;
  float* prm = smem;                    // [G, P]
  float* xw = prm + G * P;              // [WIN_H, WIN_W] x
  int* iw = reinterpret_cast<int*>(xw + WIN);  // [WIN_H, WIN_W] group id, -1 outside

  const int tid = threadIdx.y * BX + threadIdx.x;
  const long long blk = blockIdx.x;
  const int bxi = static_cast<int>(blk % nbx);
  const int byi = static_cast<int>((blk / nbx) % nby);
  const long long b = blk / (static_cast<long long>(nbx) * nby);
  const int x0 = bxi * BX, y0 = byi * BH;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xs = x + static_cast<size_t>(b) * plane;
  const int32_t* is = ids ? ids + static_cast<size_t>(b) * plane : nullptr;

  for (int i = tid; i < G * P; i += BX * BY) prm[i] = params[i];
  for (int i = tid; i < WIN; i += BX * BY) {
    const int gy = y0 - 2 + i / WIN_W, gx = x0 - 2 + i % WIN_W;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t at = static_cast<size_t>(gy) * W + gx;
    xw[i] = inside ? xs[at] : 0.f;
    int g = inside ? (is ? is[at] : 0) : -1;
    if (inside) g = g < 0 ? 0 : (g > G - 1 ? G - 1 : g);
    iw[i] = g;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int gx = x0 + tx;
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    const int py = threadIdx.y + BY * r;
    const int gy = y0 + py;
    if (gy >= H || gx >= W) continue;
    const int center = (py + 2) * WIN_W + tx + 2;
    const int g = iw[center];
    const float* pg = prm + g * P;
    const float lo = pg[0], sc = pg[1];

    float xin[25];  // the 5x5 normalised, masked input around the pixel
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const int w = (py + dy) * WIN_W + tx + dx;
        xin[dy * 5 + dx] = (iw[w] == g) ? __fdiv_rn(xw[w] - lo, sc) : 0.f;
      }
    bool qin[9];  // neighbour q = p + (dy2 - 1, dx2 - 1) lies in the slice
#pragma unroll
    for (int d2 = 0; d2 < 9; ++d2) {
      const int qy = gy + d2 / 3 - 1, qx = gx + d2 % 3 - 1;
      qin[d2] = qy >= 0 && qy < H && qx >= 0 && qx < W;
    }

    const float* w1 = pg + 4;
    const float* b1 = w1 + 9 * C;
    const float* bs = b1 + C;
    const float* bt = bs + C;
    const float* w2 = bt + C;
    float acc = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      float w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = w1[k * C + c];
      const float bc = b1[c], s = bs[c], t = bt[c];
#pragma unroll
      for (int d2 = 0; d2 < 9; ++d2) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          a = fmaf(w[k], xin[(d2 / 3 + k / 3) * 5 + d2 % 3 + k % 3], a);
        a = a + bc;
        float h = fmaf(a, s, t);
        h = h < 0.f ? 0.f : h;  // ReLU; NaN propagates as in torch.relu
        h = qin[d2] ? h : 0.f;
        acc = fmaf(w2[d2 * C + c], h, acc);
      }
    }
    const float pred = acc + pg[2];

    const float xv = xw[center];
    float o = pred;
    if (mode == 1) {
      const float rs = pg[3];
      o = rs == 0.f ? xv : __fadd_rn(xv, __fmul_rn(pred, rs));
    } else if (mode == 2) {
      o = __fadd_rn(__fmul_rn(pred, sc), lo);
    }
    if (clamp) {
      const float lo_b = xv - eb, hi_b = xv + eb;
      o = o < lo_b ? lo_b : o;
      o = o > hi_b ? hi_b : o;
    }
    out[static_cast<size_t>(b) * plane + static_cast<size_t>(gy) * W + gx] = o;
  }
}

}  // namespace

extern "C" int enhancer_grouped(const void* x, const void* ids, long long B, int H, int W,
                                const void* params, int G, int C, int mode, int clamp,
                                float eb, void* out, void* stream) {
  if (G <= 0 || C <= 0 || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int nbx = (W + BX - 1) / BX;
  const int nby = (H + BH - 1) / BH;
  const long long blocks = B * nbx * nby;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (static_cast<size_t>(G) * (4 + 21 * C) + WIN) * sizeof(float) +
                      WIN * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        enhancer_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  enhancer_grouped_kernel<<<static_cast<unsigned>(blocks), dim3(BX, BY), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(ids), H, W, nbx, nby,
      static_cast<const float*>(params), G, C, mode, clamp, eb, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
