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
// and, with `clamp`, a clip to [x - eb, x + eb].  Borders: conv1's input is
// 0 outside the slice (and off the group); conv2's input h is 0 outside the
// slice.  Inside the slice h is the model's hidden value whatever the
// neighbour's group, as in the reference.
//
// What bounds it on the H100: operations, at the float32 rate of the CUDA
// cores (TF32 or bf16 tensor cores would break the 1e-5 relative
// tolerance).  The function needs each hidden value h_{g,c}(q) (9 FMAs)
// once for every cell q and group g of an output pixel in q's 3x3
// neighbourhood, plus 9C FMAs of conv2 a pixel whose group has an output.
// The first version computed, for each pixel, the 9 h of its neighbours
// (810 FMA a pixel at C = 9) from 25 inputs it divided itself (25 IEEE
// divisions a pixel), and ran the whole model for residual pixels whose
// group has no output (rscale 0).
//
// Design: one block per (slice, 32x32 output block), 32x8 threads; a
// thread owns four vertically adjacent output pixels of one column.
//   1. The window (block plus a 2-cell halo, 36x36) is staged once in
//      shared memory as (x, id) pairs.
//   2. Pixels whose group has no output (residual, rscale 0) take x and
//      skip the model.  The block's least and greatest group with an
//      output come from warp reductions (no contended atomics); a pixel of
//      any third group marks the block as one of many groups, which only
//      appends its index to a list and ends (step 4).
//   3. A block with one or two such groups (the common case: the gwlz
//      cells hold 1-2 live groups a block) normalises its window in place,
//      v = (x - lo_id) / scale_id by __fdiv_rn: one IEEE division a cell
//      (1.27 a pixel), not 25 a pixel; the masked input of group g at a
//      cell is (id == g ? v : 0), the bits the first version got from its
//      own division.  Then one pass a group: units of 4 ring cells down a
//      column whose cells a pixel of the group reads compute h_{g,c} from
//      their 6x3 masked inputs in registers, once, into shared memory (5
//      channels at a time, 34 x 34 cells each); then each pixel of the
//      group adds its 9 taps a channel, a thread's four rows reading one
//      6x3 patch when they share the group.  The group's weights are
//      warp-uniform rows of a transposed table the launcher builds (three
//      16-byte loads a channel for conv1, three for conv2).  Registers are
//      held to 64 (four blocks of 256 threads an SM).
//   4. The blocks of many groups (the 20-group gate on a noisy field: 6.6
//      groups in a 3x3 neighbourhood, so little h is shared) go to a second
//      kernel, launched right after over the list with about one grid of
//      resident blocks and no register cap.  It stages each listed block's
//      window normalised and runs each pixel through its own group's model
//      over its 5x5 inputs, as the first version did, without the first
//      version's divisions, with the table in shared memory when it fits
//      in 24 KB (float4 weight loads), a ReLU of one instruction, and, when
//      every staged weight is finite, conv2's taps of neighbours off the
//      slice skipped (below).
//   The table has any number of rows (groups up to group_hist's 4,096).
//
// The arithmetic order of each output is that of the first version, so the
// output is bit-identical to it (NaN payloads aside): conv1 taps k = 0..8 as
// fmaf from 0, then + b1, then fmaf(a, bn scale, bn shift), ReLU (max.NaN:
// NaN stays NaN), h = 0 off the slice; conv2 with channels outer and the 9
// neighbours inner (d2 = 0..8), acc = fmaf(w2, h, acc) from 0, then + b2;
// the residual and direct epilogues with __fmul_rn / __fadd_rn so nothing
// is contracted there.  A skipped tap would have added w2 * 0 = +-0 to acc,
// which starts at +0 and never rounds to -0, so acc is unchanged.  No value
// depends on which block or which subset of slices computes it, so any
// subset of slices enhances bit-identically to the full batch (the region
// decode relies on it).  Built without --use_fast_math.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;            // output block width (threads in x)
constexpr int BY = 8;             // threads in y
constexpr int ROWS = 4;           // adjacent output rows a thread: its quad
constexpr int BH = BY * ROWS;     // 32
constexpr int THREADS = BX * BY;
constexpr int WIN_W = BX + 4;     // 2-cell halo each side
constexpr int WIN_H = BH + 4;
constexpr int WIN = WIN_W * WIN_H;
constexpr int RING_W = BX + 2;    // cells whose h the block reads: a 1-cell ring
constexpr int CELLS = RING_W * (BH + 2);   // 1156
constexpr int STRIP = 4;          // cells of a unit, down one ring column
constexpr int STRIPS = RING_W * 9;         // 306 units cover ring rows 0..35
constexpr int CCMAX = 5;          // channels of h held at once (four blocks an SM)
constexpr int TAB_SMEM = 24 * 1024;  // the staged table's room (G = 20 at C = 9 takes 17.7 KB)


// Kernel table row of a group: lo, scale, b2, rscale, then per channel
// w1[9], b1, bn scale, bn shift, w2[9] and 3 zeros (24 floats).
__host__ __device__ constexpr int row_floats(int C) { return 4 + 24 * C; }

__device__ __forceinline__ float clamp_to(float o, float xv, float eb) {
  const float lo_b = xv - eb, hi_b = xv + eb;
  o = o < lo_b ? lo_b : o;
  return o > hi_b ? hi_b : o;
}

__device__ __forceinline__ void store(const float* xs, float* os, size_t at, const float* grow,
                                      float acc, int mode, int clamp, float eb) {
  const float pred = acc + grow[2];
  const float xv = xs[at];
  float o = pred;
  if (mode == 1) {
    const float rs = grow[3];
    o = rs == 0.f ? xv : __fadd_rn(xv, __fmul_rn(pred, rs));
  } else if (mode == 2) {
    o = __fadd_rn(__fmul_rn(pred, grow[1]), grow[0]);
  }
  os[at] = clamp ? clamp_to(o, xv, eb) : o;
}

// channel c of a table row: conv1 (w1[9], b1, bn scale, bn shift) and conv2 (w2[9])
struct Conv1 {
  float w[9], b1, sc, sh;
};

__device__ __forceinline__ Conv1 conv1_taps(const float* grow, int c) {
  const float4* p = reinterpret_cast<const float4*>(grow + 4 + 24 * c);
  const float4 a0 = p[0], a1 = p[1], a2 = p[2];
  return Conv1{{a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x}, a2.y, a2.z, a2.w};
}

struct Conv2 {
  float w[9];
};

__device__ __forceinline__ Conv2 conv2_taps(const float* grow, int c) {
  const float4* p = reinterpret_cast<const float4*>(grow + 4 + 24 * c + 12);
  const float4 b0 = p[0], b1 = p[1];
  return Conv2{{b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, grow[4 + 24 * c + 20]}};
}

// ReLU keeping NaN (max.NaN; the first version's h < 0 ? 0 : h kept the
// NaN's payload, this returns the canonical NaN, and maps -0 to +0, which
// no sum below can tell apart).
__device__ __forceinline__ float relu(float h) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(h));
  return r;
}

// The block's origin: slice b, output block (x0, y0).
struct Origin {
  int x0, y0;
  size_t base;  // b * H * W
};

__device__ __forceinline__ Origin origin_of(long long blk, int nbx, int nby, int H, int W) {
  const int bxi = static_cast<int>(blk % nbx);
  const int byi = static_cast<int>((blk / nbx) % nby);
  const long long b = blk / (static_cast<long long>(nbx) * nby);
  return Origin{bxi * BX, byi * BH, static_cast<size_t>(b) * H * W};
}

// The window: value and group of each cell, id -1 off the slice; the value
// normalised, or x as it is (NORMALISE false: normalise_window follows).
template <bool NORMALISE>
__device__ __forceinline__ void stage_window(float2* win, const float* xs, const int32_t* is,
                                             int H, int W, int x0, int y0,
                                             const float* table, int G, int PG, int tid) {
  for (int i = tid; i < WIN; i += THREADS) {
    const int gy = y0 - 2 + i / WIN_W, gx = x0 - 2 + i % WIN_W;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float v = 0.f;
    int g = -1;
    if (inside) {
      const size_t at = static_cast<size_t>(gy) * W + gx;
      g = is ? is[at] : 0;
      g = g < 0 ? 0 : (g > G - 1 ? G - 1 : g);
      v = xs[at];
      if (NORMALISE) {
        const float* grow = table + static_cast<size_t>(g) * PG;
        v = __fdiv_rn(v - __ldg(grow), __ldg(grow + 1));
      }
    }
    win[i] = make_float2(v, __int_as_float(g));
  }
}

__device__ __forceinline__ void normalise_window(float2* win, const float* table, int PG,
                                                 int tid) {
  for (int i = tid; i < WIN; i += THREADS) {
    const float2 cell = win[i];
    const int g = __float_as_int(cell.y);
    if (g >= 0) {
      const float* grow = table + static_cast<size_t>(g) * PG;
      win[i].x = __fdiv_rn(cell.x - __ldg(grow), __ldg(grow + 1));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)
enhancer_grouped_kernel(const float* __restrict__ x, const int32_t* __restrict__ ids,
                        int H, int W, int nbx, int nby, const float* __restrict__ table,
                        int G, int C, int mode, int clamp, float eb,
                        int* __restrict__ many, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* win = reinterpret_cast<float2*>(smem4);          // [WIN_H, WIN_W] (x or v, id)
  float* hbuf = reinterpret_cast<float*>(win + WIN);       // [CCMAX, 34, 34]
  __shared__ int s_lo, s_hi, s_many;
  const int PG = row_floats(C);

  const int tid = threadIdx.y * BX + threadIdx.x;
  const long long blk = blockIdx.x;
  const Origin o = origin_of(blk, nbx, nby, H, W);
  const int x0 = o.x0, y0 = o.y0;
  const float* xs = x + o.base;
  const int32_t* is = ids ? ids + o.base : nullptr;
  float* os = out + o.base;

  // 1. the window, x as it is
  stage_window<false>(win, xs, is, H, W, x0, y0, table, G, PG, tid);
  if (tid == 0) {
    s_lo = G;
    s_hi = -1;
    s_many = 0;
  }
  __syncthreads();

  // 2. this thread's quad: column tx, block rows py0 .. py0 + 3; g = the
  // row's group if its pixel is in the slice and has an output, else -1.
  // The block's least and greatest such group, then whether there are more.
  const int tx = threadIdx.x, py0 = threadIdx.y * ROWS;
  const int gx = x0 + tx;
  int g[ROWS];
  int lo = G, hi = -1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float2 cell = win[(py0 + r + 2) * WIN_W + tx + 2];
    int gr = __float_as_int(cell.y);
    if (gr >= 0 && mode == 1 && __ldg(table + static_cast<size_t>(gr) * PG + 3) == 0.f) {
      const size_t at = static_cast<size_t>(y0 + py0 + r) * W + gx;
      os[at] = clamp ? clamp_to(cell.x, cell.x, eb) : cell.x;  // residual, rscale 0: x
      gr = -1;
    }
    g[r] = gr;
    if (gr >= 0) {
      lo = min(lo, gr);
      hi = max(hi, gr);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tx == 0 && hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int g0 = s_lo, g1 = s_hi;
  int rows = 0;  // bit r: row r is of group g0; bit 4 + r: of group g1 != g0
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (g[r] >= 0 && g[r] != g0 && g[r] != g1) s_many = 1;
    rows |= (g[r] == g0) << r | (g[r] == g1 && g1 != g0) << (ROWS + r);
  }
  __syncthreads();
  if (s_many) {  // 4. left to enhancer_grouped_many_kernel
    if (tid == 0) many[1 + atomicAdd(many, 1)] = static_cast<int>(blk);
    return;
  }
  if (g1 < 0) return;  // no pixel with an output
  normalise_window(win, table, PG, tid);
  __syncthreads();

  // 3. at most two groups: per group, h of every ring cell whose strip a
  // pixel of the group reads, once, in shared memory; then the taps
  for (int k = 0; k < 2; ++k) {
    const int gk = k == 0 ? g0 : g1;
    if (k == 1 && g1 == g0) break;
    const float* grow = table + static_cast<size_t>(gk) * PG;
    float acc[ROWS] = {0.f, 0.f, 0.f, 0.f};
    const int mine = (rows >> (ROWS * k)) & 15;  // this thread's rows of group gk
    const bool uni = mine == 15;
    for (int c0 = 0; c0 < C; c0 += CCMAX) {
      const int ncc = min(CCMAX, C - c0);
      for (int u = tid; u < STRIPS; u += THREADS) {
        const int qx = u % RING_W - 1, qy0 = (u / RING_W) * STRIP - 1;  // block coordinates
        float xin[STRIP + 2][3];
        bool need = false;
#pragma unroll
        for (int j = 0; j < STRIP + 2; ++j)
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const int wy = qy0 + 1 + j, wx = qx + 1 + d;  // window coordinates
            const float2 cell = wy < WIN_H ? win[wy * WIN_W + wx]
                                           : make_float2(0.f, __int_as_float(-1));
            const bool mine = __float_as_int(cell.y) == gk;
            need |= mine && wy >= 2 && wy < BH + 2 && wx >= 2 && wx < BX + 2;
            xin[j][d] = mine ? cell.x : 0.f;
          }
        if (!need) continue;
        const bool col_in = x0 + qx >= 0 && x0 + qx < W;
        for (int cl = 0; cl < ncc; ++cl) {
          const Conv1 t = conv1_taps(grow, c0 + cl);
          float* hc = hbuf + cl * CELLS + qx + 1;
#pragma unroll
          for (int j = 0; j < STRIP; ++j) {
            const int qy = qy0 + j;
            if (qy > BH) break;
            float a = 0.f;
#pragma unroll
            for (int kk = 0; kk < 9; ++kk) a = fmaf(t.w[kk], xin[j + kk / 3][kk % 3], a);
            a = a + t.b1;
            const float h = relu(fmaf(a, t.sc, t.sh));
            hc[(qy + 1) * RING_W] = col_in && y0 + qy >= 0 && y0 + qy < H ? h : 0.f;
          }
        }
      }
      __syncthreads();
      for (int cl = 0; cl < ncc; ++cl) {
        const Conv2 t = conv2_taps(grow, c0 + cl);
        // ring row py0 is block row py0 - 1
        const float* hc = hbuf + cl * CELLS + py0 * RING_W + tx;
        if (uni) {
          float hv[ROWS + 2][3];
#pragma unroll
          for (int j = 0; j < ROWS + 2; ++j)
#pragma unroll
            for (int d = 0; d < 3; ++d) hv[j][d] = hc[j * RING_W + d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int d2 = 0; d2 < 9; ++d2)
              acc[r] = fmaf(t.w[d2], hv[r + d2 / 3][d2 % 3], acc[r]);
        } else {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (!(mine >> r & 1)) continue;
#pragma unroll
            for (int d2 = 0; d2 < 9; ++d2)
              acc[r] = fmaf(t.w[d2], hc[(r + d2 / 3) * RING_W + d2 % 3], acc[r]);
          }
        }
      }
      __syncthreads();  // before h is rewritten
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (mine >> r & 1)
        store(xs, os, static_cast<size_t>(y0 + py0 + r) * W + gx, grow, acc[r], mode, clamp,
              eb);
  }
}

// One pixel of group row grow through the model over its 5x5 inputs xin,
// its neighbours' slice masks qin: the first version's loop.  SKIP: every
// weight is finite, so a neighbour off the slice adds w2 * 0 = +-0 to acc,
// which leaves acc as it is (acc starts at +0 and a sum never rounds to
// -0): its multiply-add is skipped.
template <bool SKIP>
__device__ __forceinline__ float pixel_model(const float* grow, int C, const float (&xin)[25],
                                             const bool (&qin)[9]) {
  float acc = 0.f;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const Conv1 t = conv1_taps(grow, c);
    const Conv2 u = conv2_taps(grow, c);
#pragma unroll
    for (int d2 = 0; d2 < 9; ++d2) {
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < 9; ++kk)
        a = fmaf(t.w[kk], xin[(d2 / 3 + kk / 3) * 5 + d2 % 3 + kk % 3], a);
      a = a + t.b1;
      const float h = relu(fmaf(a, t.sc, t.sh));
      if (SKIP) {
        if (qin[d2]) acc = fmaf(u.w[d2], h, acc);
      } else {
        acc = fmaf(u.w[d2], qin[d2] ? h : 0.f, acc);
      }
    }
  }
  return acc;
}

// 4. the blocks of many groups, listed by enhancer_grouped_kernel in
// many[1 .. many[0]]: each pixel through its own group's model over its 5x5
// inputs, the first version's loop without its divisions.  A block walks
// the list with a stride of the grid.  STAGED: the table is staged once
// (rows of 1 + 6C float4, an odd count, so lanes loading the rows of groups
// that differ mod 8 hit different banks) and every weight load is a
// shared-memory load.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
enhancer_grouped_many_kernel(const float* __restrict__ x, const int32_t* __restrict__ ids,
                             int H, int W, int nbx, int nby, const float* __restrict__ table,
                             int G, int C, int mode, int clamp, float eb,
                             const int* __restrict__ many, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* win = reinterpret_cast<float2*>(smem4);          // [WIN_H, WIN_W] (v, id)
  float* tab_s = reinterpret_cast<float*>(win + WIN);      // [G, PG] when staged
  const int PG = row_floats(C);
  const int tid = threadIdx.y * BX + threadIdx.x;
  bool finite = true;  // every staged weight is finite
  if (STAGED)
    for (int i = tid; i < G * PG; i += THREADS) {
      const float v = __ldg(table + i);
      finite &= isfinite(v);
      tab_s[i] = v;
    }
  const bool skip = __syncthreads_and(STAGED && finite);
  const float* tab = STAGED ? tab_s : table;
  const int n = many[0];
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const Origin o = origin_of(many[1 + i], nbx, nby, H, W);
    const float* xs = x + o.base;
    float* os = out + o.base;
    stage_window<true>(win, xs, ids ? ids + o.base : nullptr, H, W, o.x0, o.y0, table, G, PG,
                       tid);
    __syncthreads();
    const int tx = threadIdx.x, gx = o.x0 + tx;
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const int py = threadIdx.y + BY * r, gy = o.y0 + py;
      const int gr = __float_as_int(win[(py + 2) * WIN_W + tx + 2].y);
      if (gr < 0) continue;  // off the slice
      const float* grow = tab + static_cast<size_t>(gr) * PG;
      if (mode == 1 && grow[3] == 0.f) continue;  // written as x by the first kernel
      float xin[25];
#pragma unroll
      for (int dy = 0; dy < 5; ++dy)
#pragma unroll
        for (int dx = 0; dx < 5; ++dx) {
          const float2 cell = win[(py + dy) * WIN_W + tx + dx];
          xin[dy * 5 + dx] = __float_as_int(cell.y) == gr ? cell.x : 0.f;
        }
      bool qin[9];
#pragma unroll
      for (int d2 = 0; d2 < 9; ++d2) {
        const int qy = gy + d2 / 3 - 1, qx = gx + d2 % 3 - 1;
        qin[d2] = qy >= 0 && qy < H && qx >= 0 && qx < W;
      }
      const float acc = skip ? pixel_model<true>(grow, C, xin, qin)
                             : pixel_model<false>(grow, C, xin, qin);
      store(xs, os, static_cast<size_t>(gy) * W + gx, grow, acc, mode, clamp, eb);
    }
    __syncthreads();  // before the window is rewritten
  }
}

}  // namespace

// many: int32 [1 + blocks] of device memory, a count and a list the two
// kernels share (kernels/enhancer_fused.py allocates it).
extern "C" int enhancer_grouped(const void* x, const void* ids, long long B, int H, int W,
                                const void* table, int G, int C, int mode, int clamp,
                                float eb, void* many, void* out, void* stream) {
  if (G <= 0 || C <= 0 || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int nbx = (W + BX - 1) / BX;
  const int nby = (H + BH - 1) / BH;
  const long long blocks = B * nbx * nby;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int32_t* ip = static_cast<const int32_t*>(ids);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  int* mp = static_cast<int*>(many);
  cudaError_t e = cudaMemsetAsync(mp, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem = sizeof(float2) * WIN + sizeof(float) * CCMAX * CELLS;
  e = cudaFuncSetAttribute(enhancer_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  enhancer_grouped_kernel<<<static_cast<unsigned>(blocks), dim3(BX, BY), smem, st>>>(
      xp, ip, H, W, nbx, nby, tp, G, C, mode, clamp, eb, mp, op);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t tab = sizeof(float) * static_cast<size_t>(G) * row_floats(C);
  const bool staged = tab <= TAB_SMEM;
  const auto kern = staged ? enhancer_grouped_many_kernel<true>
                           : enhancer_grouped_many_kernel<false>;
  const size_t smem_many = sizeof(float2) * WIN + (staged ? tab : 0);  // < 48 KB
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem_many)) !=
          cudaSuccess)
    return static_cast<int>(e);
  const long long grid = std::min<long long>(blocks, static_cast<long long>(sms) *
                                                         std::max(per_sm, 1));
  kern<<<static_cast<unsigned>(grid), dim3(BX, BY), smem_many, st>>>(
      xp, ip, H, W, nbx, nby, tp, G, C, mode, clamp, eb, mp, op);
  return static_cast<int>(cudaGetLastError());
}
