// The fp32 wave-replay bodies shared by K1 (wave_replay.cu, one layer per
// launch) and K2 (wave_replay_graph.cu, a fused chain per launch).
//
// Each body computes one CTA's share (gemm) or one thread's element
// (direct) of one tile's output block, exactly as K1 always has: the same
// CTA split, the same reduction order and the same epilogue, so a node
// replayed by K2 is bit-identical to the same node launched by K1. What
// differs between the two kernels is only where a chain step reads
// (a `Steps` functor: the table row's window origin and the step's weight
// chunk) and where the block is written and the residual read (`View`).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Must match kernel.py::GEOM_FIELDS field for field. pad_h/pad_w/in_c
// describe the tensor the input windows are read from, w_in the weight
// fan stride of a step's chunk.
struct Geom {
  int batch, pad_h, pad_w, in_c, k, stride, w_in, out_c, fan, groups, opg;
  int n_chain, n_tiles, blk_h, blk_w, acc_h, acc_w;
  int out_h_pad, out_w_pad, pool, ps, relu, residual, depthwise;
  int cta_ph, cta_pw, cta_ch, cta_cw, blocks_h, blocks_w, ch_tiles;
};

// Where a chain step reads: the window origin in the input tensor and the
// step's weight chunk, laid out (K, K, w_in, out_c) from the chunk's first
// fan row.
struct StepIn {
  int iy, ix, c0;
  const float* w;
};

// An NHWC tensor a tile's output block is written to (or its residual
// block read from): per-image rows h, columns w and channel stride c, the
// block's origin shifted by (dy, dx), channels written below wc.
struct View {
  int h, w, c, dy, dx, wc;
};

namespace wr {

constexpr int kBM = 64;   // conv pixels per CTA (cta_ch * cta_cw <= kBM)
constexpr int kBN = 64;   // output channels per CTA
constexpr int kBK = 16;   // reduction slice staged per step
constexpr int kTM = 4;    // pixels per thread
constexpr int kTN = 4;    // channels per thread
constexpr int kThreads = 256;
constexpr int kLoadsA = kBM * kBK / kThreads;   // 4
constexpr int kLoadsB = kBN * kBK / kThreads;   // 4

// Table columns shared by the per-layer table (core/schedule.py OP_*) and
// the graph table (GOP_*, the same first eight columns).
constexpr int kIY = 0, kIX = 1, kTY = 2, kTX = 3, kC0 = 4, kWC0 = 5,
              kVR = 6, kVC = 7;

__device__ __forceinline__ long view_index(const View& v, int b, int oy,
                                           int ox) {
  return (static_cast<long>(b * v.h + v.dy + oy) * v.w + v.dx + ox) * v.c;
}

// One CTA's block of one tile: CTA (bx, by) of image b in K1's grid.
template <class Steps>
__device__ __forceinline__ void gemm_block(
    const Geom& g, const Steps& steps, int bx, int by, int b,
    const float* __restrict__ x, const float* __restrict__ bias,
    const float* __restrict__ res, const View& rv, float* __restrict__ out,
    const View& ov) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  __shared__ float Cs[kBM][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int per_tile = g.blocks_h * g.blocks_w;
  const int t = bx / per_tile;
  const int blk = bx % per_tile;
  const int pr0 = (blk / g.blocks_w) * g.cta_ph;   // output-block origin
  const int pc0 = (blk % g.blocks_w) * g.cta_pw;
  const int ay0 = pr0 * g.ps, ax0 = pc0 * g.ps;    // conv-row origin
  const int gi = by / g.ch_tiles;
  const int n0 = (by % g.ch_tiles) * kBN;
  const int nvalid = min(kBN, g.opg - n0);
  const int co0 = gi * g.opg + n0;
  const int npix = g.cta_ch * g.cta_cw;
  const int kfan = g.k * g.fan;
  const int red = g.k * kfan;                      // K*K*fan per chain step

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // A loads: reduction index fastest across threads (channels contiguous).
  const int lk = tid % kBK;
  int pix_off[kLoadsA];
  bool pix_ok[kLoadsA];

  for (int step = 0; step < g.n_chain; ++step) {
    const StepIn s = steps.at(step, t);
#pragma unroll
    for (int i = 0; i < kLoadsA; ++i) {
      const int m = tid / kBK + i * (kThreads / kBK);
      const int ay = ay0 + m / g.cta_cw, ax = ax0 + m % g.cta_cw;
      pix_ok[i] = m < npix && ay < g.acc_h && ax < g.acc_w;
      pix_off[i] = pix_ok[i]
          ? ((b * g.pad_h + s.iy + ay * g.stride) * g.pad_w + s.ix
             + ax * g.stride) * g.in_c + s.c0 + gi * g.fan
          : 0;
    }
    for (int r0 = 0; r0 < red; r0 += kBK) {
      {
        const int r = r0 + lk;
        const int ky = r / kfan, rr = r % kfan;
        const int kx = rr / g.fan, c = rr % g.fan;
        const int roff = (ky * g.pad_w + kx) * g.in_c + c;
#pragma unroll
        for (int i = 0; i < kLoadsA; ++i) {
          const int m = tid / kBK + i * (kThreads / kBK);
          As[lk][m] = (pix_ok[i] && r < red) ? x[pix_off[i] + roff] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadsB; ++i) {
        const int kk = tid / kBN + i * (kThreads / kBN);
        const int n = tid % kBN;
        const int r = r0 + kk;
        float v = 0.f;
        if (r < red && n < nvalid) {
          const int ky = r / kfan, rr = r % kfan;
          const int kx = rr / g.fan, c = rr % g.fan;
          v = s.w[((ky * g.k + kx) * g.w_in + c) * g.out_c + co0 + n];
        }
        Bs[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue: bias, residual, ReLU, pool, masked write, at the block
  // (TY, TX) and under the mask (VR, VC) of the tile's last chain row.
  const int* last = steps.last(t);
  const int tile_y = last[kTY], tile_x = last[kTX];
  const int vr = last[kVR], vc = last[kVC];
  if (g.pool == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = ty + 16 * i;
      const int ay = ay0 + m / g.cta_cw, ax = ax0 + m % g.cta_cw;
      if (m >= npix || ay >= g.blk_h || ax >= g.blk_w) continue;
      const int oy = tile_y * g.blk_h + ay, ox = tile_x * g.blk_w + ax;
      const long base = view_index(ov, b, oy, ox) + co0;
      const long rbase = view_index(rv, b, oy, ox) + co0;
      const bool keep = ay < vr && ax < vc;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = tx + 16 * j;
        if (n >= nvalid || co0 + n >= ov.wc) continue;
        float v = acc[i][j] + bias[co0 + n];
        if (g.residual) v += res[rbase + n];
        if (g.relu) v = fmaxf(v, 0.f);
        out[base + n] = keep ? v : 0.f;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = tx + 16 * j;
      float v = acc[i][j] + (n < nvalid ? bias[co0 + n] : 0.f);
      Cs[ty + 16 * i][n] = g.relu ? fmaxf(v, 0.f) : v;
    }
  __syncthreads();
  for (int e = tid; e < g.cta_ph * g.cta_pw * kBN; e += kThreads) {
    const int n = e % kBN, p = e / kBN;
    const int pr = p / g.cta_pw, pc = p % g.cta_pw;
    const int r = pr0 + pr, c = pc0 + pc;
    if (r >= g.blk_h || c >= g.blk_w || n >= nvalid || co0 + n >= ov.wc)
      continue;
    float best = -INFINITY;
    for (int dy = 0; dy < g.pool; ++dy)
      for (int dx = 0; dx < g.pool; ++dx)
        best = fmaxf(best, Cs[(pr * g.ps + dy) * g.cta_cw + pc * g.ps + dx][n]);
    const int oy = tile_y * g.blk_h + r, ox = tile_x * g.blk_w + c;
    out[view_index(ov, b, oy, ox) + co0 + n] =
        (r < vr && c < vc) ? best : 0.f;
  }
}

// Element e of the tiles' output blocks (image, tile, row, column,
// channel), placed by the tile's (TY, TX); used for depthwise layers. The
// blocks cover the padded output exactly. Returns without work for
// e >= batch * n_tiles * blk_h * blk_w * out_c.
template <class Steps>
__device__ __forceinline__ void direct_elem(
    const Geom& g, const Steps& steps, long e, const float* __restrict__ x,
    const float* __restrict__ bias, const float* __restrict__ res,
    const View& rv, float* __restrict__ out, const View& ov) {
  const long total =
      (long)g.batch * g.n_tiles * g.blk_h * g.blk_w * g.out_c;
  if (e >= total) return;
  const int co = e % g.out_c;
  long rest = e / g.out_c;
  const int c = rest % g.blk_w;
  rest /= g.blk_w;
  const int r = rest % g.blk_h;
  rest /= g.blk_h;
  const int t = rest % g.n_tiles;
  const int b = rest / g.n_tiles;
  if (co >= ov.wc) return;
  const int* last = steps.last(t);
  const int oy = last[kTY] * g.blk_h + r, ox = last[kTX] * g.blk_w + c;
  const long idx = view_index(ov, b, oy, ox) + co;
  if (r >= last[kVR] || c >= last[kVC]) {
    out[idx] = 0.f;
    return;
  }
  const int gi = co / g.opg;
  float best = -INFINITY;
  for (int dy = 0; dy < g.pool; ++dy)
    for (int dx = 0; dx < g.pool; ++dx) {
      const int ay = r * g.ps + dy, ax = c * g.ps + dx;
      float a = 0.f;
      for (int step = 0; step < g.n_chain; ++step) {
        const StepIn s = steps.at(step, t);
        const int cin = s.c0 + gi * g.fan;
        for (int ky = 0; ky < g.k; ++ky)
          for (int kx = 0; kx < g.k; ++kx) {
            const long xo = ((long)(b * g.pad_h + s.iy + ay * g.stride + ky)
                                 * g.pad_w + s.ix + ax * g.stride + kx)
                            * g.in_c + cin;
            const long wo = (long)(ky * g.k + kx) * g.w_in * g.out_c + co;
            for (int ci = 0; ci < g.fan; ++ci)
              a = fmaf(x[xo + ci], s.w[wo + (long)ci * g.out_c], a);
          }
      }
      a += bias[co];
      if (g.residual) a += res[view_index(rv, b, oy, ox) + co];
      if (g.relu) a = fmaxf(a, 0.f);
      best = fmaxf(best, a);
    }
  out[idx] = best;
}

}  // namespace wr
