// The int8 wave-replay bodies shared by K3 (wave_replay_q.cu, one layer
// per launch) and K4 (wave_replay_graph_q.cu, a fused chain per launch).
//
// Each body computes one CTA's share (gemm) or one thread's element
// (direct) of one tile's int8 output block, exactly as K3 always has. The
// kernels differ only in where a chain step reads (a `Steps` functor) and
// where the block is written and the residual read (`View`, from
// wave_replay_body.cuh). Integer sums are exact in any order, so a node
// replayed by K4 is bit-identical to K3 launched on it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wave_replay_body.cuh"

// Must match kernel.py::GEOM_Q_FIELDS field for field (K1's Geom first).
// vec_x: every word of A is one aligned 32-bit load (the fan, the input's
// channel stride and every step's channel origin are multiples of 4).
struct GeomQ {
  int batch, pad_h, pad_w, in_c, k, stride, w_in, out_c, fan, groups, opg;
  int n_chain, n_tiles, blk_h, blk_w, acc_h, acc_w;
  int out_h_pad, out_w_pad, pool, ps, relu, residual, depthwise;
  int cta_ph, cta_pw, cta_ch, cta_cw, blocks_h, blocks_w, ch_tiles;
  int pre_shift, vec_x;
};

// Where an int8 chain step reads: the window origin in the input tensor
// and the step's weight chunk, laid out (K, K, w_in, out_c).
struct StepInQ {
  int iy, ix, c0;
  const int8_t* w;
};

namespace wrq {

constexpr int kBM = 64;   // conv pixels per CTA (cta_ch * cta_cw <= kBM)
constexpr int kBN = 64;   // output channels per CTA
constexpr int kBK = 32;   // reduction elements staged per slice
constexpr int kBW = kBK / 4;   // packed 32-bit words per slice
constexpr int kTM = 4;    // pixels per thread
constexpr int kTN = 4;    // channels per thread
constexpr int kThreads = 256;
constexpr int kWords = kBM * kBW / kThreads;   // 2 words of A and of B
constexpr int kQmax = 127;

using wr::kC0;
using wr::kIX;
using wr::kIY;
using wr::kTX;
using wr::kTY;
using wr::kVC;
using wr::kVR;
using wr::kWC0;
using wr::view_index;

// round(v / 2^s), half up, arithmetic; int32 wrap-around as the reference.
__device__ __forceinline__ int rshift_round(int v, int s) {
  const unsigned bias = s > 0 ? (1u << (s - 1)) : 0u;
  return static_cast<int>(static_cast<unsigned>(v) + bias) >> s;
}

// bias add, requantize_i32 (clip low bound `lo`), residual_add_i8 of the
// residual code `r` (read by the caller only when g.residual).
__device__ __forceinline__ int epilogue(const GeomQ& g, int acc, int bias,
                                        int m, int shift, int r) {
  int v = static_cast<int>(static_cast<unsigned>(acc) +
                           static_cast<unsigned>(bias));
  if (g.pre_shift) v = rshift_round(v, g.pre_shift);
  v = static_cast<int>(static_cast<unsigned>(v) * static_cast<unsigned>(m));
  v = rshift_round(v, shift - g.pre_shift);
  const int lo = g.relu ? 0 : -kQmax;
  if (!g.residual) return min(max(v, lo), kQmax);
  v = min(max(v, -kQmax), kQmax) + r;
  return min(max(v, lo), kQmax);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         (static_cast<unsigned>(b3 & 0xff) << 24);
}

// One CTA's block of one tile: CTA (bx, by) of image b in K3's grid.
template <class Steps>
__device__ __forceinline__ void gemm_block(
    const GeomQ& g, const Steps& steps, int bx, int by, int b,
    const int8_t* __restrict__ x, const int* __restrict__ bias,
    const int* __restrict__ mq, const int* __restrict__ sh,
    const int8_t* __restrict__ res, const View& rv,
    int8_t* __restrict__ out, const View& ov) {
  __shared__ int As[kBW][kBM];
  __shared__ int Bs[kBW][kBN];
  __shared__ int Cs[kBM][kBN + 1];

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

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  // This thread stages pixel `lm` of A and channel `lm` of B, words
  // lw0 + 4 * i of each slice: a warp writes 32 consecutive pixels or
  // channels of one word row.
  const int lm = tid % kBM, lw0 = tid / kBM;
  const int ay = ay0 + lm / g.cta_cw, ax = ax0 + lm % g.cta_cw;
  const bool pix_ok = lm < npix && ay < g.acc_h && ax < g.acc_w;
  const bool ch_ok = lm < nvalid;

  for (int step = 0; step < g.n_chain; ++step) {
    const StepInQ s = steps.at(step, t);
    const long pix_off =
        pix_ok ? (static_cast<long>(b * g.pad_h + s.iy + ay * g.stride) *
                      g.pad_w + s.ix + ax * g.stride) * g.in_c + s.c0 +
                     gi * g.fan
               : 0;
    const int8_t* wcol = s.w + co0 + lm;
    for (int r0 = 0; r0 < red; r0 += kBK) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int kw = lw0 + 4 * i;
        const int r = r0 + 4 * kw;
        int a = 0, bw = 0;
        if (g.vec_x) {
          // fan % 4 == 0: the word's four elements are four channels of
          // one tap, and red % 4 == 0, so the word is all in or all out
          if (r < red) {
            const int ky = r / kfan, rr = r % kfan;
            const int kx = rr / g.fan, c = rr % g.fan;
            if (pix_ok)
              a = *reinterpret_cast<const int*>(
                  x + pix_off + (ky * g.pad_w + kx) * g.in_c + c);
            if (ch_ok) {
              const int8_t* wp =
                  wcol + static_cast<long>((ky * g.k + kx) * g.w_in + c) *
                             g.out_c;
              bw = pack4(wp[0], wp[g.out_c], wp[2 * g.out_c],
                         wp[3 * g.out_c]);
            }
          }
        } else {
          int xa[4], wb[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xa[j] = 0;
            wb[j] = 0;
            const int rj = r + j;
            if (rj < red) {
              const int ky = rj / kfan, rr = rj % kfan;
              const int kx = rr / g.fan, c = rr % g.fan;
              if (pix_ok)
                xa[j] = x[pix_off + (ky * g.pad_w + kx) * g.in_c + c];
              if (ch_ok)
                wb[j] = wcol[static_cast<long>((ky * g.k + kx) * g.w_in + c) *
                             g.out_c];
            }
          }
          a = pack4(xa[0], xa[1], xa[2], xa[3]);
          bw = pack4(wb[0], wb[1], wb[2], wb[3]);
        }
        As[kw][lm] = a;
        Bs[kw][lm] = bw;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kBW; ++kw) {
        int av[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = As[kw][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = Bs[kw][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue at the block (TY, TX) and under the mask (VR, VC) of the
  // tile's last chain row.
  const int* last = steps.last(t);
  const int tile_y = last[kTY], tile_x = last[kTX];
  const int vr = last[kVR], vc = last[kVC];
  if (g.pool == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = ty + 16 * i;
      const int py = ay0 + m / g.cta_cw, px = ax0 + m % g.cta_cw;
      if (m >= npix || py >= g.blk_h || px >= g.blk_w) continue;
      const int oy = tile_y * g.blk_h + py, ox = tile_x * g.blk_w + px;
      const long base = view_index(ov, b, oy, ox) + co0;
      const long rbase = view_index(rv, b, oy, ox) + co0;
      const bool keep = py < vr && px < vc;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = tx + 16 * j;
        if (n >= nvalid || co0 + n >= ov.wc) continue;
        const int co = co0 + n;
        const int q = epilogue(g, acc[i][j], bias[co], mq[co], sh[co],
                               g.residual ? res[rbase + n] : 0);
        out[base + n] = keep ? static_cast<int8_t>(q) : 0;
      }
    }
    return;
  }
  // fused pool (never with a residual): requantize every staged conv
  // pixel, then pool the int8 values
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = tx + 16 * j;
      const int co = co0 + n;
      Cs[ty + 16 * i][n] =
          n < nvalid ? epilogue(g, acc[i][j], bias[co], mq[co], sh[co], 0)
                     : 0;
    }
  __syncthreads();
  for (int e = tid; e < g.cta_ph * g.cta_pw * kBN; e += kThreads) {
    const int n = e % kBN, p = e / kBN;
    const int pr = p / g.cta_pw, pc = p % g.cta_pw;
    const int r = pr0 + pr, c = pc0 + pc;
    if (r >= g.blk_h || c >= g.blk_w || n >= nvalid || co0 + n >= ov.wc)
      continue;
    int best = -128;
    for (int dy = 0; dy < g.pool; ++dy)
      for (int dx = 0; dx < g.pool; ++dx)
        best = max(best, Cs[(pr * g.ps + dy) * g.cta_cw + pc * g.ps + dx][n]);
    const int oy = tile_y * g.blk_h + r, ox = tile_x * g.blk_w + c;
    out[view_index(ov, b, oy, ox) + co0 + n] =
        (r < vr && c < vc) ? static_cast<int8_t>(best) : 0;
  }
}

// Element e of the tiles' output blocks (image, tile, row, column,
// channel), placed by the tile's (TY, TX); used for depthwise layers.
// Returns without work for e >= batch * n_tiles * blk_h * blk_w * out_c.
template <class Steps>
__device__ __forceinline__ void direct_elem(
    const GeomQ& g, const Steps& steps, long e,
    const int8_t* __restrict__ x, const int* __restrict__ bias,
    const int* __restrict__ mq, const int* __restrict__ sh,
    const int8_t* __restrict__ res, const View& rv,
    int8_t* __restrict__ out, const View& ov) {
  const long total =
      static_cast<long>(g.batch) * g.n_tiles * g.blk_h * g.blk_w * g.out_c;
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
    out[idx] = 0;
    return;
  }
  const int gi = co / g.opg;
  const int rcode = g.residual ? res[view_index(rv, b, oy, ox) + co] : 0;
  int best = -128;
  for (int dy = 0; dy < g.pool; ++dy)
    for (int dx = 0; dx < g.pool; ++dx) {
      const int ay = r * g.ps + dy, ax = c * g.ps + dx;
      int a = 0;
      for (int step = 0; step < g.n_chain; ++step) {
        const StepInQ s = steps.at(step, t);
        const int cin = s.c0 + gi * g.fan;
        for (int ky = 0; ky < g.k; ++ky)
          for (int kx = 0; kx < g.k; ++kx) {
            const long xo =
                (static_cast<long>(b * g.pad_h + s.iy + ay * g.stride +
                                   ky) * g.pad_w +
                 s.ix + ax * g.stride + kx) * g.in_c + cin;
            const long wo =
                static_cast<long>(ky * g.k + kx) * g.w_in * g.out_c + co;
            for (int ci = 0; ci < g.fan; ++ci)
              a += static_cast<int>(x[xo + ci]) *
                   static_cast<int>(s.w[wo + static_cast<long>(ci) * g.out_c]);
          }
      }
      best = max(best, epilogue(g, a, bias[co], mq[co], sh[co], rcode));
    }
  out[idx] = static_cast<int8_t>(best);
}

}  // namespace wrq
