// Per-layer wave-replay megakernel, fp32, for Hopper (sm_90a).
//
// Replaces repro/kernels/wave_replay/kernel.py::_replay_kernel, the Pallas
// TPU kernel that replays one conv layer's decomposition schedule in one
// launch. It computes the same function over the same operands: the padded
// NHWC input, the natural per-group HWIO weights, the bias, the
// (n_chain, n_tiles, 8) int32 operand table (IY/IX/C0/WC0 are element
// offsets, TY/TX block indices, VR/VC the write mask) and, for a fused
// residual add, the residual at the padded output geometry. The output is
// the padded (B, out_h_pad, out_w_pad, out_c_pad) tensor with the masked
// lanes exactly 0.
//
// What bounds it: at AlexNet's shapes the work is fp32 multiply-adds
// (665.8 M per image) over a few MB of operands, so the card's fp32
// rate bounds it, not its memory. Design, from that and from what the
// card offers (132 SMs, 227 KB of shared memory per block):
//
// * The TPU grid is not carried over. A TPU step covers almost a whole
//   layer for several images (a 0.2-1.2 MB accumulator per image). Here
//   each TPU tile's output block is split across CTAs by image
//   (blockIdx.z), by a block of (pooled) output rows x cols and by a block
//   of 64 output channels inside one conv group (blockIdx.x/y), so that a
//   batch of 8 fills the card.
// * The chain axis is a loop inside each CTA and the accumulator lives in
//   registers (4x4 per thread), so partial sums never reach device memory.
//   Each chain step is an implicit-im2col GEMM: a 16-deep slice of the
//   (ky, kx, c) reduction is gathered from the table-steered halo window
//   into shared memory with the matching weight slice.
// * A fused pool: a CTA computes the conv rows its pooled rows need,
//   (blk - 1) * ps + pool of them, recomputing the overlap at CTA edges as
//   the TPU kernel does at tile edges, stages them in shared memory after
//   bias and ReLU, then pools and writes. The shared memory stays under
//   the 48 KB that needs no opt-in.
// * Depthwise layers (groups > 1, one input channel per group) have no
//   reduction to share between output channels, so they take a direct
//   kernel: one thread per output element, K*K taps per conv value.
// * Arithmetic is IEEE fp32 FFMA on the CUDA cores: no TF32, no tensor
//   cores, so the result holds the fp32 parity of the plain version.
#include <cuda_runtime.h>
#include <math.h>

// Must match kernel.py::GEOM_FIELDS field for field.
struct Geom {
  int batch, pad_h, pad_w, in_c, k, stride, w_in, out_c, fan, groups, opg;
  int n_chain, n_tiles, blk_h, blk_w, acc_h, acc_w;
  int out_h_pad, out_w_pad, pool, ps, relu, residual, depthwise;
  int cta_ph, cta_pw, cta_ch, cta_cw, blocks_h, blocks_w, ch_tiles;
};

namespace {

constexpr int kBM = 64;   // conv pixels per CTA (cta_ch * cta_cw <= kBM)
constexpr int kBN = 64;   // output channels per CTA
constexpr int kBK = 16;   // reduction slice staged per step
constexpr int kTM = 4;    // pixels per thread
constexpr int kTN = 4;    // channels per thread
constexpr int kThreads = 256;
constexpr int kLoadsA = kBM * kBK / kThreads;   // 4
constexpr int kLoadsB = kBN * kBK / kThreads;   // 4

// Table columns (core/schedule.py OP_*).
constexpr int kIY = 0, kIX = 1, kTY = 2, kTX = 3, kC0 = 4, kWC0 = 5,
              kVR = 6, kVC = 7;

__global__ void __launch_bounds__(kThreads)
replay_gemm(Geom g, const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ table,
            const float* __restrict__ res, float* __restrict__ out) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  __shared__ float Cs[kBM][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int per_tile = g.blocks_h * g.blocks_w;
  const int t = blockIdx.x / per_tile;
  const int blk = blockIdx.x % per_tile;
  const int pr0 = (blk / g.blocks_w) * g.cta_ph;   // output-block origin
  const int pc0 = (blk % g.blocks_w) * g.cta_pw;
  const int ay0 = pr0 * g.ps, ax0 = pc0 * g.ps;    // conv-row origin
  const int gi = blockIdx.y / g.ch_tiles;
  const int n0 = (blockIdx.y % g.ch_tiles) * kBN;
  const int nvalid = min(kBN, g.opg - n0);
  const int co0 = gi * g.opg + n0;
  const int b = blockIdx.z;
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
    const int* row = table + (step * g.n_tiles + t) * 8;
    const int iy = row[kIY], ix = row[kIX], c0 = row[kC0], wc0 = row[kWC0];
#pragma unroll
    for (int i = 0; i < kLoadsA; ++i) {
      const int m = tid / kBK + i * (kThreads / kBK);
      const int ay = ay0 + m / g.cta_cw, ax = ax0 + m % g.cta_cw;
      pix_ok[i] = m < npix && ay < g.acc_h && ax < g.acc_w;
      pix_off[i] = pix_ok[i]
          ? ((b * g.pad_h + iy + ay * g.stride) * g.pad_w + ix
             + ax * g.stride) * g.in_c + c0 + gi * g.fan
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
          v = w[((ky * g.k + kx) * g.w_in + wc0 + c) * g.out_c + co0 + n];
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
  const int* last = table + ((g.n_chain - 1) * g.n_tiles + t) * 8;
  const int tile_y = last[kTY], tile_x = last[kTX];
  const int vr = last[kVR], vc = last[kVC];
  if (g.pool == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = ty + 16 * i;
      const int ay = ay0 + m / g.cta_cw, ax = ax0 + m % g.cta_cw;
      if (m >= npix || ay >= g.blk_h || ax >= g.blk_w) continue;
      const int oy = tile_y * g.blk_h + ay, ox = tile_x * g.blk_w + ax;
      const long base =
          ((long)(b * g.out_h_pad + oy) * g.out_w_pad + ox) * g.out_c + co0;
      const bool keep = ay < vr && ax < vc;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = tx + 16 * j;
        if (n >= nvalid) continue;
        float v = acc[i][j] + bias[co0 + n];
        if (g.residual) v += res[base + n];
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
    if (r >= g.blk_h || c >= g.blk_w || n >= nvalid) continue;
    float best = -INFINITY;
    for (int dy = 0; dy < g.pool; ++dy)
      for (int dx = 0; dx < g.pool; ++dx)
        best = fmaxf(best, Cs[(pr * g.ps + dy) * g.cta_cw + pc * g.ps + dx][n]);
    const int oy = tile_y * g.blk_h + r, ox = tile_x * g.blk_w + c;
    out[((long)(b * g.out_h_pad + oy) * g.out_w_pad + ox) * g.out_c + co0 + n] =
        (r < vr && c < vc) ? best : 0.f;
  }
}

// One thread per element of each tile's output block (image, tile, row,
// column, channel), placed by the tile's (TY, TX); used for depthwise
// layers. The blocks cover the padded output exactly.
__global__ void __launch_bounds__(kThreads)
replay_direct(Geom g, const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const int* __restrict__ table,
              const float* __restrict__ res, float* __restrict__ out) {
  const long total =
      (long)g.batch * g.n_tiles * g.blk_h * g.blk_w * g.out_c;
  const long e = (long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int co = e % g.out_c;
  long rest = e / g.out_c;
  const int c = rest % g.blk_w;
  rest /= g.blk_w;
  const int r = rest % g.blk_h;
  rest /= g.blk_h;
  const int t = rest % g.n_tiles;
  const int b = rest / g.n_tiles;
  const int* last = table + ((g.n_chain - 1) * g.n_tiles + t) * 8;
  const int oy = last[kTY] * g.blk_h + r, ox = last[kTX] * g.blk_w + c;
  const long idx =
      ((long)(b * g.out_h_pad + oy) * g.out_w_pad + ox) * g.out_c + co;
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
        const int* row = table + (step * g.n_tiles + t) * 8;
        const int cin = row[kC0] + gi * g.fan;
        for (int ky = 0; ky < g.k; ++ky)
          for (int kx = 0; kx < g.k; ++kx) {
            const long xo = ((long)(b * g.pad_h + row[kIY] + ay * g.stride + ky)
                                 * g.pad_w + row[kIX] + ax * g.stride + kx)
                            * g.in_c + cin;
            const long wo = ((long)(ky * g.k + kx) * g.w_in + row[kWC0]) * g.out_c + co;
            for (int ci = 0; ci < g.fan; ++ci)
              a = fmaf(x[xo + ci], w[wo + (long)ci * g.out_c], a);
          }
      }
      a += bias[co];
      if (g.residual) a += res[idx];
      if (g.relu) a = fmaxf(a, 0.f);
      best = fmaxf(best, a);
    }
  out[idx] = best;
}

}  // namespace

// Launches one kernel for one layer on `stream`; returns the cudaError_t of
// the launch (0 on success). `res` may be null when g->residual is 0.
extern "C" int wave_replay_f32(const Geom* g, const float* x, const float* w,
                               const float* bias, const int* table,
                               const float* res, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g->depthwise) {
    const long total =
        (long)g->batch * g->n_tiles * g->blk_h * g->blk_w * g->out_c;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    replay_direct<<<blocks, kThreads, 0, s>>>(*g, x, w, bias, table, res, out);
  } else {
    dim3 grid(g->n_tiles * g->blocks_h * g->blocks_w, g->groups * g->ch_tiles,
              g->batch);
    replay_gemm<<<grid, kThreads, 0, s>>>(*g, x, w, bias, table, res, out);
  }
  return static_cast<int>(cudaGetLastError());
}
