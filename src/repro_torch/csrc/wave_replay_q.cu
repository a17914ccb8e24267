// Per-layer wave-replay megakernel, int8, for Hopper (sm_90a).
//
// Replaces repro/kernels/wave_replay_q/kernel.py::_replay_q_kernel, the
// Pallas TPU kernel that replays one conv layer's decomposition schedule
// on the paper's fixed-point datapath in one launch. It computes the same
// function over the same operands: the padded NHWC int8 input, the natural
// per-group HWIO int8 weights, the int32 bias and requantize vectors
// (bias_q, m, shift; padded channels carry m = 0, shift = 31), the
// (n_chain, n_tiles, 8) int32 operand table of the fp32 kernel, the static
// pre_shift and, for a fused residual add, the int8 residual at the padded
// output geometry (the layer's output scale). The output is the padded
// (B, out_h_pad, out_w_pad, out_c_pad) int8 tensor with masked lanes
// exactly 0, bit-identical to the plain version: integer sums are exact in
// any order, so chains, slices and groups cannot change a bit.
//
// What bounds it: at AlexNet's shapes the work is int8 multiply-adds
// (665.8 M per image) over a few MB of int8 operands, so the card's
// arithmetic rate bounds it, not its memory. Design, from that and from
// what the card offers:
//
// * The CTA decomposition is K1's (csrc/wave_replay.cu, host half in
//   kernels/wave_replay/kernel.py::launch_geometry): each TPU tile's
//   output block is cut by image (blockIdx.z), by a block of (pooled)
//   output rows x cols of at most 64 conv pixels and by a block of 64
//   output channels inside one conv group (blockIdx.x/y).
// * The chain axis is a loop inside the CTA and the int32 accumulator
//   lives in registers (4x4 per thread): the paper's 32-bit partial-sum
//   bank never reaches device memory. The TPU kernel's exact-fp32 fan
//   chunks are not needed: int32 accumulation is exact.
// * Each chain step is an implicit-im2col GEMM over 32-deep slices of the
//   (ky, kx, c) reduction, gathered from the table-steered halo window
//   into shared memory as int8, four reduction elements packed into one
//   32-bit word, identically for A and B. Where the per-group fan and the
//   channel stride are multiples of 4 a word is one aligned 32-bit load.
//   __dp4a multiplies: signed, exact, four MACs per instruction on the
//   CUDA cores. (Tensor-core s8 MMA is later work.)
// * The epilogue is int32 throughout, in the reference's order: + bias_q,
//   requantize (rounding pre-shift, * m, rounding shift; ReLU folded into
//   the clip only without a residual), residual add and clip, int8
//   max-pool over conv rows staged in shared memory, masked zero write.
// * Depthwise layers (one input channel per group) take a direct kernel:
//   one thread per output element, K*K taps per conv value.
#include <cuda_runtime.h>
#include <stdint.h>

// Must match kernel.py::GEOM_Q_FIELDS field for field (K1's Geom first).
struct GeomQ {
  int batch, pad_h, pad_w, in_c, k, stride, w_in, out_c, fan, groups, opg;
  int n_chain, n_tiles, blk_h, blk_w, acc_h, acc_w;
  int out_h_pad, out_w_pad, pool, ps, relu, residual, depthwise;
  int cta_ph, cta_pw, cta_ch, cta_cw, blocks_h, blocks_w, ch_tiles;
  int pre_shift, vec_x;
};

namespace {

constexpr int kBM = 64;   // conv pixels per CTA (cta_ch * cta_cw <= kBM)
constexpr int kBN = 64;   // output channels per CTA
constexpr int kBK = 32;   // reduction elements staged per slice
constexpr int kBW = kBK / 4;   // packed 32-bit words per slice
constexpr int kTM = 4;    // pixels per thread
constexpr int kTN = 4;    // channels per thread
constexpr int kThreads = 256;
constexpr int kWords = kBM * kBW / kThreads;   // 2 words of A and of B
constexpr int kQmax = 127;

// Table columns (core/schedule.py OP_*).
constexpr int kIY = 0, kIX = 1, kTY = 2, kTX = 3, kC0 = 4, kWC0 = 5,
              kVR = 6, kVC = 7;

// round(v / 2^s), half up, arithmetic; int32 wrap-around as the reference.
__device__ __forceinline__ int rshift_round(int v, int s) {
  const unsigned bias = s > 0 ? (1u << (s - 1)) : 0u;
  return static_cast<int>(static_cast<unsigned>(v) + bias) >> s;
}

// bias add, requantize_i32 (clip low bound `lo`), residual_add_i8.
__device__ __forceinline__ int epilogue(const GeomQ& g, int acc, int bias,
                                        int m, int shift, const int8_t* res,
                                        long idx) {
  int v = static_cast<int>(static_cast<unsigned>(acc) +
                           static_cast<unsigned>(bias));
  if (g.pre_shift) v = rshift_round(v, g.pre_shift);
  v = static_cast<int>(static_cast<unsigned>(v) * static_cast<unsigned>(m));
  v = rshift_round(v, shift - g.pre_shift);
  const int lo = g.relu ? 0 : -kQmax;
  if (!g.residual) return min(max(v, lo), kQmax);
  v = min(max(v, -kQmax), kQmax) + res[idx];
  return min(max(v, lo), kQmax);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         (static_cast<unsigned>(b3 & 0xff) << 24);
}

__global__ void __launch_bounds__(kThreads)
replay_q_gemm(GeomQ g, const int8_t* __restrict__ x,
              const int8_t* __restrict__ w, const int* __restrict__ bias,
              const int* __restrict__ mq, const int* __restrict__ sh,
              const int* __restrict__ table, const int8_t* __restrict__ res,
              int8_t* __restrict__ out) {
  __shared__ int As[kBW][kBM];
  __shared__ int Bs[kBW][kBN];
  __shared__ int Cs[kBM][kBN + 1];

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
    const int* row = table + (step * g.n_tiles + t) * 8;
    const int iy = row[kIY], ix = row[kIX], c0 = row[kC0], wc0 = row[kWC0];
    const long pix_off =
        pix_ok ? (static_cast<long>(b * g.pad_h + iy + ay * g.stride) * g.pad_w
                  + ix + ax * g.stride) * g.in_c + c0 + gi * g.fan
               : 0;
    const int8_t* wcol = w + static_cast<long>(wc0) * g.out_c + co0 + lm;
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
  const int* last = table + ((g.n_chain - 1) * g.n_tiles + t) * 8;
  const int tile_y = last[kTY], tile_x = last[kTX];
  const int vr = last[kVR], vc = last[kVC];
  if (g.pool == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = ty + 16 * i;
      const int py = ay0 + m / g.cta_cw, px = ax0 + m % g.cta_cw;
      if (m >= npix || py >= g.blk_h || px >= g.blk_w) continue;
      const int oy = tile_y * g.blk_h + py, ox = tile_x * g.blk_w + px;
      const long base =
          (static_cast<long>(b * g.out_h_pad + oy) * g.out_w_pad + ox) *
              g.out_c + co0;
      const bool keep = py < vr && px < vc;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = tx + 16 * j;
        if (n >= nvalid) continue;
        const int co = co0 + n;
        const int q = epilogue(g, acc[i][j], bias[co], mq[co], sh[co], res,
                               base + n);
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
          n < nvalid ? epilogue(g, acc[i][j], bias[co], mq[co], sh[co],
                                nullptr, 0)
                     : 0;
    }
  __syncthreads();
  for (int e = tid; e < g.cta_ph * g.cta_pw * kBN; e += kThreads) {
    const int n = e % kBN, p = e / kBN;
    const int pr = p / g.cta_pw, pc = p % g.cta_pw;
    const int r = pr0 + pr, c = pc0 + pc;
    if (r >= g.blk_h || c >= g.blk_w || n >= nvalid) continue;
    int best = -128;
    for (int dy = 0; dy < g.pool; ++dy)
      for (int dx = 0; dx < g.pool; ++dx)
        best = max(best, Cs[(pr * g.ps + dy) * g.cta_cw + pc * g.ps + dx][n]);
    const int oy = tile_y * g.blk_h + r, ox = tile_x * g.blk_w + c;
    out[(static_cast<long>(b * g.out_h_pad + oy) * g.out_w_pad + ox) *
            g.out_c + co0 + n] =
        (r < vr && c < vc) ? static_cast<int8_t>(best) : 0;
  }
}

// One thread per element of each tile's output block (image, tile, row,
// column, channel), placed by the tile's (TY, TX); used for depthwise
// layers. The blocks cover the padded output exactly.
__global__ void __launch_bounds__(kThreads)
replay_q_direct(GeomQ g, const int8_t* __restrict__ x,
                const int8_t* __restrict__ w, const int* __restrict__ bias,
                const int* __restrict__ mq, const int* __restrict__ sh,
                const int* __restrict__ table,
                const int8_t* __restrict__ res, int8_t* __restrict__ out) {
  const long total =
      static_cast<long>(g.batch) * g.n_tiles * g.blk_h * g.blk_w * g.out_c;
  const long e = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
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
      (static_cast<long>(b * g.out_h_pad + oy) * g.out_w_pad + ox) * g.out_c +
      co;
  if (r >= last[kVR] || c >= last[kVC]) {
    out[idx] = 0;
    return;
  }
  const int gi = co / g.opg;
  int best = -128;
  for (int dy = 0; dy < g.pool; ++dy)
    for (int dx = 0; dx < g.pool; ++dx) {
      const int ay = r * g.ps + dy, ax = c * g.ps + dx;
      int a = 0;
      for (int step = 0; step < g.n_chain; ++step) {
        const int* row = table + (step * g.n_tiles + t) * 8;
        const int cin = row[kC0] + gi * g.fan;
        for (int ky = 0; ky < g.k; ++ky)
          for (int kx = 0; kx < g.k; ++kx) {
            const long xo =
                (static_cast<long>(b * g.pad_h + row[kIY] + ay * g.stride +
                                   ky) * g.pad_w +
                 row[kIX] + ax * g.stride + kx) * g.in_c + cin;
            const long wo =
                (static_cast<long>(ky * g.k + kx) * g.w_in + row[kWC0]) *
                    g.out_c + co;
            for (int ci = 0; ci < g.fan; ++ci)
              a += static_cast<int>(x[xo + ci]) *
                   static_cast<int>(w[wo + static_cast<long>(ci) * g.out_c]);
          }
      }
      best = max(best, epilogue(g, a, bias[co], mq[co], sh[co], res, idx));
    }
  out[idx] = static_cast<int8_t>(best);
}

}  // namespace

// Launches one kernel for one layer on `stream`; returns the cudaError_t of
// the launch (0 on success). `res` may be null when g->residual is 0.
extern "C" int wave_replay_q_i8(const GeomQ* g, const int8_t* x,
                                const int8_t* w, const int* bias,
                                const int* m, const int* shift,
                                const int* table, const int8_t* res,
                                int8_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g->depthwise) {
    const long total = static_cast<long>(g->batch) * g->n_tiles * g->blk_h *
                       g->blk_w * g->out_c;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    replay_q_direct<<<blocks, kThreads, 0, s>>>(*g, x, w, bias, m, shift,
                                                table, res, out);
  } else {
    dim3 grid(g->n_tiles * g->blocks_h * g->blocks_w,
              g->groups * g->ch_tiles, g->batch);
    replay_q_gemm<<<grid, kThreads, 0, s>>>(*g, x, w, bias, m, shift, table,
                                            res, out);
  }
  return static_cast<int>(cudaGetLastError());
}
