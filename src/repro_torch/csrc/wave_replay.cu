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
// * Both bodies live in wave_replay_body.cuh, shared with the fused-chain
//   kernel K2 (wave_replay_graph.cu); this file steers them by the
//   per-layer table.
#include "wave_replay_body.cuh"

namespace {

using namespace wr;

// A chain step's window and weight chunk from the per-layer table
// (n_chain, n_tiles, 8); the weight is the whole (K, K, w_in, out_c)
// tensor, a step's chunk starting at fan row WC0.
struct TableSteps {
  const int* table;
  const float* w;
  int n_chain, n_tiles, out_c;
  __device__ StepIn at(int step, int t) const {
    const int* r = table + (step * n_tiles + t) * 8;
    return {r[kIY], r[kIX], r[kC0], w + static_cast<long>(r[kWC0]) * out_c};
  }
  __device__ const int* last(int t) const {
    return table + ((n_chain - 1) * n_tiles + t) * 8;
  }
};

__device__ __forceinline__ View out_view(const Geom& g) {
  return {g.out_h_pad, g.out_w_pad, g.out_c, 0, 0, g.out_c};
}

__global__ void __launch_bounds__(kThreads)
replay_gemm(Geom g, const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ table,
            const float* __restrict__ res, float* __restrict__ out) {
  const TableSteps steps{table, w, g.n_chain, g.n_tiles, g.out_c};
  const View v = out_view(g);
  gemm_block(g, steps, blockIdx.x, blockIdx.y, blockIdx.z, x, bias, res, v,
             out, v);
}

__global__ void __launch_bounds__(kThreads)
replay_direct(Geom g, const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const int* __restrict__ table,
              const float* __restrict__ res, float* __restrict__ out) {
  const TableSteps steps{table, w, g.n_chain, g.n_tiles, g.out_c};
  const View v = out_view(g);
  direct_elem(g, steps, (long)blockIdx.x * kThreads + threadIdx.x, x, bias,
              res, v, out, v);
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
