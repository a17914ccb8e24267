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
// * Both bodies live in wave_replay_q_body.cuh, shared with the fused-chain
//   kernel K4 (wave_replay_graph_q.cu); this file steers them by the
//   per-layer table.
#include "wave_replay_q_body.cuh"

namespace {

using namespace wrq;

// A chain step's window and weight chunk from the per-layer table
// (n_chain, n_tiles, 8); the weight is the whole (K, K, w_in, out_c)
// tensor, a step's chunk starting at fan row WC0.
struct TableStepsQ {
  const int* table;
  const int8_t* w;
  int n_chain, n_tiles, out_c;
  __device__ StepInQ at(int step, int t) const {
    const int* r = table + (step * n_tiles + t) * 8;
    return {r[kIY], r[kIX], r[kC0], w + static_cast<long>(r[kWC0]) * out_c};
  }
  __device__ const int* last(int t) const {
    return table + ((n_chain - 1) * n_tiles + t) * 8;
  }
};

__device__ __forceinline__ View out_view(const GeomQ& g) {
  return {g.out_h_pad, g.out_w_pad, g.out_c, 0, 0, g.out_c};
}

__global__ void __launch_bounds__(kThreads)
replay_q_gemm(GeomQ g, const int8_t* __restrict__ x,
              const int8_t* __restrict__ w, const int* __restrict__ bias,
              const int* __restrict__ mq, const int* __restrict__ sh,
              const int* __restrict__ table, const int8_t* __restrict__ res,
              int8_t* __restrict__ out) {
  const TableStepsQ steps{table, w, g.n_chain, g.n_tiles, g.out_c};
  const View v = out_view(g);
  gemm_block(g, steps, blockIdx.x, blockIdx.y, blockIdx.z, x, bias, mq, sh,
             res, v, out, v);
}

__global__ void __launch_bounds__(kThreads)
replay_q_direct(GeomQ g, const int8_t* __restrict__ x,
                const int8_t* __restrict__ w, const int* __restrict__ bias,
                const int* __restrict__ mq, const int* __restrict__ sh,
                const int* __restrict__ table,
                const int8_t* __restrict__ res, int8_t* __restrict__ out) {
  const TableStepsQ steps{table, w, g.n_chain, g.n_tiles, g.out_c};
  const View v = out_view(g);
  direct_elem(g, steps,
              static_cast<long>(blockIdx.x) * kThreads + threadIdx.x, x,
              bias, mq, sh, res, v, out, v);
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
