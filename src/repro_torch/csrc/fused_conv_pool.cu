// Fused VALID convolution + bias + ReLU + max-pool, fp32, for Hopper
// (sm_90a): kernel K5.
//
// Replaces repro/kernels/fused_conv_pool/kernel.py::_kernel, the Pallas TPU
// kernel behind the executors' pool_backend="fused": a VALID conv of a
// pre-padded NHWC input x (B, H, W, Cin) with per-group HWIO weights w
// (K, K, Cin/groups, Cout), then bias, ReLU and a (pool, ps) max-pool that
// may overlap (AlexNet's 3/2), so that the conv output never reaches device
// memory. The TPU kernel runs one launch per conv group and folds the bias
// into an extra all-ones input channel; here all groups run in one launch
// and the bias is added in the epilogue before the ReLU (the same sum, in
// another order, within FP32_TOL; the plain version adds it the same way).
//
// What bounds it: at AlexNet's pooled layers (conv1, conv2, conv5 at batch
// 8) the work is 6.47 GFLOP of fp32 multiply-adds over 16.3 MB of
// operands, so the card's fp32 rate bounds it, not its memory.
//
// Design: this is what K1's dense GEMM body (wave_replay_body.cuh) does for
// a layer whose schedule is one tile and one chain step, so K5 runs that
// body with such a schedule (one_step_conv.cuh, shared with K6):
//
// * one CTA per (block of pooled rows x cols of one image, 64 output
//   channels of one group). A CTA computes the conv rows its pooled rows
//   need, (rows - 1) * ps + pool of them, recomputing the overlap rows at
//   CTA edges as the TPU kernel recomputes them at row-block edges.
// * the reduction K*K*(Cin/groups) runs in 16-deep slices staged in shared
//   memory, the accumulator in registers; the TPU's cin-block grid axis
//   becomes the slice loop inside the CTA.
// * the epilogue stages bias + ReLU in shared memory, pools, and writes
//   only the pooled rows and columns that exist. IEEE fp32 FFMA, no TF32.
#include "one_step_conv.cuh"

namespace {

__global__ void __launch_bounds__(wr::kThreads)
fused_conv_pool_kernel(Geom g, const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out) {
  wr::one_step_conv(g, x, w, bias, out);
}

}  // namespace

// Launches K5 once on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_conv_pool_f32(const Geom* g, const float* x,
                                   const float* w, const float* bias,
                                   float* out, void* stream) {
  fused_conv_pool_kernel<<<wr::one_step_grid(*g), wr::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(*g, x, w,
                                                                bias, out);
  return static_cast<int>(cudaGetLastError());
}
