// Streaming VALID convolution, fp32, for Hopper (sm_90a): kernel K6.
//
// Replaces repro/kernels/conv_stream/kernel.py::_conv_kernel, the Pallas TPU
// kernel behind the executors' conv_backend="pallas": a VALID conv of a
// pre-padded NHWC input x (B, H, W, Cin) with HWIO weights w (K, K, Cin,
// Cout) at any stride, written to a contiguous (B, H_out, W_out, Cout)
// output. The TPU kernel walks (image, row block, cout block, cin block)
// with the sum carried in the revisited output block across cin blocks.
//
// What bounds it: on the served path the work ranges from AlexNet conv1's
// wave (56 windows of 227x39x3 against 11x11x3x96 at stride 4, 1.72
// GFLOP) to conv3's one-channel waves (8 windows of 15x15x1 against
// 3x3x1x384, 0.0093 GFLOP each, 256 of them per forward). The large ones
// are bound by fp32 multiply-adds; the small ones by the launch itself,
// which no kernel design removes (the executor issues one launch per
// wave or scan step, as the reference issues one dispatch).
//
// Design: the dense implicit-im2col GEMM body of K1 with a one-step,
// one-tile schedule (one_step_conv.cuh, shared with K5):
//
// * one CTA per (block of output rows x cols of one image, 64 output
//   channels); the reduction K*K*Cin runs in 16-deep slices staged in
//   shared memory, the accumulator in registers (4x4 per thread). The
//   TPU's cin-block grid axis becomes the slice loop inside the CTA.
// * the executors hand K6 views: a scan step's window, or a wave's channel
//   slice of the gathered windows. Any view whose strides nest as those of
//   a slice of a larger contiguous NHWC tensor (and HWIO weights the same
//   way) is read in place: the launcher passes the enclosing tensor's
//   extents as the input (pad_h, pad_w, in_c) and weight (w_in, out_c)
//   strides. Other layouts are made contiguous by the launcher.
// * the epilogue is K1's with no pool and no ReLU, and a zero bias: the
//   output is the raw sum, exactly.
#include "one_step_conv.cuh"

namespace {

__global__ void __launch_bounds__(wr::kThreads)
conv_stream_kernel(Geom g, const float* __restrict__ x,
                   const float* __restrict__ w,
                   const float* __restrict__ zero_bias,
                   float* __restrict__ out) {
  wr::one_step_conv(g, x, w, zero_bias, out);
}

}  // namespace

// Launches K6 once on `stream`; returns the cudaError_t of the launch (0 on
// success). `zero_bias` holds at least g->opg zeros.
extern "C" int conv_stream_f32(const Geom* g, const float* x, const float* w,
                               const float* zero_bias, float* out,
                               void* stream) {
  conv_stream_kernel<<<wr::one_step_grid(*g), wr::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*g, x, w,
                                                            zero_bias, out);
  return static_cast<int>(cudaGetLastError());
}
