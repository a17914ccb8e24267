// One conv replayed through K1's dense gemm body (wave_replay_body.cuh) as
// ONE tile with ONE chain step: the device function that kernels K5
// (fused_conv_pool.cu: pooled, ReLU'd, grouped, with a bias) and K6
// (conv_stream.cu: the raw sum, one group, a zero bias) both run, so they
// share K1's tested CTA split, reduction order and arithmetic (IEEE fp32
// FFMA, no TF32).
//
// One CTA computes a block of (pooled) output rows x cols of one image for
// 64 output channels of one group, over the conv rows its pooled rows
// need; the reduction K*K*fan runs in 16-deep slices staged in shared
// memory with the accumulator in registers. Geom comes from
// kernels/wave_replay/kernel.py::one_step_geometry.
#pragma once

#include "wave_replay_body.cuh"

namespace wr {

// The one step of the one tile: the window and the weights start at their
// tensors' first elements; the last-row record places the block at the
// origin with every (pooled) row and column valid.
struct OneStep {
  const float* w;
  int row[8];
  __device__ StepIn at(int, int) const { return {0, 0, 0, w}; }
  __device__ const int* last(int) const { return row; }
};

// One CTA's share of the conv; the output is a contiguous NHWC tensor of
// groups * opg channels.
__device__ __forceinline__ void one_step_conv(
    const Geom& g, const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out) {
  const OneStep steps{w, {0, 0, 0, 0, 0, 0, g.blk_h, g.blk_w}};
  const int c = g.groups * g.opg;
  const View v{g.blk_h, g.blk_w, c, 0, 0, c};
  gemm_block(g, steps, blockIdx.x, blockIdx.y, blockIdx.z, x, bias, nullptr,
             v, out, v);
}

// The grid of one_step_conv: (CTA blocks of the image, channel tiles of
// every group, images).
inline dim3 one_step_grid(const Geom& g) {
  return dim3(g.blocks_h * g.blocks_w, g.groups * g.ch_tiles, g.batch);
}

}  // namespace wr
