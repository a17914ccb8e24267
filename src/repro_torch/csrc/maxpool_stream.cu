// Streaming VALID max-pool, fp32 or bf16, for Hopper (sm_90a): kernel K7.
//
// Replaces repro/kernels/maxpool_stream/kernel.py::_pool_kernel, the Pallas
// TPU kernel of the paper's pooling unit: x (B, H, W, C) NHWC -> (B, H_out,
// W_out, C) for any pool and stride (overlapping, as AlexNet's 3/2, or
// skipping rows, stride > pool). The TPU kernel walks (image, row block)
// and stages each block's (R-1)*stride + pool input rows, pool - stride of
// them halo, then folds a running max, started at NEG = -3e38, over the
// pool x pool strided slices in fp32.
//
// What bounds it: bytes. One comparison per input tap against 4 (fp32) or
// 2 (bf16) bytes read once; AlexNet's three pools at batch 8 move 3-12 MB.
//
// Design:
// * one CTA per (image, block of output rows, block of output columns,
//   channel slice of up to 32 channels); the launcher
//   (kernels/maxpool_stream/kernel.py::tiling) sizes the blocks so that
//   the input window they read, halo rows and columns included, fits the
//   48 KB of shared memory a launch gets without opting in.
// * the window is staged once in shared memory, channels fastest, so a
//   warp reads 32 neighbouring channels of one pixel (128 B at fp32); the
//   overlapping windows then read their taps from shared memory, not
//   again from device memory.
// * each thread folds the pool x pool taps of one (row, column, channel)
//   in fp32 from NEG with a compare that passes a NaN on (fmaxf would
//   drop it; jnp.maximum and torch.maximum do not), and writes the input's
//   dtype back: the max is one of the inputs or NEG, so fp32 -> bf16
//   rounds only NEG, to nearest as PyTorch's cast does.
// * VALID pooling reads no row or column past the input, so the kernel
//   needs no padding; rows and columns the blocks do not fill are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max(a, b) that keeps a NaN of either side, as torch.maximum does.
__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_stream_kernel(const T* __restrict__ x, T* __restrict__ out, int H,
                      int W, int C, int pool, int ps, int h_out, int w_out,
                      int rows, int cols, int cs, int n_cs) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int c0 = (blockIdx.x % n_cs) * cs;
  const int oc0 = (blockIdx.x / n_cs) * cols;
  const int or0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int nc = min(cs, C - c0);
  const int ncol = min(cols, w_out - oc0);
  const int nrow = min(rows, h_out - or0);
  const int in_rows = (nrow - 1) * ps + pool;
  const int in_cols = (ncol - 1) * ps + pool;

  // stage the window: input rows or0*ps.., columns oc0*ps.., this slice
  const size_t img = static_cast<size_t>(b) * H;
  for (int i = threadIdx.x; i < in_rows * in_cols * nc; i += kThreads) {
    const int c = i % nc;
    const int t = i / nc;
    const int col = t % in_cols;
    const int row = t / in_cols;
    tile[i] = x[((img + or0 * ps + row) * W + oc0 * ps + col) * C + c0 + c];
  }
  __syncthreads();

  const size_t out_img = static_cast<size_t>(b) * h_out;
  for (int i = threadIdx.x; i < nrow * ncol * nc; i += kThreads) {
    const int c = i % nc;
    const int t = i / nc;
    const int oc = t % ncol;
    const int r = t / ncol;
    float acc = kNeg;
    for (int ky = 0; ky < pool; ++ky) {
      const T* src = tile + ((r * ps + ky) * in_cols + oc * ps) * nc + c;
      for (int kx = 0; kx < pool; ++kx)
        acc = max_nan(acc, to_f32(src[kx * nc]));
    }
    out[((out_img + or0 + r) * w_out + oc0 + oc) * C + c0 + c] =
        from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int H, int W, int C, int pool,
           int ps, int h_out, int w_out, int rows, int cols, int cs,
           void* stream) {
  const int n_cs = (C + cs - 1) / cs;
  const dim3 grid(n_cs * ((w_out + cols - 1) / cols),
                  (h_out + rows - 1) / rows, B);
  const size_t smem = static_cast<size_t>((rows - 1) * ps + pool) *
                      ((cols - 1) * ps + pool) * cs * sizeof(T);
  maxpool_stream_kernel<T><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, pool, ps,
      h_out, w_out, rows, cols, cs, n_cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K7 once on `stream`; return the cudaError_t of the launch (0 on
// success). (rows, cols, cs) is one CTA's block of output rows, output
// columns and channels; the window they read must fit 48 KB.
extern "C" int maxpool_stream_f32(const void* x, void* out, int B, int H,
                                  int W, int C, int pool, int ps, int h_out,
                                  int w_out, int rows, int cols, int cs,
                                  void* stream) {
  return launch<float>(x, out, B, H, W, C, pool, ps, h_out, w_out, rows,
                       cols, cs, stream);
}

extern "C" int maxpool_stream_bf16(const void* x, void* out, int B, int H,
                                   int W, int C, int pool, int ps, int h_out,
                                   int w_out, int rows, int cols, int cs,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, out, B, H, W, C, pool, ps, h_out, w_out,
                               rows, cols, cs, stream);
}
