// int8 x int8 -> int32 matmul with fp32 dequantization, for Hopper
// (sm_90a): kernel K8.
//
// Replaces repro/kernels/quant_matmul/kernel.py::_qmm_kernel, the Pallas
// TPU kernel of the paper's fixed-point datapath: xq (M, K) int8 times wq
// (K, N) int8 with an int32 accumulator carried across K blocks, written
// on the last K block as fp32 acc * sx * sw[n] (sx one activation scale,
// sw per output column). The TPU kernel walks (M block, N block, K block)
// with the accumulator in a VMEM scratch.
//
// What bounds it: on AlexNet's int8 gemms, bytes (conv3's im2col moves 6
// MB for 2.4 GOP, the head's first layer 2.4 MB for 38 MOP) against the
// int8 tensor cores' 1,979 TOP/s. This kernel multiplies on the CUDA cores
// (__dp4a), whose int8 rate is a small part of that; a tensor-core path is
// later work.
//
// Design:
// * one CTA of 256 threads per 64 x 64 output tile; the TPU's K-block grid
//   axis is the CTA's loop over 32-deep K slices, staged in shared memory
//   with the accumulator in registers (4 x 4 per thread, rows ty + 16 i,
//   columns tx + 16 j). int32 sums are exact, so any tiling gives the same
//   accumulator as the reference's 128-blocks.
// * __dp4a wants K contiguous in both operands: the xq slice is stored
//   row-major, the wq slice transposed (column n's K bytes together). Rows
//   are padded to 36 bytes, so the 16 columns a half-warp reads fall in 16
//   banks. Bytes past M, N or K are staged as zeros, which add nothing.
// * the epilogue scales in the order of ref.py::quant_matmul_ref,
//   (float(acc) * sx) * sw[n], each step rounded to nearest (no FMA
//   contraction), so the output equals that oracle bit for bit; the
//   reference's kernel multiplies sx * sw first and is 1 ULP off it.
// * sx and sw are read from device memory: no host synchronisation.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;
constexpr int kSlice = 32;             // K bytes per staged slice
constexpr int kRow = kSlice + 4;       // padded row of a staged slice
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ sx,
                    const float* __restrict__ sw, float* __restrict__ out,
                    int M, int K, int N) {
  __shared__ __align__(16) int8_t xs[kTile * kRow];   // [m][k]
  __shared__ __align__(16) int8_t ws[kTile * kRow];   // [n][k]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kSlice) {
    {  // xq: 64 rows x 32 bytes; 8 consecutive bytes of one row a thread
      const int r = tid / 4, kb = (tid % 4) * 8;
      const int m = m0 + r;
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + kb + e;
        xs[r * kRow + kb + e] =
            (m < M && k < K) ? xq[static_cast<size_t>(m) * K + k] : 0;
      }
    }
    {  // wq: 32 rows x 64 bytes; 8 consecutive columns of one row a thread
      const int kr = tid / 8, nb = (tid % 8) * 8;
      const int k = k0 + kr;
      for (int e = 0; e < 8; ++e) {
        const int n = n0 + nb + e;
        ws[(nb + e) * kRow + kr] =
            (k < K && n < N) ? wq[static_cast<size_t>(k) * N + n] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&xs[(ty + 16 * i) * kRow + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&ws[(tx + 16 * j) * kRow + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = *sx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        out[static_cast<size_t>(m) * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), sw[n]);
    }
  }
}

}  // namespace

// Launch K8 once on `stream`; return the cudaError_t of the launch (0 on
// success). sx points at one fp32 scale, sw at N.
extern "C" int quant_matmul_i8(const void* xq, const void* wq,
                               const void* sx, const void* sw, void* out,
                               int M, int K, int N, void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  quant_matmul_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
