// Flash-attention forward, fp32 or bf16 in, fp32 softmax, for Hopper
// (sm_90a): kernel K9.
//
// Replaces repro/kernels/flash_attention/kernel.py::_attn_kernel, the
// Pallas TPU kernel that streams KV blocks past a resident Q block with an
// online softmax (running max m, normaliser l, fp32 accumulator), so the
// S x T score matrix never exists. q (B, H, S, D), k and v (B, KV, T, D),
// query head h reading KV head h / (H / KV) (GQA, no replication); scores
// scaled by D^-1/2; a causal mask and, with it, a sliding window; blocks
// whose every score is masked are skipped. The TPU grid is (B, H, q block,
// kv block), the kv axis sequential with m, l and the accumulator in VMEM.
//
// What bounds it: operations. A causal prefill of 4096 tokens at D 128
// does about 2*S*T*D multiply-adds per head against some 100 MB of
// traffic. This kernel multiplies on the CUDA cores in fp32 (FFMA), so its
// bound is the fp32 peak; a tensor-core path is later work.
//
// Design:
// * one CTA of 256 threads per (batch x head, block of 64 query rows); the
//   kv-block grid axis becomes the CTA's loop over 32-key blocks. q blocks
//   are handed out from the last one down, so under a causal mask the
//   CTAs with the most key blocks start first.
// * the q block, each K and V block and the block's probabilities are
//   staged in shared memory as fp32 (172 KB at D = 320, opted in with
//   cudaFuncAttributeMaxDynamicSharedMemorySize). Q and K rows are padded
//   to an odd length so that 16 threads reading 16 rows hit 16 banks.
// * thread (ty, tx) holds scores of rows 4 ty..4 ty + 3 against keys tx,
//   tx + 16, and the accumulator of the same 4 rows over columns tx + 16 c,
//   so m, l and the rescaling stay in registers; a row's max and sum are
//   reduced over the 16 threads of a half-warp with shuffles.
// * masks as kernel.py:55-60: key < T, then causal, then the window;
//   masked scores are -1e30 and their probabilities exactly 0, since a row
//   can be wholly masked in one block while m is still -1e30. expf, not
//   __expf, and the last step divides by max(l, 1e-30), as :74-75 do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows of a CTA
constexpr int kBK = 32;                 // keys of a staged block
constexpr int kPRow = kBK + 1;          // padded row of the probabilities
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline size_t smem_bytes(int D) {
  const int dp = D | 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * dp + kBK * D + kBQ * kPRow);
}

// DS: output columns per thread, D <= 16 * DS.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KV, int S, int T_, int D, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int dp = D | 1;
  float* qs = smem;                     // [kBQ][dp]
  float* ks = qs + kBQ * dp;            // [kBK][dp]
  float* vs = ks + kBK * dp;            // [kBK][D]
  float* ps = vs + kBK * D;             // [kBQ][kPRow]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qg = q + static_cast<size_t>(bh) * S * D;
  const size_t kv_off =
      static_cast<size_t>(b * KV + h / (H / KV)) * T_ * D;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qs[r * dp + d] = q0 + r < S
        ? to_f32(qg[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DS; ++c) acc[i][c] = 0.f;
  }

  const int nk = (T_ + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    // kernel.py:41-46 on this CTA's blocks: uniform over the CTA
    if (causal && (k0 > q0 + kBQ - 1 ||
                   (window > 0 && q0 - window >= k0 + kBK)))
      continue;
    __syncthreads();                  // the last block's reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < T_;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      ks[r * dp + d] = in ? to_f32(kg[g]) : 0.f;
      vs[r * D + d] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * dp + d];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) kv[jj] = ks[(tx + 16 * jj) * dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        ok[jj] = kp < T_ && (!causal || (kp <= qp &&
                                         (window <= 0 || kp > qp - window)));
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
      }
      const float m_new =
          fmaxf(m[i], half_warp_max(fmaxf(s[i][0], s[i][1])));
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        ps[(ty * 4 + i) * kPRow + tx + 16 * jj] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(rs);
#pragma unroll
      for (int c = 0; c < DS; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int c2 = 0; c2 < kBK; ++c2) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPRow + c2];
#pragma unroll
      for (int c = 0; c < DS; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = vs[c2 * D + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(bh) * S + qp) * D;
#pragma unroll
    for (int c = 0; c < DS; ++c) {
      const int col = tx + 16 * c;
      if (col < D) o[col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DS>
int launch_ds(const void* q, const void* k, const void* v, void* out, int B,
              int H, int KV, int S, int T_, int D, int causal, int window,
              float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, DS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, S, T_, D,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int T_, int D, int causal, int window,
           float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ds = (D + 15) / 16;
#define REPRO_FA_CASE(N)                                                   \
  if (ds <= N)                                                             \
    return launch_ds<T, N>(q, k, v, out, B, H, KV, S, T_, D, causal,       \
                           window, scale, st);
  REPRO_FA_CASE(1)
  REPRO_FA_CASE(2)
  REPRO_FA_CASE(4)
  REPRO_FA_CASE(8)
  REPRO_FA_CASE(12)
  REPRO_FA_CASE(16)
  REPRO_FA_CASE(20)
#undef REPRO_FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);   // D > 320
}

}  // namespace

// Launch K9 once on `stream`; return the cudaError_t of the launch (0 on
// success). q, k, v and out are contiguous; D <= 320; window applies only
// when causal is set.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int KV, int S, int T_, int D, int causal,
                                   int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, B, H, KV, S, T_, D, causal, window,
                       scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int KV, int S, int T_, int D, int causal,
                                    int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, T_, D, causal,
                               window, scale, stream);
}
