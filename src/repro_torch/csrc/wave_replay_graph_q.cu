// Fused-chain wave-replay kernel, int8, for Hopper (sm_90a): K4.
//
// Replaces repro/kernels/wave_replay_q/graph.py::_graph_replay_q_kernel
// (with its _q_node_step), the Pallas TPU kernel that replays a fused
// chain of conv nodes on the paper's fixed-point datapath in one launch:
// int8 arena slots between nodes, int32 partial sums, flat int8 weights
// at the table's WOFF and three flat int32 vectors (bias, m, shift) that
// share its BOFF, a requantize-on-writeback epilogue whose residual add
// reads the shortcut's int8 slot. It computes the same function over the
// same operands; the output is the last node's padded int8 tensor, masked
// lanes 0, bit-identical to K3 run node by node and to the plain version:
// integer sums are exact in any order.
//
// What bounds it: the chain's int8 multiply-adds, which on the CUDA cores
// (__dp4a) stay far from the tensor cores' int8 peak the bound is taken
// at, and a grid-wide barrier between nodes. Design: K2's
// (wave_replay_graph.cu), with K3's bodies (wave_replay_q_body.cuh):
//
// * One persistent cooperative launch over an int8 arena in device
//   memory; each node's phase zeroes its output slot, syncs the grid,
//   runs K3's work items grid-stride, and syncs again. The launch is
//   refused, never split, when the grid cannot be co-resident.
// * int32 accumulation in registers: the reference's shared psum bank and
//   its exact-fp32 fan chunks (c_sub) have no counterpart.
// * A word of A is one aligned 32-bit load only where the host found the
//   node's fan, its input's channel stride (the slot's, for nodes that
//   read the arena) and every channel origin to be multiples of 4
//   (vec_x, per node); elsewhere four byte loads are packed.
#include <cooperative_groups.h>

#include "wave_replay_q_body.cuh"

// Must match graph.py::NODE_Q_FIELDS field for field: K2's node with
// GeomQ (its static pre_shift and vec_x) in place of Geom.
struct NodeQ {
  GeomQ g;
  int in_off, in_dy, in_dx, in_ystep, in_xstep, in_cstep;
  int out_off;
  View ov;
  int res_off;
  View rv;
  int step0, boff, items, zero_elems;
};

// The chain input staged into its arena slot (off = -1: not staged).
struct StageQ {
  int off, h, w, c, dy, dx;
};

namespace {

namespace cg = cooperative_groups;
using namespace wrq;

constexpr int kCols = 14;          // core/schedule.py GRAPH_OP_COLS
constexpr int kK = 9, kWOFF = 10;  // GOP_K, GOP_WOFF

struct GraphStepsQ {
  const int* rows;   // the node's rows, tile-major, chain innermost
  const int8_t* wf;
  int n_chain, windowed, dy, dx, ystep, xstep, cstep;
  __device__ StepInQ at(int step, int t) const {
    const int* r = rows + (t * n_chain + step) * kCols;
    if (windowed) return {r[kIY], r[kIX], r[kC0], wf + r[kWOFF]};
    return {dy + r[kTY] * ystep, dx + r[kTX] * xstep, r[kK] * cstep,
            wf + r[kWOFF]};
  }
  __device__ const int* last(int t) const {
    return rows + (t * n_chain + n_chain - 1) * kCols;
  }
};

__global__ void __launch_bounds__(kThreads)
graph_replay_q(const NodeQ* __restrict__ nodes, int n_nodes, StageQ st,
               int x_h, int x_w, int x_c, const int8_t* __restrict__ x,
               const int8_t* __restrict__ wf, const int* __restrict__ bf,
               const int* __restrict__ mf, const int* __restrict__ sf,
               const int* __restrict__ table, int8_t* __restrict__ arena,
               int8_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ NodeQ nd;
  const long nthreads = static_cast<long>(gridDim.x) * kThreads;
  const long gtid = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const int batch = nodes[0].g.batch;

  if (st.off >= 0) {
    // prologue: the padded input at (dy, dx) of its slot, zeros around it
    const long total = static_cast<long>(batch) * st.h * st.w * st.c;
    for (long e = gtid; e < total; e += nthreads) {
      const int c = e % st.c;
      long rest = e / st.c;
      const int col = rest % st.w;
      rest /= st.w;
      const int row = rest % st.h;
      const int b = rest / st.h;
      const int yy = row - st.dy, xx = col - st.dx;
      arena[st.off + e] =
          (yy >= 0 && yy < x_h && xx >= 0 && xx < x_w && c < x_c)
              ? x[(static_cast<long>(b * x_h + yy) * x_w + xx) * x_c + c]
              : static_cast<int8_t>(0);
    }
    grid.sync();
  }

  for (int ni = 0; ni < n_nodes; ++ni) {
    __syncthreads();               // every thread is done with nd
    if (threadIdx.x == 0) nd = nodes[ni];
    __syncthreads();
    int8_t* o = out;
    if (nd.out_off >= 0) {
      o = arena + nd.out_off;
      for (long e = gtid; e < nd.zero_elems; e += nthreads) o[e] = 0;
      grid.sync();                 // zeros land before any block does
    }
    const GraphStepsQ steps{table + nd.step0 * kCols, wf, nd.g.n_chain,
                            nd.in_off < 0, nd.in_dy, nd.in_dx,
                            nd.in_ystep, nd.in_xstep, nd.in_cstep};
    const int8_t* xin = nd.in_off < 0 ? x : arena + nd.in_off;
    const int8_t* res = nd.res_off < 0 ? nullptr : arena + nd.res_off;
    const int* bias = bf + nd.boff;
    const int* mq = mf + nd.boff;
    const int* sh = sf + nd.boff;
    if (nd.g.depthwise) {
      const long total = static_cast<long>(nd.g.batch) * nd.g.n_tiles *
                         nd.g.blk_h * nd.g.blk_w * nd.g.out_c;
      for (long e = gtid; e < total; e += nthreads)
        direct_elem(nd.g, steps, e, xin, bias, mq, sh, res, nd.rv, o, nd.ov);
    } else {
      const int nx = nd.g.n_tiles * nd.g.blocks_h * nd.g.blocks_w;
      const int ny = nd.g.groups * nd.g.ch_tiles;
      for (int item = blockIdx.x; item < nd.items; item += gridDim.x) {
        gemm_block(nd.g, steps, item % nx, (item / nx) % ny, item / (nx * ny),
                   xin, bias, mq, sh, res, nd.rv, o, nd.ov);
        __syncthreads();           // the pool stage is reused next item
      }
    }
    if (ni + 1 < n_nodes) grid.sync();   // the next node reads this one
  }
}

}  // namespace

// CTAs of graph_replay_q that fit on one SM of the current device, or a
// negative cudaError_t.
extern "C" int wave_replay_graph_q_i8_occupancy() {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, graph_replay_q, kThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// Launches one fused int8 chain as one cooperative kernel of `grid` CTAs
// on `stream`; returns the cudaError_t of the launch (0 on success).
// `nodes` is a device array of n_nodes descriptors.
extern "C" int wave_replay_graph_q_i8(const NodeQ* nodes, int n_nodes,
                                      const StageQ* st, int x_h, int x_w,
                                      int x_c, const int8_t* x,
                                      const int8_t* wf, const int* bf,
                                      const int* mf, const int* sf,
                                      const int* table, int8_t* arena,
                                      int8_t* out, int grid, void* stream) {
  StageQ stage = *st;
  void* args[] = {&nodes, &n_nodes, &stage, &x_h, &x_w, &x_c, &x, &wf,
                  &bf,    &mf,      &sf,    &table, &arena, &out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(graph_replay_q), dim3(grid), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
