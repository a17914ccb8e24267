// Fused-chain wave-replay kernel, fp32, for Hopper (sm_90a): K2.
//
// Replaces repro/kernels/wave_replay/graph.py::_graph_replay_kernel (with
// its _node_step), the Pallas TPU kernel that replays a fused chain of
// conv nodes in one launch: the grid walks every node's (tile, chain)
// steps from one flat (total_steps, 14) int32 table, weights and biases
// come from flat buffers at the table's WOFF/BOFF, and the activations
// between nodes live in arena slots (core/schedule.py::plan_arena) instead
// of device memory round trips. It computes the same function over the
// same operands: the chain input padded to the head program's geometry,
// the flat weights and biases, the table; the output is the last node's
// padded (B, out_h_pad, out_w_pad, out_c_pad) tensor, masked lanes 0.
//
// What bounds it: the chain's fp32 multiply-adds, as for K1 (AlexNet's
// conv1+conv2 and conv3-conv5 are 0.08 ms each at the fp32 peak, their
// bytes far less), plus what fusion adds: a grid-wide barrier between
// nodes. Design, from that and from what the card offers:
//
// * The arena does not fit in shared memory (0.4-1.8 MB per image on
//   AlexNet), so it lives in one device buffer the launcher allocates per
//   call, every image's slots side by side; the card's 50 MB L2 holds a
//   batch-8 arena (3.0-14.6 MB), so a node's output is read back by the
//   next node from L2 rather than from memory.
// * One persistent cooperative launch: the grid is as many CTAs as can be
//   co-resident, capped by the largest node's work, and
//   cooperative_groups' grid sync separates the phases. A node's phase
//   first zeroes its output slot (the slot's halo and unwritten channels
//   must read as the zeros the per-layer path pads with), syncs, then
//   computes; the next node starts after another sync, since it reads
//   halo rows that other CTAs wrote. The launch is refused, never split
//   into per-node launches, when the card cannot co-schedule the grid.
// * Inside a phase, CTAs take K1's work items with a grid-stride loop:
//   (tile x output block, 64-channel tile within a group, image) for the
//   gemm body, one output element per thread for the depthwise body. The
//   bodies are K1's own (wave_replay_body.cuh), so with the same split
//   and reduction order every node is bit-identical to K1 launched on it.
// * The TPU's batch_block is a VMEM budget; images never interact, so
//   every phase runs all images.
// * Arithmetic is IEEE fp32 FFMA, no TF32, as in K1.
#include <cooperative_groups.h>

#include "wave_replay_body.cuh"

// Must match graph.py::NODE_FIELDS field for field. in_off, out_off and
// res_off are element offsets into the arena, or -1: the chain input x
// (windowed by the table's IY/IX/C0), the chain output, no residual.
struct Node {
  Geom g;
  int in_off, in_dy, in_dx, in_ystep, in_xstep, in_cstep;
  int out_off;
  View ov;
  int res_off;
  View rv;
  int step0, boff, items, zero_elems;
};

// The chain input staged into its arena slot (off = -1: not staged): the
// slot's per-image extent and the input's origin inside it.
struct Stage {
  int off, h, w, c, dy, dx;
};

namespace {

namespace cg = cooperative_groups;
using namespace wr;

constexpr int kCols = 14;          // core/schedule.py GRAPH_OP_COLS
constexpr int kK = 9, kWOFF = 10;  // GOP_K, GOP_WOFF

// A chain step's window and weight chunk from the graph table: the head
// node windows the chain input by the table's origins; later nodes read
// their producer's slot at the value's pad, tile by tile.
struct GraphSteps {
  const int* rows;   // the node's rows, tile-major, chain innermost
  const float* wf;
  int n_chain, windowed, dy, dx, ystep, xstep, cstep;
  __device__ StepIn at(int step, int t) const {
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
graph_replay(const Node* __restrict__ nodes, int n_nodes, Stage st,
             int x_h, int x_w, int x_c, const float* __restrict__ x,
             const float* __restrict__ wf, const float* __restrict__ bf,
             const int* __restrict__ table, float* __restrict__ arena,
             float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Node nd;
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
              : 0.f;
    }
    grid.sync();
  }

  for (int ni = 0; ni < n_nodes; ++ni) {
    __syncthreads();               // every thread is done with nd
    if (threadIdx.x == 0) nd = nodes[ni];
    __syncthreads();
    float* o = out;
    if (nd.out_off >= 0) {
      o = arena + nd.out_off;
      for (long e = gtid; e < nd.zero_elems; e += nthreads) o[e] = 0.f;
      grid.sync();                 // zeros land before any block does
    }
    const GraphSteps steps{table + nd.step0 * kCols, wf, nd.g.n_chain,
                           nd.in_off < 0, nd.in_dy, nd.in_dx,
                           nd.in_ystep, nd.in_xstep, nd.in_cstep};
    const float* xin = nd.in_off < 0 ? x : arena + nd.in_off;
    const float* res = nd.res_off < 0 ? nullptr : arena + nd.res_off;
    const float* bias = bf + nd.boff;
    if (nd.g.depthwise) {
      const long total = static_cast<long>(nd.g.batch) * nd.g.n_tiles *
                         nd.g.blk_h * nd.g.blk_w * nd.g.out_c;
      for (long e = gtid; e < total; e += nthreads)
        direct_elem(nd.g, steps, e, xin, bias, res, nd.rv, o, nd.ov);
    } else {
      const int nx = nd.g.n_tiles * nd.g.blocks_h * nd.g.blocks_w;
      const int ny = nd.g.groups * nd.g.ch_tiles;
      for (int item = blockIdx.x; item < nd.items; item += gridDim.x) {
        gemm_block(nd.g, steps, item % nx, (item / nx) % ny, item / (nx * ny),
                   xin, bias, res, nd.rv, o, nd.ov);
        __syncthreads();           // the pool stage is reused next item
      }
    }
    if (ni + 1 < n_nodes) grid.sync();   // the next node reads this one
  }
}

}  // namespace

// CTAs of graph_replay that fit on one SM of the current device, or a
// negative cudaError_t.
extern "C" int wave_replay_graph_f32_occupancy() {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, graph_replay, kThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// Launches one fused chain as one cooperative kernel of `grid` CTAs on
// `stream`; returns the cudaError_t of the launch (0 on success). `nodes`
// is a device array of n_nodes descriptors.
extern "C" int wave_replay_graph_f32(const Node* nodes, int n_nodes,
                                     const Stage* st, int x_h, int x_w,
                                     int x_c, const float* x,
                                     const float* wf, const float* bf,
                                     const int* table, float* arena,
                                     float* out, int grid, void* stream) {
  Stage stage = *st;
  void* args[] = {&nodes, &n_nodes, &stage, &x_h, &x_w, &x_c, &x,
                  &wf,    &bf,      &table, &arena, &out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(graph_replay), dim3(grid), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
