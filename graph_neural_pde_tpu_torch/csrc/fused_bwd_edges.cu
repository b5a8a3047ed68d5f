// K8 fused_rhs_bwd with its per-edge dxg: the backward of the exact
// re-solve of the GRAND-nl attention right-hand side (K6 with K7's row
// maxima as per-edge shifts), over a row-sorted CSR graph, directed or
// not. Replaces the TPU kernel _bwd_kernel / _fused_bwd_mega_call of
// graph_neural_pde_tpu/ops/pallas/fused_rhs.py in its separable mode with
// dxg. The formulas, the node tables and the bfloat16 column table are
// those of fused_rhs.cu's note; per edge e = (n, c)
//     dxg[e] = w_e ct_ax[n] + dk_e Kw^T,   w_e = sum_h u_eh recip_p[n, h],
//     dKw = sum_e x_c^T dk_e,              dKb = sum_e dk_e.
//
// What bounds it on the H100: the bytes of its per-edge outputs and their
// product by Kw^T. dxg alone is E D floats (1.26 GB at arxiv scale), dk_e
// E ATT, and dk_e Kw^T is E D ATT products (20 GFLOP at arxiv scale,
// 0.3 ms on the float32 FMA pipes at their peak). The first version gave
// one warp a whole row, copied each edge's x_c and k_c into shared memory
// between __syncwarps, scored on H of 32 lanes and formed dk_e Kw^T per
// edge with SIMT FMAs: 8.66 ms at arxiv scale against a bound of 0.67
// (PERF.md, section 6), slower than its plain version on four shapes.
//
// Design: three passes, none of them a warp a whole row.
// * The walk (fused_rhs_bwd_edges_kernel: fused_bwd_rows.cuh's walk with
//   kEdges): row pieces of at most COL_PIECE edges in K9's lane layout,
//   heads scored on all lanes, the exact mode's shifts loaded with the
//   edge; it writes dq, the row sums (merged in piece order for
//   multi-piece rows) and each edge's dk_e and w_e.
// * The dxg pass (edge_project_kernel): dxg = dk Kw^T on the tensor cores
//   as 3xTF32 mma.sync, the node projections' tile (dense.cuh,
//   project_mma, with the edges as its rows, ATT its depth and Kw^T
//   resident in shared memory in groups of 64 columns of D): two k8 steps
//   a partial sum, then float32 adds. Its epilogue adds w_e ct_ax[row_e]
//   (rows are sorted, so a tile's edges read few rows of ct_ax) and writes
//   every slot of dxg, the padding past the valid edges as zeros, so no
//   scratch is zeroed; it also zeroes dk_e on the padding, which the
//   reduction walks.
// * dKw / dKb: dense.cuh's split-K outer_reduce over the slots, x_c
//   gathered through col.
// No atomics, and every sum has a fixed order: two launches agree bit for
// bit.

#include "fused_bwd_rows.cuh"

namespace {

// the walk with each edge's dk_e and w_e, and its merge
template <typename TC, int KD, int KA, bool kNormed>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  rows_min_blocks(KA))
    fused_rhs_bwd_edges_kernel(Pieces pc, Proj p, RowsIO io,
                               const TC* __restrict__ xcol,
                               const float* __restrict__ qtab,
                               const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  rows_walk_piece<TC, KD, KA, kNormed, true>(smem, pc, p, io, xcol, qtab,
                                             ktab);
}

__global__ void fused_rhs_bwd_edges_merge_kernel(Pieces pc, Proj p,
                                                 RowsIO io) {
  rows_merge(pc, p, io);
}

struct EdgesWalk {
  template <typename TC, int KD, int KA, bool kNormed>
  static auto walk() {
    return fused_rhs_bwd_edges_kernel<TC, KD, KA, kNormed>;
  }
  static auto merge() { return fused_rhs_bwd_edges_merge_kernel; }
};

// dxg[e] = w_e ct_ax[row_e] + (dk_e Kw^T); 0 past the valid edges. A
// lane's row: w_e and row_e read with the tile's first stage, then its NT
// pairs of ct_ax[row_e] loaded together (8-byte loads where `pairs`), each
// added by one fused multiply-add.
struct EdgeStore {
  const int* __restrict__ edge_row;
  const float* __restrict__ w;
  const float* __restrict__ ct_ax;
  int dim, valid, pairs;

  struct Row {
    float w;
    int r;                 // row_e, or -1 past the valid edges
  };

  __device__ __forceinline__ Row row(int e) const {
    if (e >= valid) return {0.0f, -1};
    return {__ldg(w + e), __ldg(edge_row + e)};
  }

  template <int NT>
  __device__ __forceinline__ void apply(const Row& rw, int c0,
                                        float2 (&v)[NT]) const {
    if (rw.r < 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) v[nt] = make_float2(0.0f, 0.0f);
      return;
    }
    const float* ct = ct_ax + static_cast<size_t>(rw.r) * dim;
    float2 t[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = c0 + 8 * nt;
      if (pairs && c + 1 < dim) {
        t[nt] = __ldg(reinterpret_cast<const float2*>(ct + c));
      } else {
        t[nt].x = c < dim ? __ldg(ct + c) : 0.0f;
        t[nt].y = c + 1 < dim ? __ldg(ct + c + 1) : 0.0f;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      v[nt] = make_float2(fmaf(rw.w, t[nt].x, v[nt].x),
                          fmaf(rw.w, t[nt].y, v[nt].y));
  }
};

struct EdgeLaunch {
  const float* dke;        // [slots, att]
  const float* kw_t;       // Kw^T [att, dim]
  const int* row;          // each slot's row (valid slots)
  const int* valid;        // the valid slots' count (rowptr[n_rows])
  const float* w;          // [slots]
  const float* ct_ax;      // [n_rows, dim]
  float* dxg;              // [slots, dim]
  float* dke_pad;          // dke, its padding zeroed
  int slots, dim, att, vec, tasks, step, n_tiles;
};

// Block b takes column group b % tasks of the edge tiles b / tasks, b /
// tasks + step, ... (project_mma); the blocks of group 0 then zero dk_e on
// the padding slots of their tiles (read by the other groups only for
// rows whose outputs are zeros).
__global__ void __launch_bounds__(kDenseThreads, 2)
    edge_project_kernel(EdgeLaunch p) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  const int task = blockIdx.x % p.tasks, tile = blockIdx.x / p.tasks;
  const int valid = __ldg(p.valid);
  MmaTile t;
  t.x = p.dke;
  t.w0 = t.w1 = p.kw_t;
  t.n_rows = p.slots;
  t.dim = p.att;
  t.att = t.cols = p.dim;
  t.vec = p.vec;
  t.c0 = task * kMmaCols;
  const EdgeStore epi = {p.row, p.w, p.ct_ax, p.dim, valid,
                         p.dim % 2 == 0 &&
                             reinterpret_cast<uintptr_t>(p.ct_ax) % 8 == 0};
  project_mma(t, nullptr, nullptr, p.dxg, p.dxg, tile, p.step, p.n_tiles,
              dense_smem, epi);
  if (task != 0) return;
  for (int tt = tile; tt < p.n_tiles; tt += p.step) {
    const int r0 = max(tt * kMmaRows, valid);
    const int r1 = min((tt + 1) * kMmaRows, p.slots);
    for (size_t i = static_cast<size_t>(r0) * p.att + threadIdx.x;
         i < static_cast<size_t>(r1) * p.att; i += kDenseThreads)
      p.dke_pad[i] = 0.0f;
  }
}

// The dxg pass: tasks = column groups of kMmaCols, tiles of kMmaRows
// slots, each group's Kw^T resident in `step` blocks that walk the tiles
// (two blocks an SM where they fit), as launch_project runs the float32
// node tables.
cudaError_t launch_edge_project(EdgeLaunch p, cudaStream_t s) {
  p.vec = p.att % 4 == 0 && p.dim % 4 == 0 && aligned16(p.dke) &&
          aligned16(p.kw_t) && aligned16(p.dxg);
  p.tasks = (p.dim + kMmaCols - 1) / kMmaCols;
  p.n_tiles = (p.slots + kMmaRows - 1) / kMmaRows;
  const int ksteps = (p.att + kProjDepth - 1) / kProjDepth;
  const size_t bytes = sizeof(float) * (ksteps * kProjDepth * kMmaW +
                                        kProjStages * kMmaRows * kMmaX);
  const int per_sm = 2 * (bytes + 1024) <= 228 * 1024 ? 2 : 1;
  p.step = min(p.n_tiles,
               (per_sm * dense_sms() + p.tasks - 1) / p.tasks);
  cudaError_t err = allow_shared(edge_project_kernel, bytes);
  if (err != cudaSuccess) return err;
  edge_project_kernel<<<p.step * p.tasks, kDenseThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K8 with dxg over the row pieces piece_ptr, piece_row, piece_slot
// [n_pieces] and multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py,
// ColPieces of rowptr: Graph.row_pieces), each slot's row and column (row,
// col [n_slots], the valid ones rowptr[n_rows] = piece_ptr[n_pieces]
// first). It fills the scratch tables qtab and ktab [n_rows, att] first.
// flags: bits 0-2 the score family, bit 3 squareplus; var and ls hold one
// element for exp_kernel and two (features, positions) for
// exp_kernel_beltrami, whose att is the packed width of both halves;
// `tables` (kTablesF32, kTablesF32Bf16, kTablesBf16: see launch_tables)
// and the column table xcol, ignored with kTablesF32; with a bfloat16
// column table, ktab holds bfloat16 values and kw, kb are the
// bf16-rounded projection. shifts [n_slots, heads]: per-edge score
// shifts; recip_p, ct_den [n_rows, heads]; kw_t is Kw^T [att, dim] (of the
// bf16-rounded Kw with a bfloat16 column table: the k table's
// derivative). Outputs: dq [n_rows, att]; dxg [n_slots, dim], written
// whole; dke [n_slots, att] and w [n_slots] (each edge's dk_e and w_e),
// row_sums [n_rows, 5] and part [multi_ptr[n_multi], att + 5] (the
// pieces' partial sums; nullable without multi-piece rows) are scratch;
// partials [reduce_blocks, dim + 1, att] are written whole (dense.cuh's
// outer_reduce_kernel over the slots, x_c gathered through col), and dKw
// is reduced over the column table. vec: dim % 4 == 0 and xcol (x with
// kTablesF32) and ct_ax 16-byte aligned. Nullable: var, ls, shifts.
extern "C" int gnpde_fused_rhs_bwd(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* row,
    const void* col, const void* x, const void* xcol, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* shifts, const void* ct_ax,
    const void* recip_p, const void* ct_den, const void* kw_t, void* qtab,
    void* ktab, void* dq, void* dxg, void* dke, void* w, void* row_sums,
    void* part, void* partials, int n_rows, int n_pieces, int n_multi,
    int dim, int att, int heads, int flags, int n_slots, int reduce_blocks,
    int vec, int tables, void* stream) {
  if (!valid_tables(tables) || dxg == nullptr || dke == nullptr ||
      w == nullptr || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Pieces pc = make_pieces(piece_ptr, piece_row, piece_slot,
                                  multi_row, multi_ptr, n_pieces, n_multi);
    const Proj p = make_proj(gmax, var, ls, dim, att, heads, flags);
    RowsIO io = {};
    io.col = static_cast<const int*>(col);
    io.ct_ax = static_cast<const float*>(ct_ax);
    io.recip_p = static_cast<const float*>(recip_p);
    io.ct_den = static_cast<const float*>(ct_den);
    io.shifts = static_cast<const float*>(shifts);
    io.dq = static_cast<float*>(dq);
    io.row_sums = static_cast<float*>(row_sums);
    io.part = static_cast<float*>(part);
    io.dke = static_cast<float*>(dke);
    io.w = static_cast<float*>(w);
    io.vec = vec;
    cudaError_t err = launch_rows_walk<EdgesWalk>(1, tables, pc, p, io, x, xcol,
                                             qw, qb, kw, kb, qtab, ktab,
                                             n_rows, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    EdgeLaunch e = {};
    e.dke = static_cast<const float*>(dke);
    e.kw_t = static_cast<const float*>(kw_t);
    e.row = static_cast<const int*>(row);
    e.valid = static_cast<const int*>(piece_ptr) + n_pieces;
    e.w = static_cast<const float*>(w);
    e.ct_ax = static_cast<const float*>(ct_ax);
    e.dxg = static_cast<float*>(dxg);
    e.dke_pad = static_cast<float*>(dke);
    e.slots = n_slots;
    e.dim = dim;
    e.att = att;
    if (n_slots > 0) err = launch_edge_project(e, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tables == kTablesF32)
      launch_outer_reduce(static_cast<const float*>(x),
                          static_cast<const int*>(col),
                          static_cast<const float*>(dke),
                          static_cast<float*>(partials), n_slots,
                          reduce_blocks, dim, att, s);
    else
      launch_outer_reduce(static_cast<const __nv_bfloat16*>(xcol),
                          static_cast<const int*>(col),
                          static_cast<const float*>(dke),
                          static_cast<float*>(partials), n_slots,
                          reduce_blocks, dim, att, s);
  }
  return static_cast<int>(cudaGetLastError());
}
