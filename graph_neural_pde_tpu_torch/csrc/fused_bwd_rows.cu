// K8 fused_rhs_bwd without its per-edge dxg: the row side of the
// column-plan backward of the GRAND-nl attention right-hand side
// (make_fused_ax_colplan), over a row-sorted CSR graph, directed or not.
// Replaces the TPU kernel _bwd_kernel / _fused_bwd_mega_call of
// graph_neural_pde_tpu/ops/pallas/fused_rhs.py with want_dxg=False. The
// walk over row pieces, its merge and what bounds them are
// fused_bwd_rows.cuh's (kEdges false here); K8's mode with dxg, the exact
// re-solve's, is fused_bwd_edges.cu, and K17, which forms x's gradient
// and dKw, dKb over the CSC view, reads the q and k tables this launch
// fills.

#include "fused_bwd_rows.cuh"

namespace {

template <typename TC, int KD, int KA, bool kNormed>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  rows_min_blocks(KA))
    fused_rhs_bwd_rows_kernel(Pieces pc, Proj p, RowsIO io,
                              const TC* __restrict__ xcol,
                              const float* __restrict__ qtab,
                              const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  rows_walk_piece<TC, KD, KA, kNormed, false>(smem, pc, p, io, xcol, qtab,
                                              ktab);
}

__global__ void fused_rhs_bwd_rows_merge_kernel(Pieces pc, Proj p,
                                                RowsIO io) {
  rows_merge(pc, p, io);
}

struct RowsWalk {
  template <typename TC, int KD, int KA, bool kNormed>
  static auto walk() { return fused_rhs_bwd_rows_kernel<TC, KD, KA, kNormed>; }
  static auto merge() { return fused_rhs_bwd_rows_merge_kernel; }
};

}  // namespace

// K8 without dxg over the row pieces piece_ptr, piece_row, piece_slot
// [n_pieces] and multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py,
// ColPieces of rowptr: Graph.row_pieces) and the CSR columns col. With
// project != 0 it first fills the scratch tables qtab and ktab [n_rows,
// att] (q = x Qw + qb from the row side x, k from the column table); with
// project == 0 it reads them as an earlier launch on the same operands
// left them. shifts [E, heads]: per-edge score shifts; recip_p, ct_den
// [n_rows, heads]; dq [n_rows, att]; row_sums [n_rows, 5] is scratch the
// wrapper reduces; part [multi_ptr[n_multi], att + 5] holds the pieces'
// partial sums (nullable without multi-piece rows). vec: dim % 4 == 0 and
// xcol (x with kTablesF32) and ct_ax 16-byte aligned. flags, var, ls and
// `tables` as gnpde_fused_rhs_bwd takes them. Nullable: var, ls, shifts.
extern "C" int gnpde_fused_rhs_bwd_rows(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* shifts, const void* ct_ax,
    const void* recip_p, const void* ct_den, void* qtab, void* ktab,
    void* dq, void* row_sums, void* part, int n_rows, int n_pieces,
    int n_multi, int dim, int att, int heads, int flags, int vec,
    int project, int tables, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
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
    io.vec = vec;
    const cudaError_t err = launch_rows_walk<RowsWalk>(
        project, tables, pc, p, io, x, xcol, qw, qb, kw, kb, qtab, ktab,
        n_rows, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
