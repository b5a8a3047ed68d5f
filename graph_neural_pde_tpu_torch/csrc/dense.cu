// The node projections and the first pass of the dKw / dKb reduction
// (dense.cuh) as entry points of their own: kernels/dense.py's
// node_project and outer_reduce call them alone, on the operands the fused
// entry points hand them (see dense.cuh for what they replace and what
// bounds them). The fused entry points run the same device code through
// launch_tables and launch_outer_reduce.

#include "dense.cuh"

// qtab [n_rows, att] float32 and ktab [n_rows, att] (bfloat16 beside a
// bfloat16 column table) from x and xcol as the TABLES code says (0: xcol
// ignored; 1: x float32, xcol bfloat16; 2: x bfloat16 and xcol is x); kw
// and kb come rounded to bfloat16 with a bfloat16 column table.
extern "C" int gnpde_node_tables(const void* x, const void* xcol,
                                 const void* qw, const void* qb,
                                 const void* kw, const void* kb, void* qtab,
                                 void* ktab, int n_rows, int dim, int att,
                                 int tables, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_tables(tables, x, tables == kTablesF32 ? x : xcol,
                                  qw, qb, kw, kb, qtab, ktab, n_rows, dim,
                                  att, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out [n_rows, att] float32 = x W + b for x [n_rows, dim] of type dtype (0
// float32, 1 bfloat16), w [dim, att] and b [att]: one table on
// node_tables' tiles (the q of the per-edge payload kernels).
extern "C" int gnpde_dense_project(const void* x, const void* w,
                                   const void* b, void* out, int n_rows,
                                   int dim, int att, int dtype,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  ProjLaunch p = {};
  p.x = x;
  p.n_rows = n_rows;
  p.dim = dim;
  p.att = att;
  p.t0 = proj_table(w, b, out, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_project<float>(p, 1, s)
                               : launch_project<__nv_bfloat16>(p, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// partials [blocks, dim + 1, att]: block p's sums over its contiguous
// range of rows r of [x[idx[r]] | 1]^T dk[r] (idx nullable: x[r]), every
// element written; x of type dtype (0 float32, 1 bfloat16).
extern "C" int gnpde_outer_reduce(const void* x, const void* idx,
                                  const void* dk, void* partials, int rows,
                                  int dim, int att, int blocks, int dtype,
                                  void* stream) {
  if (blocks < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* b = static_cast<const float*>(dk);
  float* out = static_cast<float*>(partials);
  if (dtype == 0)
    launch_outer_reduce(static_cast<const float*>(x), ix, b, out, rows,
                        blocks, dim, att, s);
  else
    launch_outer_reduce(static_cast<const __nv_bfloat16*>(x), ix, b, out,
                        rows, blocks, dim, att, s);
  return static_cast<int>(cudaGetLastError());
}
