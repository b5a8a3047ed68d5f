// K12 norm1_den, K13 norm1_fwd, K14 norm1_bwd: the GRAND-nl attention
// right-hand side with the softmax normalised over COLUMNS
// (attention_norm_idx = 1), over a row-sorted CSR graph whose edge multiset
// is symmetric.
//
// Replace the TPU kernels of graph_neural_pde_tpu/ops/pallas/fused_rhs.py:
// _norm1_rev_kernel / _norm1_rev_call (K12, both of its modes; its kernel
// is norm1_den.cu),
// _norm1_fwd_kernel / _norm1_fwd_call (K13) and _norm1_bwd_kernel /
// _norm1_bwd_call (K14). Those ride a stripe plan of padded edge chunks,
// pack x as bf16 pairs with 1/den in the same 128-lane gather row, permute
// every node-side operand to the pairs' decode order and do each gather and
// sum as a one-hot matmul. None of that is carried over: a gather is cheap
// here, so these kernels take any state width and head count that fit a
// block's shared memory, and read 1/den and den's cotangent as plain
// [N, H] float32 node tables.
//
// The JAX package runs P14-P16 only under its bfloat16 payload
// (rhs_payload_dtype="bfloat16"). K12-K14 take it as K6-K9 do (see
// fused_rhs.cu): beside the row side x (float32, or bfloat16 under the
// bf16 ODE state), which gives q, a bfloat16 column table xcol gives the
// gathered values and the bfloat16 k table. The mirror trick needs K12 to
// score each reverse edge exactly as K13 scores it, so both read the same
// tables: q from the row side at the gathered node, k from the column side
// at the resident one (never the other way round, or den stops being the
// mass of K13's scores and the attention is no longer column-stochastic).
// K12's weight ct[c] . x[n] reads x[n] from the column table, the value
// the forward aggregated. Every cotangent, sum and output stays float32,
// and K14 reduces dKw over the column table. One template serves both
// modes (TC the column table's type); the sums keep their fixed order.
//
// For an edge e = (r, c): s_eh = score_h(q[r], k[c]), u_eh = exp(s_eh - gmax)
// (or squareplus), and
//     den[n, h] = sum over edges INTO n (col_e = n) of u_eh,
//     ax[r]     = 1/H sum_h sum over row r's edges of u_eh / den[c, h] x[c].
// The aggregation reduces by row while the softmax groups by column, so the
// denominators do not fall out of the aggregation's row walk. On a symmetric
// edge multiset they still come from a row walk: the edges into n are the
// reverses of row n's edges (n, c), so row n scores S(q[c], k[n]), q from
// the gathered node and k from the resident one. K12 does that (and, given
// the output's cotangent ct, weights each term by ct[c] . x[n], which is
// the numerator of den's cotangent). It needs rowptr and col only, no
// reverse-edge map.
//
// What bounds them on the H100: the gathers, as for K6-K9, and the latency
// of the chain behind each. K12 reads q[c] (ATT floats) per edge, with ct
// also ct[c] (D floats); K13 x[c], k[c] and 1/den[c]; K14 x[c], ct[c], q[c], k[c], 1/den[c] and den's cotangent at c.
// The arithmetic per edge is 2 ATT flop per score and 2 D per dot product
// or accumulation.
//
// Design. Like K6-K9 an entry point first projects every node once into
// the scratch tables q and k (node_project_kernel), unless its caller hands
// it tables that an earlier launch on the same inputs filled (K12 then K13
// in the forward, K12 then K14 in the backward: project = 0 in the second);
// one warp owns one row piece, and nothing is atomic: two launches agree
// bit for bit.
// * K12 (norm1_den.cu, a source of its own): K13's walk with the roles of
//   the rows swapped, k[n] (and x[n]) resident and q[c] (and ct[c])
//   gathered, every head scored on all lanes by the same fwd_score, so
//   that each edge's u is bit for bit the u K13 forms for its reverse.
// * K13: K6's walk (fwd_walk_piece in fused_common.cuh, which replaces
//   P15 _norm1_fwd_kernel here as it replaces P7 for K6) over columns: an
//   edge reads 1/den[c, h] with its rows, its weight 1/H sum_h u_eh /
//   den[c, h] is one butterfly over the head lanes, and the row keeps one
//   D-wide sum in registers, no per-head numerators. It walks row pieces
//   and merges multi-piece rows as K6 does.
// * K14: K9's walk (sym_backward_piece in fused_common.cuh, which replaces
//   P16 _norm1_bwd_kernel here as it replaces P13 for K9) with the softmax
//   groups swapped: the edge (n, c) reads 1/den and den's cotangent at its
//   column c, its reverse (c, n) at the resident row n. What bounds it is
//   K9's: the latency of six gathers an edge and the chain behind them
//   (the first version waited on six round trips in series and scored on
//   H lanes); the walk now keeps the rows in registers, loads an edge's
//   rows together, scores every head on all lanes and cuts rows into
//   pieces (see fused_common.cuh). dKw, dKb, dgmax and the exp_kernel
//   scalars go through the same two-pass reduction as K9's.

#include "fused_common.cuh"

namespace {

// ---------------------------------------------------------------------- K13

// K13: the forward walk of fused_common.cuh (fwd_walk_piece) over columns,
// and its merge of multi-piece rows
template <typename TC, int KD, int KA, bool kNormed, int KH>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  fwd_min_blocks(KA, KH, sizeof(TC)))
    norm1_fwd_kernel(Pieces pc, Proj p, FwdIO io,
                     const TC* __restrict__ xcol,
                     const float* __restrict__ qtab,
                     const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  fwd_walk_piece<true, TC, KD, KA, kNormed, KH>(smem, pc, p, io, xcol, qtab,
                                               ktab);
}

template <int KD>
__global__ void norm1_fwd_merge_kernel(Pieces pc, Proj p, FwdIO io) {
  fwd_merge_rows<true, KD>(pc, p, io);
}

struct FwdColumns {
  static constexpr bool kColumnNorm = true;
  template <typename TC, int KD, int KA, bool kNormed, int KH>
  static auto walk() { return norm1_fwd_kernel<TC, KD, KA, kNormed, KH>; }
  template <int KD>
  static auto merge() { return norm1_fwd_merge_kernel<KD>; }
};

// ---------------------------------------------------------------------- K14

// K14: the symmetric walk of fused_common.cuh (sym_backward_piece) with
// the softmax groups swapped, and its merge of multi-piece rows
template <typename TC, int KD, int KA, bool kNormed>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  sym_min_blocks(KA))
    norm1_bwd_kernel(Pieces pc, Proj p, SymIO io,
                     const TC* __restrict__ xcol,
                     const float* __restrict__ qtab,
                     const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  sym_backward_piece<true, TC, KD, KA, kNormed>(smem, pc, p, io, xcol, qtab,
                                               ktab);
}

template <int KD, int KA>
__global__ void norm1_bwd_merge_kernel(Pieces pc, Proj p, SymIO io) {
  sym_merge_rows<KD, KA>(pc, p, io);
}

struct SymColumns {
  template <typename TC, int KD, int KA, bool kNormed>
  static auto walk() { return norm1_bwd_kernel<TC, KD, KA, kNormed>; }
  template <int KD, int KA>
  static auto merge() { return norm1_bwd_merge_kernel<KD, KA>; }
};

}  // namespace

// With project != 0 an entry point first fills the scratch tables qtab and
// ktab [n_rows, att] (q = x Qw + qb from the row side x, k = xcol Kw + kb
// from the column table); with project == 0 it reads them as an earlier
// launch on the same operands left them. Then it walks the rows. flags:
// bits 0-2 the score family, bit 3 squareplus; var and ls as
// gnpde_fused_rhs_fwd's. `tables` as K6-K9 take it (kTablesF32: xcol is
// ignored and x is the column table; kTablesF32Bf16, kTablesBf16: the
// bfloat16 column table xcol beside a float32 or bfloat16 x, its k table
// bfloat16, kw and kb the bf16-rounded projection).

// K13 over the row pieces (as gnpde_fused_rhs_fwd takes them): out
// [n_rows, dim] = ax from recip [n_rows, heads] = 1 / (den + 1e-16); part
// [multi_ptr[n_multi], dim] holds the pieces' partial sums (nullable
// without multi-piece rows); vec: dim % 4 == 0 and x, xcol, out 16-byte
// aligned. Nullable: var, ls.
extern "C" int gnpde_norm1_fwd(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* recip, void* qtab, void* ktab, void* out,
    void* part, int n_rows, int n_pieces, int n_multi, int dim, int att,
    int heads, int flags, int vec, int project, int tables, void* stream) {
  FwdIO io = {};
  io.col = static_cast<const int*>(col);
  io.recip = static_cast<const float*>(recip);
  io.out = static_cast<float*>(out);
  io.part = static_cast<float*>(part);
  io.vec = vec;
  return launch_forward<FwdColumns>(
      project, tables, piece_ptr, piece_row, piece_slot, multi_row,
      multi_ptr, x, xcol, qw, qb, kw, kb, qtab, ktab,
      make_proj(gmax, var, ls, dim, att, heads, flags), io, n_rows, n_pieces,
      n_multi, stream);
}

// K14: rc [n_rows, heads, 2] holds each node's (recip_p, ct_den) per head,
// recip_p = 1 / (H (den + 1e-16)); kw_t is Kw^T [att, dim] (of the
// bf16-rounded Kw with a bfloat16 column table); dKw is reduced over the
// column table; the other arguments as gnpde_fused_rhs_bwd_sym's.
// Nullable: var, ls.
extern "C" int gnpde_norm1_bwd(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* ct_ax, const void* rc, const void* kw_t,
    void* qtab, void* ktab, void* dq, void* dxrow, void* dkn, void* row_sums,
    void* part, void* partials, int n_rows, int n_pieces, int n_multi,
    int dim, int att, int heads, int flags, int reduce_blocks, int vec,
    int project, int tables, void* stream) {
  return launch_sym_backward<SymColumns>(
      project, tables, piece_ptr, piece_row, piece_slot, multi_row, multi_ptr,
      col, x, xcol, qw, qb, kw, kb, gmax, var, ls, ct_ax, rc, kw_t, qtab,
      ktab, dq, dxrow, dkn, row_sums, part, partials, n_rows, n_pieces,
      n_multi, dim, att, heads, flags, reduce_blocks, vec, stream);
}
