// K6 fused_rhs_fwd and K7 fused_rowmax: one evaluation of the GRAND-nl
// attention right-hand side over a row-sorted CSR graph, and its per-row
// score maxima (the shifts of the exact softmax). Replace the TPU kernels
// of graph_neural_pde_tpu/ops/pallas/fused_rhs.py _rhs_kernel_ax /
// _fused_ax_call (K6) and _rowmax_kernel / fused_rowmax (K7). The formulas,
// the node tables and the bfloat16 modes are those of fused_rhs.cu's note;
// the backward passes K8, K9 and K17 live there. K6's and K7's many
// template instances (tiles, score classes, head groups, table types) sit
// in a source of their own, so that nvcc builds them beside fused_rhs.cu's.
//
// K6 is the forward walk of fused_common.cuh (fwd_walk_piece: one warp a
// row piece, rows in registers, the heads scored on all 32 lanes, K6's
// numerators in registers, multi-piece rows merged in piece order) with the
// softmax over rows: its outputs are ax (or the folded alpha (ax - x) with
// its per-row guard), den and, when a gradient is wanted, the per-head
// numerators num; the exact mode subtracts per-edge shifts.
//
// K7 keeps a warp a row (its walk reads only q_n and k_c: ATT floats an
// edge) but scores each edge through the same fwd_score as K6, over the
// same q and k tables, so that its row maxima are maxima of the very
// scores K6 shifts: each row's largest shifted score is exactly 0.

#include "fused_common.cuh"

namespace {

// ----------------------------------------------------------------------- K6

template <typename TC, int KD, int KA, bool kNormed, int KH>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  fwd_min_blocks(KA, KH, sizeof(TC)))
    fused_rhs_fwd_kernel(Pieces pc, Proj p, FwdIO io,
                         const TC* __restrict__ xcol,
                         const float* __restrict__ qtab,
                         const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  fwd_walk_piece<false, TC, KD, KA, kNormed, KH>(smem, pc, p, io, xcol, qtab,
                                                ktab);
}

template <int KD>
__global__ void fused_rhs_fwd_merge_kernel(Pieces pc, Proj p, FwdIO io) {
  fwd_merge_rows<false, KD>(pc, p, io);
}

struct FwdRows {
  static constexpr bool kColumnNorm = false;
  template <typename TC, int KD, int KA, bool kNormed, int KH>
  static auto walk() { return fused_rhs_fwd_kernel<TC, KD, KA, kNormed, KH>; }
  template <int KD>
  static auto merge() { return fused_rhs_fwd_merge_kernel<KD>; }
};

// ----------------------------------------------------------------------- K7

template <typename TC, int KA>
__global__ void fused_rowmax_kernel(Graph g, Proj p,
                                    const float* __restrict__ qtab,
                                    const TC* __restrict__ ktab,
                                    float* __restrict__ smax) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= g.n_rows) return;                    // whole warp leaves together
  const int A = p.att, H = p.heads;
  float* buf = smem + static_cast<size_t>(warp) * A;
  const LaneHeads<KA> h = make_heads<KA>(p, lane);
  const HeadLane hl = head_lane(p, h.d_k, lane);
  const ScoreConsts skc = score_consts(score_params(p), h.d_k);
  float qn[KA];
#pragma unroll
  for (int j = 0; j < KA; ++j)
    qn[j] = bit(h.valid, j)
                ? __ldg(qtab + static_cast<size_t>(n) * A + kWarp * j + lane)
                : 0.0f;
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  float m = -CUDART_INF_F;                      // lane h: head h
  for (int e = start; e < end; ++e) {
    const int c = __ldg(g.col + e);
    float kc[KA];
#pragma unroll
    for (int j = 0; j < KA; ++j)
      kc[j] = bit(h.valid, j)
                  ? widen(ktab[static_cast<size_t>(c) * A + kWarp * j + lane])
                  : 0.0f;
    m = fmaxf(m, fwd_score<KA, false>(h, hl, p, skc, qn, kc, buf, lane));
  }
  if (lane < H)
    smax[static_cast<size_t>(n) * H + lane] = isfinite(m) ? m : 0.0f;
}

// K7 over the q table and the k table of type TC (see launch_tables), by
// the kernel whose tiles cover att
template <typename TC, int KA>
cudaError_t launch_rowmax_k(Graph g, Proj p, const void* qtab,
                            const void* ktab, void* smax, cudaStream_t s) {
  const size_t bytes = sizeof(float) * kWarpsPerBlock * p.att;
  cudaError_t err = allow_shared(fused_rowmax_kernel<TC, KA>, bytes);
  if (err != cudaSuccess) return err;
  fused_rowmax_kernel<TC, KA><<<row_blocks(g.n_rows), kWarpsPerBlock * kWarp,
                                bytes, s>>>(
      g, p, static_cast<const float*>(qtab), static_cast<const TC*>(ktab),
      static_cast<float*>(smax));
  return cudaGetLastError();
}

template <typename TC>
cudaError_t launch_rowmax(Graph g, Proj p, const void* qtab,
                          const void* ktab, void* smax, cudaStream_t s) {
  if (p.att <= 32) return launch_rowmax_k<TC, 1>(g, p, qtab, ktab, smax, s);
  if (p.att <= 64) return launch_rowmax_k<TC, 2>(g, p, qtab, ktab, smax, s);
  if (p.att <= 128) return launch_rowmax_k<TC, 4>(g, p, qtab, ktab, smax, s);
  return launch_rowmax_k<TC, 8>(g, p, qtab, ktab, smax, s);
}

}  // namespace

// The entry points first fill the scratch tables qtab and ktab [n_rows,
// att] (q = x Qw + qb, k = x Kw + kb), then walk the rows. flags: bits 0-2
// the score family, bit 3 squareplus. var and ls hold one element for
// exp_kernel and two (features, positions) for exp_kernel_beltrami, whose
// att is the packed width of both halves. `tables` (kTablesF32,
// kTablesF32Bf16, kTablesBf16: see launch_tables) and the column table
// xcol, ignored with kTablesF32; with a bfloat16 column table, ktab holds
// bfloat16 values and kw, kb are the bf16-rounded projection.

// K6 over the row pieces piece_ptr, piece_row, piece_slot [n_pieces] and
// multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py, ColPieces of rowptr:
// Graph.row_pieces) and the CSR columns col. shifts [E, heads]: the exact
// mode's per-edge score shifts; alpha [1]: out is then alpha (ax - x), NaN
// on the rows whose den under- or overflowed; num [n_rows, heads * dim]:
// the per-head numerators. part [multi_ptr[n_multi], heads * (dim + 1)]
// holds the pieces' partial sums (nullable without multi-piece rows). vec:
// dim % 4 == 0 and x, xcol, out, num 16-byte aligned. Nullable: var, ls,
// shifts, alpha, num.
extern "C" int gnpde_fused_rhs_fwd(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* shifts, const void* alpha, void* qtab,
    void* ktab, void* out, void* den, void* num, void* part, int n_rows,
    int n_pieces, int n_multi, int dim, int att, int heads, int flags,
    int vec, int tables, void* stream) {
  FwdIO io = {};
  io.col = static_cast<const int*>(col);
  io.shifts = static_cast<const float*>(shifts);
  io.alpha = static_cast<const float*>(alpha);
  io.out = static_cast<float*>(out);
  io.den = static_cast<float*>(den);
  io.num = static_cast<float*>(num);
  io.part = static_cast<float*>(part);
  io.vec = vec;
  return launch_forward<FwdRows>(
      1, tables, piece_ptr, piece_row, piece_slot, multi_row, multi_ptr, x,
      xcol, qw, qb, kw, kb, qtab, ktab,
      make_proj(gmax, var, ls, dim, att, heads, flags), io, n_rows, n_pieces,
      n_multi, stream);
}

extern "C" int gnpde_fused_rowmax(const void* rowptr, const void* col,
                                  const void* x, const void* xcol,
                                  const void* qw, const void* qb,
                                  const void* kw, const void* kb, void* qtab,
                                  void* ktab, void* smax, int n_rows, int dim,
                                  int att, int heads, int tables,
                                  void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_tables(tables, x, xcol, qw, qb, kw, kb, qtab,
                                    ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Graph g = make_graph(rowptr, col, n_rows);
    const Proj p = make_proj(nullptr, nullptr, nullptr, dim, att,
                             heads, kScaledDot);
    err = tables == kTablesF32
              ? launch_rowmax<float>(g, p, qtab, ktab, smax, s)
              : launch_rowmax<__nv_bfloat16>(g, p, qtab, ktab, smax, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
