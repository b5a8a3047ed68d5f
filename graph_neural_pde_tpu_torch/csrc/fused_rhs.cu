// K9 fused_rhs_bwd_sym, K17 fused_rhs_bwd_col: backward passes of one
// evaluation of the GRAND-nl attention right-hand side over a row-sorted
// CSR graph. Its forward, K6 fused_rhs_fwd, and its per-row score maxima,
// K7 fused_rowmax, are fused_fwd.cu; the general backward, K8
// fused_rhs_bwd, is fused_bwd_rows.cu without its per-edge dxg and
// fused_bwd_edges.cu with it (they share this note and the device code of
// fused_common.cuh); the same over a per-edge payload, K18, K19 and K8's
// per-head mode, is fused_payload.cu.
//
// Replace the TPU kernels of graph_neural_pde_tpu/ops/pallas/fused_rhs.py:
// _rhs_kernel_ax / _fused_ax_call (K6), _rowmax_kernel / fused_rowmax (K7),
// _bwd_kernel / _fused_bwd_mega_call (K8's separable mode), _bwd_sym_kernel
// / _fused_bwd_mega_sym_call (K9) and _bwd_dx_col_kernel / _bwd_dx_col_call
// (K17, the column-plan dx of make_fused_ax_colplan). Those walk a stripe
// plan of padded edge chunks and do every gather, scatter and per-head sum
// as a one-hot or selector matmul, because a TPU core has no fast indexed
// access and runs its grid in order. Neither holds here: these kernels walk
// the CSR rowptr (K6 and K9 its row pieces, K17 the CSC view cut into
// column pieces), gather their node rows themselves and keep every per-row
// sum in the warp that owns the row piece (K17: the column piece), so no
// [E, .] operand is read and, but for K8's per-edge outputs, none is
// written.
//
// For row n with edges e to columns c (see kernels/fused_rhs.py for the
// full formulas):
//     q_n = x_n Qw + qb,  k_e = x_c Kw + kb,  s_eh = score_h(q_n, k_e),
//     u_eh = exp(s_eh - gmax - shift_eh)  (or squareplus),
//     den[n,h] = sum_e u_eh,  ax[n] = 1/H sum_h (sum_e u_eh x_c)/(den+1e-16).
//
// The TPU kernels project k_e = x_c Kw + kb per EDGE (E D ATT products),
// because their operand is the gathered [E, D] payload and a gather of a
// second table costs them as much as the first. Here a gather is cheap and
// the products are not (float32 FMAs outside the tensor cores: the first
// version of these kernels projected per edge and spent 8 ms per
// evaluation at arxiv scale, 23x its bound). So each C entry point first
// runs node_project_kernel, which projects every NODE once into scratch
// tables q and k [N, ATT], and the row walk reads q[n] and gathers k[c]
// beside x[c]. The projections stay this file's own arithmetic; they are
// N D ATT products instead of E D ATT.
//
// What bounds them on the H100 now: the gathers. Per edge a kernel reads
// x[c] (D floats) and k[c] (ATT floats), K9 also ct_ax[c] and q[c], rows
// that mostly come from the 50 MB L2 at Cora's size and from device
// memory at arxiv scale, where the x table alone is 87 MB; the
// arithmetic per edge is 2 ATT + 2 H D flop. K8 with dxg alone still
// multiplies per edge (dxg[e] needs dk_e Kw^T): on the tensor cores, in a
// pass of its own (fused_bwd_edges.cu).
//
// Design: K6, K7, K9 and K8 walk row pieces in registers and score every
// head on all lanes (fwd_walk_piece and sym_backward_piece in
// fused_common.cuh, fused_bwd_rows.cuh, K7 in fused_fwd.cu), four warps a
// block. K17 keeps a warp a column piece (see its note): lane h owns head
// h for the scores and their derivatives (d_k serial terms, so the order
// of every sum is fixed) and lanes span D for the sums, which live with
// the row's q and the edge's x_c and k_c in the warp's slice of dynamic
// shared memory. There are no atomics anywhere.
// Sums over all edges (dKw, dKb, dgmax and the exp_kernel scalars) are
// taken in two passes with a fixed order: K8 writes each edge's dk_e, K9
// each node's dk summed over its reverse edges, K17 each column's dk
// summed over its edges, plus (K8, K9) per-row scalar sums;
// outer_reduce_kernel then forms per-block partial sums of [x_c | 1]^T dk
// over fixed row ranges, and the wrapper adds the partials up in order. Two
// launches on the same inputs therefore agree bit for bit.
//
// K6-K9 and K17 also run on the JAX package's bfloat16 payload
// (rhs_payload_dtype="bfloat16": make_fused_ax_sym, make_fused_ax_colplan,
// fused_rhs_f and the exact re-solve with pay_dt): beside the row side x
// (float32, or bfloat16 under the bf16 ODE state), which gives q, they take
// a bfloat16 column table xcol, which gives the gathered values and the k
// table. The k table is bfloat16 too, rounded as the JAX package's
// composition rounds k_e (the product of the bf16 row with the bf16-rounded
// Kw, then its sum with the bf16-rounded kb, each in bfloat16). So each
// edge gathers D + ATT bf16 values instead of D + ATT floats (K17: each
// column its own row once); q, every cotangent, every sum and every output
// stays float32, and dKw is reduced over the column table. The same
// templates serve both modes (TC the column table's type; K6 reads the row
// side only for its fold, as a float32 or bfloat16 row), and the sums keep
// their fixed order. K7 and K8 build their tables over the same q and k as
// K6, so the exact mode's shifts are the row maxima of the very scores K6
// shifts.

#include "fused_common.cuh"

namespace {

// ---------------------------------------------------------------------- K9

// K9: the symmetric walk of fused_common.cuh (sym_backward_piece) with the
// softmax over rows, and its merge of multi-piece rows
template <typename TC, int KD, int KA, bool kNormed>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  sym_min_blocks(KA))
    fused_rhs_bwd_sym_kernel(Pieces pc, Proj p, SymIO io,
                             const TC* __restrict__ xcol,
                             const float* __restrict__ qtab,
                             const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  sym_backward_piece<false, TC, KD, KA, kNormed>(smem, pc, p, io, xcol,
                                                qtab, ktab);
}

template <int KD, int KA>
__global__ void fused_rhs_bwd_sym_merge_kernel(Pieces pc, Proj p, SymIO io) {
  sym_merge_rows<KD, KA>(pc, p, io);
}

struct SymRows {
  template <typename TC, int KD, int KA, bool kNormed>
  static auto walk() { return fused_rhs_bwd_sym_kernel<TC, KD, KA, kNormed>; }
  template <int KD, int KA>
  static auto merge() { return fused_rhs_bwd_sym_merge_kernel<KD, KA>; }
};

// ---------------------------------------------------------------------- K17
//
// dx[n] = sum over the edges e = (r, n) of column n of
//           (sum_h u_eh recip_p[r, h]) ct_ax[r] + dk_e Kw^T
// with u_eh, ds_eh = ((ct_ax[r] . x_n) recip_p[r, h] + ct_den[r, h]) du/ds
// and dk_e = ds . ds/dk recomputed from q_r and k_n: the x[col] cotangent of
// the row-normalised RHS, which K8 writes per edge. The TPU kernel
// (_bwd_dx_col_kernel) gathers one packed bf16 node table per edge in
// column-plan order and scatters by a one-hot matmul into its node block.
// Here each edge gathers q_r and ct_ax[r] (ATT + D floats) and 2 H scalars
// of its row, beside x_n and k_n read once per walk, and accumulates two
// sums: (sum_h u recip) ct_ax[r] over D and dk_e over ATT. The summed dk is
// multiplied by Kw^T once per column, so the per-edge work is 2 ATT + 4 D +
// O(H d_k) flop and no per-edge product by Kw remains (K8's cost); it is
// also written per column, and dKw / dKb are reduced from it over nodes,
// as K9 does.
//
// What bounds it: the per-edge chain. Each edge waits on two gathered rows
// and then runs H lanes' serial score terms and a head sum, so a walk
// costs its length in series (the first version gave a warp a whole
// column and lasted as long as the graph's largest in-degree: 2.6 ms on a
// kNN graph with hub columns of in-degree 972). The design cuts the walks
// short, so that a hub's edges are spread over many warps and the other
// warps on the SM hide each one's latency:
// * pass 1 (fused_rhs_bwd_col_kernel): one warp per piece of at most
//   COL_PIECE edges of one column (ops/graph.py, column_pieces). A column
//   of one piece is finished there; a piece of a longer column writes its
//   partial sums (D + ATT floats) to its row of the wrapper's scratch;
// * pass 2 (fused_rhs_bwd_col_merge_kernel): one warp per column of
//   several pieces adds its pieces' partials in piece order, multiplies
//   the summed dk by Kw^T and writes dx and the summed dk.
// Each output element is summed in a fixed order (edges within a piece,
// pieces within a column): no atomics, two launches agree bit for bit.

// shared floats of a pass-1 warp: x_n, ct_ax[r], the two sums, (sum dk)
// Kw^T, k_n, q_r and the heads' coefficients
__host__ __device__ constexpr int piece_floats(int dim, int att, int heads) {
  return 4 * dim + 3 * att + kCoef * heads;
}

template <typename TC>
__global__ void fused_rhs_bwd_col_kernel(Graph g, Pieces pc, Proj p,
                                         const TC* __restrict__ xcol,
                                         const float* __restrict__ qtab,
                                         const TC* __restrict__ ktab,
                                         const float* __restrict__ kw_t,
                                         const float* __restrict__ ct_ax,
                                         const float* __restrict__ recip_p,
                                         const float* __restrict__ ct_den,
                                         float* __restrict__ dx,
                                         float* __restrict__ dkn_out,
                                         float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pi = blockIdx.x * kWarpsPerBlock + warp;
  if (pi >= pc.n_pieces) return;                // whole warp leaves together
  const int D = p.dim, A = p.att, H = p.heads, d_k = head_width(p);
  float* xn = smem + static_cast<size_t>(warp) * piece_floats(D, A, H);
  float* cta = xn + D;                          // ct_ax[r]
  float* dxa = cta + D;                         // sum of w_e ct_ax[r]
  float* dkw = dxa + D;                         // (sum of dk) Kw^T
  float* kn = dkw + D;                          // k_n
  float* q = kn + A;                            // q_r
  float* dka = q + A;                           // sum of dk_e
  float* coef = dka + A;                        // [H, kCoef]
  const int n = pc.col[pi], slot = pc.slot[pi];
  const int start = pc.ptr[pi], end = pc.ptr[pi + 1];
  load_row(xcol, n, D, lane, xn);
  load_row(ktab, n, A, lane, kn);
  for (int d = lane; d < D; d += kWarp) dxa[d] = 0.0f;
  for (int a = lane; a < A; a += kWarp) dka[a] = 0.0f;
  const float gmax = *p.gmax;
  const ScoreParams sc = score_params(p);
  for (int j = start; j < end; ++j) {
    const int r = g.col[j];
    load_row(ct_ax, r, D, lane, cta);
    load_row(qtab, r, A, lane, q);
    __syncwarp();
    float part_dot = 0.0f;
    for (int d = lane; d < D; d += kWarp)
      part_dot = fmaf(cta[d], xn[d], part_dot);
    const float dot = warp_sum(part_dot);       // ct_ax[r] . x_n
    float w = 0.0f;
    if (lane < H) {
      const float rg = recip_p[static_cast<size_t>(r) * H + lane];
      const float ctd = ct_den[static_cast<size_t>(r) * H + lane];
      const HeadScore hs = head_score(q, kn, lane, d_k, H, p.score, sc);
      RowSums unused = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      w = rg * head_backward(hs, hs.s - gmax, p.square_plus, dot, rg, ctd,
                             sc, p.score, H, coef + 5 * lane, &unused);
    }
    const float wsum = head_sum(w, H);          // sum_h u_h recip_p[r, h]
    __syncwarp();
    for (int a = lane; a < A; a += kWarp) {
      const float* cf = coef + 5 * (a / d_k);   // a head or its position half
      dka[a] += cf[0] * (q[a] - cf[3]) - cf[2] * (kn[a] - cf[4]);
    }
    for (int d = lane; d < D; d += kWarp) dxa[d] = fmaf(wsum, cta[d], dxa[d]);
    __syncwarp();                               // cta, q and coef are reused
  }
  if (slot >= 0) {                              // a piece of a longer column
    float* pr = part + static_cast<size_t>(slot) * (D + A);
    for (int d = lane; d < D; d += kWarp) pr[d] = dxa[d];
    for (int a = lane; a < A; a += kWarp) pr[D + a] = dka[a];
    return;
  }
  __syncwarp();
  for (int a = lane; a < A; a += kWarp)
    dkn_out[static_cast<size_t>(n) * A + a] = dka[a];
  project(dka, kw_t, nullptr, A, D, lane, dkw);
  for (int d = lane; d < D; d += kWarp)
    dx[static_cast<size_t>(n) * D + d] = dxa[d] + dkw[d];
}

// a column of several pieces: its partials summed in piece order, then as
// the end of fused_rhs_bwd_col_kernel (shared per warp: the summed dk,
// then its product by Kw^T)
__global__ void fused_rhs_bwd_col_merge_kernel(
    Pieces pc, Proj p, const float* __restrict__ kw_t,
    const float* __restrict__ part, float* __restrict__ dx,
    float* __restrict__ dkn_out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= pc.n_multi) return;                  // whole warp leaves together
  const int D = p.dim, A = p.att, W = D + A;
  float* dka = smem + static_cast<size_t>(warp) * W;
  float* dkw = dka + A;
  const int n = pc.multi_col[m];
  const int s0 = pc.multi_ptr[m], s1 = pc.multi_ptr[m + 1];
  for (int a = lane; a < A; a += kWarp) {
    float sum = 0.0f;
    for (int s = s0; s < s1; ++s)
      sum += part[static_cast<size_t>(s) * W + D + a];
    dka[a] = sum;
    dkn_out[static_cast<size_t>(n) * A + a] = sum;
  }
  __syncwarp();
  project(dka, kw_t, nullptr, A, D, lane, dkw);
  for (int d = lane; d < D; d += kWarp) {
    float sum = 0.0f;
    for (int s = s0; s < s1; ++s) sum += part[static_cast<size_t>(s) * W + d];
    dx[static_cast<size_t>(n) * D + d] = sum + dkw[d];
  }
}

// K17's operands beside the graph, the pieces and the tables (see
// gnpde_fused_rhs_bwd_col)
struct Col {
  const void *ct_ax, *recip_p, *ct_den, *kw_t;
  void *dx, *dkn, *part, *partials;
  int reduce_blocks;
};

// K17's two passes over the column table xcol of type TC (its k table
// too), then the first pass of dKw / dKb over the column table's rows
template <typename TC>
cudaError_t launch_bwd_col(Graph g, Pieces pc, Proj p, const void* xcol,
                           const void* qtab, const void* ktab, const Col& c,
                           cudaStream_t s) {
  const size_t bytes = sizeof(float) * kWarpsPerBlock *
                       piece_floats(p.dim, p.att, p.heads);
  cudaError_t err = allow_shared(fused_rhs_bwd_col_kernel<TC>, bytes);
  if (err != cudaSuccess) return err;
  fused_rhs_bwd_col_kernel<TC><<<row_blocks(pc.n_pieces),
                                 kWarpsPerBlock * kWarp, bytes, s>>>(
      g, pc, p, static_cast<const TC*>(xcol), static_cast<const float*>(qtab),
      static_cast<const TC*>(ktab), static_cast<const float*>(c.kw_t),
      static_cast<const float*>(c.ct_ax), static_cast<const float*>(c.recip_p),
      static_cast<const float*>(c.ct_den), static_cast<float*>(c.dx),
      static_cast<float*>(c.dkn), static_cast<float*>(c.part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pc.n_multi > 0) {
    const size_t merge = sizeof(float) * kWarpsPerBlock * (p.dim + p.att);
    err = allow_shared(fused_rhs_bwd_col_merge_kernel, merge);
    if (err != cudaSuccess) return err;
    fused_rhs_bwd_col_merge_kernel<<<row_blocks(pc.n_multi),
                                     kWarpsPerBlock * kWarp, merge, s>>>(
        pc, p, static_cast<const float*>(c.kw_t),
        static_cast<const float*>(c.part), static_cast<float*>(c.dx),
        static_cast<float*>(c.dkn));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  launch_outer_reduce(static_cast<const TC*>(xcol), nullptr,
                      static_cast<const float*>(c.dkn),
                      static_cast<float*>(c.partials), g.n_rows,
                      c.reduce_blocks, p.dim, p.att, s);
  return cudaGetLastError();
}

}  // namespace

// Every entry point first fills the scratch tables qtab and ktab
// [n_rows, att] (q = x Qw + qb, k = x Kw + kb), then walks the rows.
// flags: bits 0-2 the score family, bit 3 squareplus. var and ls hold one
// element for exp_kernel and two (features, positions) for
// exp_kernel_beltrami, whose att is the packed width of both halves.
// K9 and K17 take `tables` (kTablesF32, kTablesF32Bf16, kTablesBf16:
// see launch_tables) and the column table xcol, ignored with kTablesF32;
// with a bfloat16 column table, ktab holds bfloat16 values and kw, kb are
// the bf16-rounded projection.

// K9 over the row pieces piece_ptr, piece_row, piece_slot [n_pieces]
// and multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py, ColPieces of
// rowptr) and the CSR columns col. rc [n_rows, heads, 2] holds each
// node's (recip_p, ct_den) per head; kw_t is Kw^T [att, dim] (of the
// bf16-rounded Kw with a bfloat16 column table: the k table's
// derivative). dkn [n_rows, att] and row_sums [n_rows, 5] are scratch the
// wrapper reduces; part [multi_ptr[n_multi], dim + 2 att + 5] holds the
// pieces' partial sums (nullable without multi-piece rows); partials
// [reduce_blocks, dim + 1, att] are written whole, and dKw is reduced over
// the column table. vec: dim % 4 == 0 and x, xcol, ct_ax, kw_t, dxrow
// 16-byte aligned. Nullable: var, ls.
extern "C" int gnpde_fused_rhs_bwd_sym(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* ct_ax, const void* rc, const void* kw_t,
    void* qtab, void* ktab, void* dq, void* dxrow, void* dkn, void* row_sums,
    void* part, void* partials, int n_rows, int n_pieces, int n_multi,
    int dim, int att, int heads, int flags, int reduce_blocks, int vec,
    int tables, void* stream) {
  return launch_sym_backward<SymRows>(
      1, tables, piece_ptr, piece_row, piece_slot, multi_row, multi_ptr, col,
      x, xcol, qw, qb, kw, kb, gmax, var, ls, ct_ax, rc, kw_t, qtab, ktab, dq,
      dxrow, dkn, row_sums, part, partials, n_rows, n_pieces, n_multi, dim,
      att, heads, flags, reduce_blocks, vec, stream);
}

// K17 over the CSC view's column pieces (ops/graph.py, ColPieces):
// piece_ptr [n_pieces + 1] (edge ranges of row_by_col, the row of each edge
// in column order), piece_col and piece_slot [n_pieces], multi_col
// [n_multi] and multi_ptr [n_multi + 1]. kw_t is Kw^T [att, dim] (of the
// bf16-rounded Kw with a bfloat16 column table). dkn [n_cols, att] (each
// column's summed dk) is scratch the wrapper reduces over the column
// table; part [multi_ptr[n_multi], dim + att] is the pieces' partial sums
// (nullable without multi-piece columns); partials [reduce_blocks, dim +
// 1, att] are written whole. With project == 0 the q and k tables are read
// as an earlier launch on the same operands left them (K8 without dxg's,
// in the column-plan backward), else filled first. Nullable: var, ls.
extern "C" int gnpde_fused_rhs_bwd_col(
    const void* piece_ptr, const void* piece_col, const void* piece_slot,
    const void* multi_col, const void* multi_ptr, const void* row_by_col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* ct_ax, const void* recip_p,
    const void* ct_den, const void* kw_t, void* qtab, void* ktab, void* dx,
    void* dkn, void* part, void* partials, int n_cols, int n_pieces,
    int n_multi, int dim, int att, int heads, int flags, int reduce_blocks,
    int project, int tables, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_cols > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (project)
      err = launch_tables(tables, x, xcol, qw, qb, kw, kb, qtab, ktab, n_cols,
                          dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Graph g = make_graph(nullptr, row_by_col, n_cols);
    const Pieces pc = {static_cast<const int*>(piece_ptr),
                       static_cast<const int*>(piece_col),
                       static_cast<const int*>(piece_slot),
                       static_cast<const int*>(multi_col),
                       static_cast<const int*>(multi_ptr), n_pieces, n_multi};
    const Proj p = make_proj(gmax, var, ls, dim, att, heads, flags);
    const Col c = {ct_ax, recip_p, ct_den, kw_t, dx, dkn, part, partials,
                   reduce_blocks};
    err = tables == kTablesF32
              ? launch_bwd_col<float>(g, pc, p, x, qtab, ktab, c, s)
              : launch_bwd_col<__nv_bfloat16>(g, pc, p, xcol, qtab, ktab, c,
                                              s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
