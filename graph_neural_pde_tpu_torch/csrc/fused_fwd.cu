// K6 fused_rhs_fwd and K7 fused_rowmax: one evaluation of the GRAND-nl
// attention right-hand side over a row-sorted CSR graph, and its per-row
// score maxima (the shifts of the exact softmax). Replace the TPU kernels
// of graph_neural_pde_tpu/ops/pallas/fused_rhs.py _rhs_kernel_ax /
// _fused_ax_call (K6) and _rowmax_kernel / fused_rowmax (K7). The formulas,
// the node tables and the bfloat16 modes are those of fused_rhs.cu's note;
// the backward passes K8, K9 and K17 live beside it. K6's and K7's many
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
// K7 walks the same row pieces in the same lane layout (its walk reads
// only q_n and k_c: ATT floats an edge) and scores each edge as K6's
// fwd_score does, bit for bit, over the same q and k tables, so that its
// row maxima are maxima of the very scores K6 shifts: each row's largest
// shifted score is exactly 0.

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
//
// What bounds K7 on the H100: its per-edge chain. It reads only q_n and
// k_c (ATT floats an edge, from the L2 at every timed shape: the arxiv k
// table is 22 MB) and scores them; the first version gave a warp a whole
// row and scored one edge at a time, each k-row load waiting on its
// column index and each score's butterfly on its load, so a row cost its
// degree in round trips: 0.33 ms at arxiv scale against a bound of 0.044
// (PERF.md, section 6).
//
// Design: K6's row pieces and lane layout. One warp walks one piece of at
// most COL_PIECE edges of a row (Graph.row_pieces): the column indices of
// its edges in one coalesced load, then kRowmaxBatch edges at a time,
// the next batch's k rows loaded while the batch is scored, its segmented
// butterflies (slice_sums over kRowmaxBatch values) in flight together.
// Each score is fwd_score's, bit for bit: the same __fmul_rn products, the
// same adds in each head's butterfly, the sum scaled by 1 / sqrt(d_k).
// Every lane keeps the maxima of its own columns' head sums (the same in
// every lane of a head), and lane h < H reads head h's from its first
// column once, at the end of the piece. A row of one piece writes its
// maxima; the pieces of a longer row write theirs to partials, which
// fused_rowmax_merge_kernel takes in piece order. A maximum is exact
// whatever the order, and nothing is atomic.

constexpr int kRowmaxBatch = 4;   // edges a batch

// What K7's walk reads beside its pieces and tables, and writes
struct RowmaxIO {
  const int* col;          // each edge's column
  float* smax;             // [N, H]
  float* part;             // [slots, H]: the pieces' maxima
};

// the k rows of a batch's edges: edge i0 + b of the 32 whose columns the
// lanes hold (an index past cnt clamped to the last edge)
template <typename TC, int KA>
__device__ __forceinline__ void rowmax_rows(const LaneHeads<KA>& h,
                                            const TC* __restrict__ ktab,
                                            int cols, int i0, int cnt,
                                            int att, int lane,
                                            float (&k)[kRowmaxBatch][KA]) {
#pragma unroll
  for (int b = 0; b < kRowmaxBatch; ++b) {
    const int c = __shfl_sync(kFull, cols, min(i0 + b, cnt - 1));
#pragma unroll
    for (int j = 0; j < KA; ++j)
      k[b][j] = bit(h.valid, j)
                    ? widen(ktab[static_cast<size_t>(c) * att + kWarp * j +
                                 lane])
                    : 0.0f;
  }
}

template <typename TC, int KA>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    fused_rowmax_kernel(Pieces pc, Proj p, RowmaxIO io,
                        const float* __restrict__ qtab,
                        const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kB = kRowmaxBatch;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pi = blockIdx.x * kWarpsPerBlock + warp;
  if (pi >= pc.n_pieces) return;                // whole warp leaves together
  const int A = p.att, H = p.heads;
  const int n = pc.col[pi], slot = pc.slot[pi];
  const int start = pc.ptr[pi], end = pc.ptr[pi + 1];
  float* buf = smem + static_cast<size_t>(warp) * A;
  const LaneHeads<KA> h = make_heads<KA>(p, lane);
  const HeadLane hl = head_lane(p, h.d_k, lane);
  const ScoreConsts skc = score_consts(score_params(p), h.d_k);
  float qn[KA], m[KA];                          // m: this lane's columns
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    qn[j] = bit(h.valid, j)
                ? __ldg(qtab + static_cast<size_t>(n) * A + kWarp * j + lane)
                : 0.0f;
    m[j] = -CUDART_INF_F;
  }
  for (int base = start; base < end; base += kWarp) {
    const int cnt = min(kWarp, end - base);
    const int cols = lane < cnt ? __ldg(io.col + base + lane) : n;
    float next[kB][KA];
    rowmax_rows<TC, KA>(h, ktab, cols, 0, cnt, A, lane, next);
    for (int i = 0; i < cnt; i += kB) {
      float t[kB][KA];
#pragma unroll
      for (int b = 0; b < kB; ++b)
#pragma unroll
        for (int j = 0; j < KA; ++j) t[b][j] = __fmul_rn(qn[j], next[b][j]);
      if (i + kB < cnt)                         // the next batch's rows
        rowmax_rows<TC, KA>(h, ktab, cols, i + kB, cnt, A, lane, next);
      slice_sums<KA, kB>(h, t, buf, lane, A);
#pragma unroll
      for (int b = 0; b < kB; ++b)
        if (i + b < cnt) {
#pragma unroll
          for (int j = 0; j < KA; ++j) m[j] = fmaxf(m[j], t[b][j] * skc.root);
        }
    }
  }
  const float mh = lane_gather<KA>(m, hl.tile, hl.src);  // lane h: head h
  if (lane < H) {
    if (slot >= 0)                              // a piece of a longer row
      io.part[static_cast<size_t>(slot) * H + lane] = mh;
    else
      io.smax[static_cast<size_t>(n) * H + lane] = isfinite(mh) ? mh : 0.0f;
  }
}

// A row of several pieces: its pieces' maxima taken in piece order (a
// thread a row and head)
__global__ void fused_rowmax_merge_kernel(Pieces pc, int heads,
                                          RowmaxIO io) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pc.n_multi * heads) return;
  const int m = i / heads, h = i % heads;
  float v = -CUDART_INF_F;
  for (int s = pc.multi_ptr[m]; s < pc.multi_ptr[m + 1]; ++s)
    v = fmaxf(v, io.part[static_cast<size_t>(s) * heads + h]);
  io.smax[static_cast<size_t>(pc.multi_col[m]) * heads + h] =
      isfinite(v) ? v : 0.0f;
}

// K7 over the q table and the k table of type TC (see launch_tables), by
// the kernel whose tiles cover att, then the merge of multi-piece rows
template <typename TC, int KA>
cudaError_t launch_rowmax_k(const Pieces& pc, const Proj& p,
                            const RowmaxIO& io, const void* qtab,
                            const void* ktab, cudaStream_t s) {
  const size_t bytes = sizeof(float) * kWarpsPerBlock * p.att;
  cudaError_t err = allow_shared(fused_rowmax_kernel<TC, KA>, bytes);
  if (err != cudaSuccess) return err;
  fused_rowmax_kernel<TC, KA><<<row_blocks(pc.n_pieces),
                                kWarpsPerBlock * kWarp, bytes, s>>>(
      pc, p, io, static_cast<const float*>(qtab),
      static_cast<const TC*>(ktab));
  err = cudaGetLastError();
  if (err != cudaSuccess || pc.n_multi == 0) return err;
  const int threads = pc.n_multi * p.heads;
  fused_rowmax_merge_kernel<<<(threads + 127) / 128, 128, 0, s>>>(
      pc, p.heads, io);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t launch_rowmax(const Pieces& pc, const Proj& p,
                          const RowmaxIO& io, const void* qtab,
                          const void* ktab, cudaStream_t s) {
  if (p.att <= 32) return launch_rowmax_k<TC, 1>(pc, p, io, qtab, ktab, s);
  if (p.att <= 64) return launch_rowmax_k<TC, 2>(pc, p, io, qtab, ktab, s);
  if (p.att <= 128) return launch_rowmax_k<TC, 4>(pc, p, io, qtab, ktab, s);
  return launch_rowmax_k<TC, 8>(pc, p, io, qtab, ktab, s);
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

// K7 over the row pieces piece_ptr, piece_row, piece_slot [n_pieces] and
// multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py, ColPieces of rowptr:
// Graph.row_pieces) and the CSR columns col: smax [n_rows, heads], the
// maxima of each row's scaled-dot scores per head (0 on edgeless rows);
// part [multi_ptr[n_multi], heads] holds the pieces' maxima (nullable
// without multi-piece rows).
extern "C" int gnpde_fused_rowmax(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, void* qtab, void* ktab, void* smax,
    void* part, int n_rows, int n_pieces, int n_multi, int dim, int att,
    int heads, int tables, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_tables(tables, x, xcol, qw, qb, kw, kb, qtab,
                                    ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Pieces pc = {static_cast<const int*>(piece_ptr),
                       static_cast<const int*>(piece_row),
                       static_cast<const int*>(piece_slot),
                       static_cast<const int*>(multi_row),
                       static_cast<const int*>(multi_ptr), n_pieces, n_multi};
    const Proj p = make_proj(nullptr, nullptr, nullptr, dim, att,
                             heads, kScaledDot);
    const RowmaxIO io = {static_cast<const int*>(col),
                         static_cast<float*>(smax), static_cast<float*>(part)};
    err = tables == kTablesF32
              ? launch_rowmax<float>(pc, p, io, qtab, ktab, s)
              : launch_rowmax<__nv_bfloat16>(pc, p, io, qtab, ktab, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
