// K8 fused_rhs_bwd without its per-edge dxg: the row side of the
// column-plan backward of the GRAND-nl attention right-hand side
// (make_fused_ax_colplan), over a row-sorted CSR graph, directed or not.
// Replaces the TPU kernel _bwd_kernel / _fused_bwd_mega_call of
// graph_neural_pde_tpu/ops/pallas/fused_rhs.py with want_dxg=False. The
// formulas, the node tables and the bfloat16 column table are those of
// fused_rhs.cu's note; K8's mode with dxg (the exact re-solve) stays there,
// and K17, which forms x's gradient and dKw, dKb over the CSC view, reads
// the q and k tables this launch fills.
//
// For row n with edges e to columns c, per head h:
//     ds_eh = ((ct_ax[n] . x_c) recip_p[n, h] + ct_den[n, h]) du/ds,
//     dq[n] = sum_e sum_h ds_eh ds_eh/dq_n,
// and the row's scalar sums: ds (for dgmax) and the terms of the score
// scalars' derivatives (exp_kernel, exp_kernel_beltrami).
//
// What bounds it on the H100: the latency of the per-edge gathers (x_c, D
// values, and k_c, ATT) and of the chain behind them, times the warps an SM
// keeps in flight. The first version gave a warp a whole row and copied
// each edge's x_c and k_c into shared memory by a loop of its own, waited
// on a __syncwarp, a warp dot and H lanes' serial scores (d_k terms each
// through shared memory), then another __syncwarp; no piece bounded a hub
// row: 1.78 ms at arxiv scale against a bound of 0.061 (PERF.md, section
// 6).
//
// Design: the forward direction of K9's walk (fused_common.cuh,
// sym_backward_piece) on the row pieces of K6's forward walk.
// * One warp walks one piece of at most COL_PIECE edges of a row
//   (Graph.row_pieces), one edge at a time, in K9's lane layout (KD
//   16-byte column groups of a D-wide row, KA columns of a q or k row a
//   lane). q_n, ct_ax[n], the row's (recip_p, ct_den) of each column's
//   head and every sum live in registers; an edge's x_c, k_c and, in the
//   exact mode, its per-edge shifts are loaded together, the column
//   indices of 32 edges in one coalesced load.
// * ct_ax[n] . x_c is a warp-wide dot; a head's terms are summed over its
//   lanes by slice_sums' segmented butterfly, so every lane holds its
//   head's score and forms ds and its own column's term of dq (tile_score,
//   the coefficients of sym_backward_piece); the scalar sums are kept a
//   lane and folded over the head groups at the end of the piece.
// * A row of one piece is finished in the walk (dq and its row sums); the
//   pieces of a longer row write their partial sums, which
//   fused_rhs_bwd_rows_merge_kernel adds in piece order.
// Every sum has a fixed order (edges in a piece, then pieces in order;
// every butterfly and fold the same on every run): no atomics, two
// launches agree bit for bit.

#include "fused_common.cuh"

namespace {

// What the walk reads beside its pieces and tables, and writes
struct RowsIO {
  const int* col;          // each edge's column
  const float* ct_ax;      // [N, D]
  const float* recip_p;    // [N, H]
  const float* ct_den;     // [N, H]
  const float* shifts;     // per-edge score shifts [E, H], or null
  float* dq;               // [N, ATT]
  float* row_sums;         // [N, kRowSums]
  float* part;             // [slots, ATT + kRowSums]: pieces' partials
  int vec;                 // D % 4 == 0 and the D-wide rows 16-byte aligned
};

// The slice sums of the forward direction of an edge (q_n against k_c),
// the first half of edge_sums: without kNormed v[0] the dot product or the
// squared distance and, for exp_kernel_beltrami, v[2] its partner half's
// (tile_score's layout; v[1] and v[3] unused); with kNormed v[0..2] (q.k,
// q.q, k.k) over the centred columns and, for pearson, the means m[0..1]
// (q_n, k_c), else 0.
template <int KA, bool kNormed>
__device__ __forceinline__ void forward_sums(
    const LaneHeads<KA>& h, const Proj& p, const ScoreConsts& k,
    const float (&qn)[KA], const float (&kc)[KA], float* buf, int lane,
    float (&v)[kNormed ? 3 : 4][KA], float (&m)[2][KA]) {
  const int A = p.att;
  if constexpr (!kNormed) {
    float t[1][KA];
    const bool dot = p.score == kScaledDot;
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const float df = qn[j] - kc[j];
      t[0][j] = dot ? qn[j] * kc[j] : df * df;
    }
    slice_sums<KA, 1>(h, t, buf, lane, A);
    if (p.score == kBeltrami) {
      float w[KA];
      partner<KA>(h, t[0], w, buf, lane, A);
#pragma unroll
      for (int j = 0; j < KA; ++j) v[2][j] = w[j];
    }
#pragma unroll
    for (int j = 0; j < KA; ++j) v[0][j] = t[0][j];
  } else {
    if (p.score == kPearson) {              // the head means first
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        m[0][j] = qn[j];
        m[1][j] = kc[j];
      }
      slice_sums<KA, 2>(h, m, buf, lane, A);
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        m[0][j] *= k.inv_dk;
        m[1][j] *= k.inv_dk;
      }
    }
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const float a = qn[j] - m[0][j], b = kc[j] - m[1][j];
      v[0][j] = a * b;
      v[1][j] = a * a;
      v[2][j] = b * b;
    }
    slice_sums<KA, 3>(h, v, buf, lane, A);
  }
}

// Blocks of the walk an SM keeps resident, for __launch_bounds__: the
// walk waits on its gathers, so warps in flight pay more than the few
// bytes a cap spills; registers capped at 48 (10 blocks) with 1
// attention tile, at 64 (8) with 2 and 4; with 8 tiles (the kNN graph's
// BLEND widths) uncapped (166-168 registers), where caps of 96, 80 and 64
// took 15-79% longer (PERF.md, section 6).
__host__ __device__ constexpr int rows_min_blocks(int ka) {
  return ka == 1 ? 10 : ka <= 4 ? 8 : 1;
}

// One piece of a row n (see the note above): kNormed takes cosine_sim and
// pearson, else scaled_dot, exp_kernel and exp_kernel_beltrami; xcol is
// the column-side table the values and k come from (x itself, or the
// bfloat16 copy under the bf16 payload, whose k table is bfloat16 too);
// the row side is the q table. smem: the block's dynamic shared memory, A
// floats a warp (kBufferHeads only).
template <typename TC, int KD, int KA, bool kNormed>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  rows_min_blocks(KA))
    fused_rhs_bwd_rows_kernel(Pieces pc, Proj p, RowsIO io,
                              const TC* __restrict__ xcol,
                              const float* __restrict__ qtab,
                              const TC* __restrict__ ktab) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pi = blockIdx.x * kWarpsPerBlock + warp;
  if (pi >= pc.n_pieces) return;              // whole warp leaves together
  const int D = p.dim, A = p.att, H = p.heads;
  const bool vec = io.vec;
  const int n = pc.col[pi], slot = pc.slot[pi];
  const int start = pc.ptr[pi], end = pc.ptr[pi + 1];
  float* buf = smem + static_cast<size_t>(warp) * A;
  const LaneHeads<KA> h = make_heads<KA>(p, lane);
  const float gmax = *p.gmax;
  const ScoreConsts skc = score_consts(score_params(p), h.d_k);
  constexpr int kV = kNormed ? 3 : 4;           // slice sums an edge

  // the resident row n, and its accumulators
  float4 cta[KD];
#pragma unroll
  for (int t = 0; t < KD; ++t)
    cta[t] = load4(io.ct_ax + static_cast<size_t>(n) * D,
                   4 * (kWarp * t + lane), D, vec);
  float qn[KA], dqa[KA];
  float2 rn[KA];                               // (recip_p, ct_den) of the
#pragma unroll                                 // column's head
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane;
    const bool v = bit(h.valid, j);
    const size_t at = static_cast<size_t>(n) * H + h.head[j];
    qn[j] = v ? __ldg(qtab + static_cast<size_t>(n) * A + a) : 0.0f;
    rn[j] = v ? make_float2(__ldg(io.recip_p + at), __ldg(io.ct_den + at))
              : make_float2(0.0f, 0.0f);
    dqa[j] = 0.0f;
  }
  float sums[kRowSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int base = start; base < end; base += kWarp) {
    const int cnt = min(kWarp, end - base);
    const int cols = lane < cnt ? __ldg(io.col + base + lane) : n;
    for (int i = 0; i < cnt; ++i) {
      const int c = __shfl_sync(kFull, cols, i);
      const size_t e = static_cast<size_t>(base + i);
      // the edge's rows and its shifts, every load started before the
      // first use
      float4 xc[KD];
#pragma unroll
      for (int t = 0; t < KD; ++t)
        xc[t] = load4(xcol + static_cast<size_t>(c) * D,
                      4 * (kWarp * t + lane), D, vec);
      float kc[KA], sh[KA];
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        const bool v = bit(h.valid, j);
        kc[j] = v ? widen(ktab[static_cast<size_t>(c) * A + kWarp * j + lane])
                  : 0.0f;
        sh[j] = v && io.shifts != nullptr
                    ? __ldg(io.shifts + e * H + h.head[j])
                    : 0.0f;
      }
      float dot = 0.0f;                       // ct_ax[n] . x_c
#pragma unroll
      for (int t = 0; t < KD; ++t) dot = dot4(cta[t], xc[t], dot);
      dot = warp_sum(dot);
      float v[kV][KA] = {}, m[2][KA] = {};
      forward_sums<KA, kNormed>(h, p, skc, qn, kc, buf, lane, v, m);
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        float vj[kV];
#pragma unroll
        for (int i2 = 0; i2 < kV; ++i2) vj[i2] = v[i2][j];
        const TileScore cf =
            tile_score<kNormed>(p.score, skc, vj, 0, bit(h.feat, j));
        float u, duds;
        u_duds((cf.s - gmax) - sh[j], p.square_plus, &u, &duds);
        const float ds = fmaf(rn[j].x, dot, rn[j].y) * duds;
        dqa[j] += cf.p * ds * (kc[j] - m[1][j]) -
                  cf.q * ds * (qn[j] - m[0][j]);
        if (bit(h.once, j)) {
          sums[0] += ds;
          if (!kNormed && p.score != kScaledDot) {
            sums[1] += ds * (cf.s * skc.iv2);
            sums[2] += ds * cf.s * cf.dist * skc.il3;
          }
          if (!kNormed && p.score == kBeltrami) {
            sums[3] += ds * (cf.s * skc.iv2_p);
            sums[4] += ds * cf.s * cf.dist_p * skc.il3_p;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowSums; ++i) sums[i] = head_fold(sums[i], h.fold);
  float* dq = io.dq + static_cast<size_t>(n) * A;
  float* rs = io.row_sums + static_cast<size_t>(n) * kRowSums;
  if (slot >= 0) {                            // a piece of a longer row
    dq = io.part + static_cast<size_t>(slot) * (A + kRowSums);
    rs = dq + A;
  }
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane;
    if (a < A) dq[a] = dqa[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowSums; ++i) rs[i] = sums[i];
  }
}

// A row of several pieces: dq and the row sums of its pieces added in
// piece order (a warp a row; the second pass when a row has several
// pieces)
__global__ void fused_rhs_bwd_rows_merge_kernel(Pieces pc, Proj p,
                                                RowsIO io) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= pc.n_multi) return;                // whole warp leaves together
  const int A = p.att, W = A + kRowSums;
  const int n = pc.multi_col[m];
  const int s0 = pc.multi_ptr[m], s1 = pc.multi_ptr[m + 1];
  for (int a = lane; a < W; a += kWarp) {
    float sum = 0.0f;
    for (int s = s0; s < s1; ++s)
      sum += io.part[static_cast<size_t>(s) * W + a];
    if (a < A)
      io.dq[static_cast<size_t>(n) * A + a] = sum;
    else
      io.row_sums[static_cast<size_t>(n) * kRowSums + a - A] = sum;
  }
}

template <typename TC, int KD, int KA, bool kNormed>
cudaError_t launch_rows_k(const Pieces& pc, const Proj& p, const RowsIO& io,
                          const void* xcol, const void* qtab,
                          const void* ktab, cudaStream_t s) {
  const auto kernel = fused_rhs_bwd_rows_kernel<TC, KD, KA, kNormed>;
  // each warp's buffer of att floats, read only where make_heads picks
  // kBufferHeads
  const size_t bytes = sizeof(float) * kWarpsPerBlock * p.att;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<row_blocks(pc.n_pieces), kWarpsPerBlock * kWarp, bytes, s>>>(
      pc, p, io, static_cast<const TC*>(xcol),
      static_cast<const float*>(qtab), static_cast<const TC*>(ktab));
  return cudaGetLastError();
}

// K9's register tiles (GNPDE_SYM_TILES; cosine_sim and pearson, kNormed,
// in 2 or 8 attention tiles)
template <typename TC>
cudaError_t launch_rows(const Pieces& pc, const Proj& p, const RowsIO& io,
                        const void* xcol, const void* qtab, const void* ktab,
                        cudaStream_t s) {
  if (p.score == kCosine || p.score == kPearson) {
#define GNPDE_ROWS_NORMED(KD, KA) \
  launch_rows_k<TC, KD, KA, true>(pc, p, io, xcol, qtab, ktab, s)
    if (p.dim <= 128)
      return p.att <= 64 ? GNPDE_ROWS_NORMED(1, 2) : GNPDE_ROWS_NORMED(1, 8);
    return p.att <= 64 ? GNPDE_ROWS_NORMED(2, 2) : GNPDE_ROWS_NORMED(2, 8);
#undef GNPDE_ROWS_NORMED
  }
#define GNPDE_ROWS(KD, KA) \
  launch_rows_k<TC, KD, KA, false>(pc, p, io, xcol, qtab, ktab, s)
  GNPDE_SYM_TILES(GNPDE_ROWS)
#undef GNPDE_ROWS
}

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
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (project)
      err = launch_tables(tables, x, tables == kTablesF32 ? x : xcol, qw, qb,
                          kw, kb, qtab, ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Pieces pc = {static_cast<const int*>(piece_ptr),
                       static_cast<const int*>(piece_row),
                       static_cast<const int*>(piece_slot),
                       static_cast<const int*>(multi_row),
                       static_cast<const int*>(multi_ptr), n_pieces, n_multi};
    const Proj p = make_proj(gmax, var, ls, dim, att, heads, flags);
    const RowsIO io = {static_cast<const int*>(col),
                       static_cast<const float*>(ct_ax),
                       static_cast<const float*>(recip_p),
                       static_cast<const float*>(ct_den),
                       static_cast<const float*>(shifts),
                       static_cast<float*>(dq),
                       static_cast<float*>(row_sums),
                       static_cast<float*>(part),
                       vec};
    err = tables == kTablesF32
              ? launch_rows<float>(pc, p, io, x, qtab, ktab, s)
              : launch_rows<__nv_bfloat16>(pc, p, io, xcol, qtab, ktab, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_multi > 0) {
      fused_rhs_bwd_rows_merge_kernel<<<row_blocks(n_multi),
                                        kWarpsPerBlock * kWarp, 0, s>>>(
          pc, p, io);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
