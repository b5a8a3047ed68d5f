// The forward-direction backward walk over row pieces: K8 fused_rhs_bwd's
// row side in both of its modes. Without dxg (fused_bwd_rows.cu) it is the
// row side of the column-plan backward; with dxg (fused_bwd_edges.cu, the
// exact re-solve's backward) the same walk also writes each edge's dk_e
// and the weight w_e of ct_ax[n] in dxg[e], and a tiled product on the
// tensor cores forms dxg from them. The formulas, the node tables and the
// bfloat16 column table are those of fused_rhs.cu's note.
//
// For row n with edges e to columns c, per head h:
//     ds_eh = ((ct_ax[n] . x_c) recip_p[n, h] + ct_den[n, h]) du/ds,
//     dq[n] = sum_e sum_h ds_eh ds_eh/dq_n,
// the row's scalar sums: ds (for dgmax) and the terms of the score
// scalars' derivatives (exp_kernel, exp_kernel_beltrami); with dxg also
//     dk_e = sum_h ds_eh ds_eh/dk_e,   w_e = sum_h u_eh recip_p[n, h].
//
// What bounds it on the H100: the latency of the per-edge gathers (x_c, D
// values, and k_c, ATT) and of the chain behind them, times the warps an SM
// keeps in flight. The first version gave a warp a whole row and copied
// each edge's x_c and k_c into shared memory by a loop of its own, waited
// on a __syncwarp, a warp dot and H lanes' serial scores (d_k terms each
// through shared memory), then another __syncwarp; no piece bounded a hub
// row: 1.78 ms at arxiv scale against a bound of 0.061 (PERF.md, section
// 6). With dxg that version also formed dk_e Kw^T per edge with SIMT FMAs
// (A D products an edge): 8.66 ms at arxiv scale against 0.67.
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
// * With dxg (kEdges) each lane also writes its column of dk_e (one
//   coalesced row store a tile), and w_e is folded over the head groups as
//   K9 folds its reverse edges' weight; lane i keeps the w of the batch's
//   edge i, and the batch's w are stored in one coalesced store.
// * A row of one piece is finished in the walk (dq and its row sums); the
//   pieces of a longer row write their partial sums, which the merge
//   (rows_merge) adds in piece order.
// Every sum has a fixed order (edges in a piece, then pieces in order;
// every butterfly and fold the same on every run): no atomics, two
// launches agree bit for bit.

#pragma once

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
  float* dke;              // with dxg: each edge's dk_e [E, ATT]
  float* w;                // with dxg: each edge's w_e [E]
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
// pearson, else scaled_dot, exp_kernel and exp_kernel_beltrami; kEdges
// also writes dk_e and w_e of every edge (K8 with dxg); xcol is the
// column-side table the values and k come from (x itself, or the bfloat16
// copy under the bf16 payload, whose k table is bfloat16 too); the row
// side is the q table. smem: the block's dynamic shared memory, A floats a
// warp (kBufferHeads only).
template <typename TC, int KD, int KA, bool kNormed, bool kEdges>
__device__ __forceinline__ void rows_walk_piece(
    float* smem, Pieces pc, Proj p, RowsIO io, const TC* __restrict__ xcol,
    const float* __restrict__ qtab, const TC* __restrict__ ktab) {
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
    float wb = 0.0f;                          // kEdges: w of edge base + lane
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
      float w = 0.0f;                         // kEdges: sum_h u recip_p
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
        if constexpr (kEdges) {
          if (bit(h.valid, j))
            io.dke[e * A + kWarp * j + lane] =
                cf.p * ds * (qn[j] - m[0][j]) - cf.r * ds * (kc[j] - m[1][j]);
        }
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
          if constexpr (kEdges) w += rn[j].x * u;
        }
      }
      if constexpr (kEdges) {
        w = head_fold(w, h.fold);
        if (lane == i) wb = w;
      }
    }
    if constexpr (kEdges) {
      if (lane < cnt) io.w[base + lane] = wb;
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
__device__ __forceinline__ void rows_merge(Pieces pc, Proj p, RowsIO io) {
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

// The walk of each file's __global__ wrappers: Walk::walk<TC, KD, KA,
// kNormed>() (rows_walk_piece with or without kEdges) and Walk::merge()
// (rows_merge)
template <typename Walk, typename TC, int KD, int KA, bool kNormed>
cudaError_t launch_rows_k(const Pieces& pc, const Proj& p, const RowsIO& io,
                          const void* xcol, const void* qtab,
                          const void* ktab, cudaStream_t s) {
  const auto kernel = Walk::template walk<TC, KD, KA, kNormed>();
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
template <typename Walk, typename TC>
cudaError_t launch_rows(const Pieces& pc, const Proj& p, const RowsIO& io,
                        const void* xcol, const void* qtab, const void* ktab,
                        cudaStream_t s) {
  if (p.score == kCosine || p.score == kPearson) {
#define GNPDE_ROWS_NORMED(KD, KA) \
  launch_rows_k<Walk, TC, KD, KA, true>(pc, p, io, xcol, qtab, ktab, s)
    if (p.dim <= 128)
      return p.att <= 64 ? GNPDE_ROWS_NORMED(1, 2) : GNPDE_ROWS_NORMED(1, 8);
    return p.att <= 64 ? GNPDE_ROWS_NORMED(2, 2) : GNPDE_ROWS_NORMED(2, 8);
#undef GNPDE_ROWS_NORMED
  }
#define GNPDE_ROWS(KD, KA) \
  launch_rows_k<Walk, TC, KD, KA, false>(pc, p, io, xcol, qtab, ktab, s)
  GNPDE_SYM_TILES(GNPDE_ROWS)
#undef GNPDE_ROWS
}

// The walk's launches: the q and k tables (unless project == 0: filled
// already), the walk over the row pieces and the merge of multi-piece
// rows. `tables` as launch_tables takes it (valid: the entry points check
// it); with kTablesF32, xcol is x.
template <typename Walk>
cudaError_t launch_rows_walk(int project, int tables, const Pieces& pc,
                             const Proj& p, const RowsIO& io, const void* x,
                             const void* xcol, const void* qw,
                             const void* qb, const void* kw, const void* kb,
                             void* qtab, void* ktab, int n_rows,
                             cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (project)
    err = launch_tables(tables, x, tables == kTablesF32 ? x : xcol, qw, qb,
                        kw, kb, qtab, ktab, n_rows, p.dim, p.att, s);
  if (err != cudaSuccess) return err;
  err = tables == kTablesF32
            ? launch_rows<Walk, float>(pc, p, io, x, qtab, ktab, s)
            : launch_rows<Walk, __nv_bfloat16>(pc, p, io, xcol, qtab, ktab,
                                               s);
  if (err != cudaSuccess) return err;
  if (pc.n_multi > 0) {
    Walk::merge()<<<row_blocks(pc.n_multi), kWarpsPerBlock * kWarp, 0, s>>>(
        pc, p, io);
    err = cudaGetLastError();
  }
  return err;
}

Pieces make_pieces(const void* piece_ptr, const void* piece_row,
                   const void* piece_slot, const void* multi_row,
                   const void* multi_ptr, int n_pieces, int n_multi) {
  return {static_cast<const int*>(piece_ptr),
          static_cast<const int*>(piece_row),
          static_cast<const int*>(piece_slot),
          static_cast<const int*>(multi_row),
          static_cast<const int*>(multi_ptr), n_pieces, n_multi};
}

}  // namespace
