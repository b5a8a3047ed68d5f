// K12 norm1_den: the column denominators of the GRAND-nl attention with
// the softmax normalised over COLUMNS (attention_norm_idx = 1), over a
// row-sorted CSR graph whose edge multiset is symmetric, and the same sum
// weighted by the output's cotangent. Replaces the TPU kernel
// _norm1_rev_kernel / _norm1_rev_call of
// graph_neural_pde_tpu/ops/pallas/fused_rhs.py, both of its modes. The
// formulas, the mirror trick and the bfloat16 column table are those of
// norm1.cu's note (K13 and K14 live there); K12's template instances sit in
// a source of their own, so that nvcc builds them beside norm1.cu's.
//
// For an edge e = (r, c), s_eh = score_h(q[r], k[c]) and u_eh =
// exp(s_eh - gmax) (or squareplus). The edges into n are the reverses of
// row n's edges (n, c), so row n's walk gives
//     den[n, h] = sum over (n, c) of u(score_h(q[c], k[n]) - gmax),
// q from the gathered node and k from the resident one: the very score K13
// gives the edge (c, n). With the cotangent ct [N, D] each term is weighted
// by ct[c] . x[n] (x[n] from the column table, the value K13 aggregated),
// the numerator of den's cotangent.
//
// What bounds it on the H100: the latency of the per-edge gather (q[c],
// ATT floats; weighted also ct[c], D floats) and of the chain behind it,
// times the warps an SM keeps in flight. The first version gave each lane
// one edge of a row: a lane ran the weight's dot ct[c] . x[n] serially,
// one float of the 512-byte ct row at a time (each load instruction of the
// warp touching 32 lines), and scored every head serially against k[n] in
// shared memory: 1.95 ms at arxiv scale in the weighted mode against a
// bound of 0.055 (PERF.md, section 6).
//
// Design: K13's forward walk (fused_common.cuh, fwd_walk_piece) with the
// roles of the rows swapped.
// * One warp walks one piece of at most COL_PIECE edges of a row
//   (Graph.row_pieces), one edge at a time, in K9's lane layout (KD
//   16-byte column groups of a D-wide row, KA columns of a q or k row a
//   lane). k[n] and, weighted, x[n] live in registers; an edge's q[c] and
//   ct[c] are loaded together, the column indices of 32 edges in one
//   coalesced load.
// * The weight ct[c] . x[n] is a warp-wide dot over the lanes' float4
//   groups; every head is scored on all lanes by fwd_score, q from the
//   gathered node and k from the resident one, so lane h holds exactly the
//   u that K13 forms for the edge (c, n), bit for bit; lane h keeps den_h.
// * A row of one piece is written in the walk; the pieces of a longer row
//   write their partial sums, which norm1_den_merge_kernel adds in piece
//   order.
// Every sum has a fixed order (edges in a piece, then pieces in order;
// every butterfly the same on every run): no atomics, two launches agree
// bit for bit.

#include "fused_common.cuh"

namespace {

// What K12's walk reads beside its pieces and tables, and writes
struct DenIO {
  const int* col;          // each edge's column
  const float* ct;         // [N, D]: the weighted mode's cotangent, or null
  float* out;              // [N, H]
  float* part;             // [slots, H]: the pieces' partial sums
  int vec;                 // D % 4 == 0 and the D-wide rows 16-byte aligned
};

// Blocks of K12's walk an SM keeps resident, for __launch_bounds__
// (weighted: with the D-wide rows). The walk waits on its gathers, so
// warps in flight pay more than the few bytes a cap spills: with 1 or 2
// attention tiles registers are capped at 32 (16 blocks, 64 warps) in
// both modes, with 4 at 48 (10 blocks) plain and 64 (8) weighted,
// measured against caps of 40 and 48 and none at the arxiv, BLEND and
// Cora shapes (PERF.md, section 6); with 8 tiles, which no measured shape
// reaches, at 64 (8) and 80 (6).
__host__ __device__ constexpr int den_min_blocks(int ka, bool weighted) {
  return ka <= 2 ? 16 : ka == 4 ? (weighted ? 8 : 10) : (weighted ? 6 : 8);
}

// One piece of a row n of K12's walk (see the note above): kNormed takes
// cosine_sim and pearson, else scaled_dot, exp_kernel and
// exp_kernel_beltrami; kWeighted the mode with the cotangent (KD D-wide
// groups, unused without); xcol is the column table x[n] comes from, and
// the k table's type; the q table is the row side's. smem: the block's
// dynamic shared memory, A floats a warp (kBufferHeads only).
template <typename TC, int KD, int KA, bool kNormed, bool kWeighted>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  den_min_blocks(KA, kWeighted))
    norm1_den_kernel(Pieces pc, Proj p, DenIO io,
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
  const HeadLane hl = head_lane(p, h.d_k, lane);
  const float gmax = *p.gmax;
  const ScoreConsts skc = score_consts(score_params(p), h.d_k);
  // k and x at the resident node from the column side (K13's k table and
  // values at the same node)
  float kn[KA];
#pragma unroll
  for (int j = 0; j < KA; ++j)
    kn[j] = bit(h.valid, j)
                ? widen(ktab[static_cast<size_t>(n) * A + kWarp * j + lane])
                : 0.0f;
  float4 xn[KD];
  if constexpr (kWeighted) {
#pragma unroll
    for (int t = 0; t < KD; ++t)
      xn[t] = load4(xcol + static_cast<size_t>(n) * D, 4 * (kWarp * t + lane),
                    D, vec);
  }
  float den = 0.0f;                           // lane h: head h's sum
  for (int base = start; base < end; base += kWarp) {
    const int cnt = min(kWarp, end - base);
    const int cols = lane < cnt ? __ldg(io.col + base + lane) : n;
    for (int i = 0; i < cnt; ++i) {
      const int c = __shfl_sync(kFull, cols, i);
      // the reverse edge (c, n): q at the gathered node, and its weight's
      // cotangent row, every load started before the first use
      float qc[KA];
#pragma unroll
      for (int j = 0; j < KA; ++j)
        qc[j] = bit(h.valid, j)
                    ? __ldg(qtab + static_cast<size_t>(c) * A + kWarp * j +
                            lane)
                    : 0.0f;
      float4 ctc[KD];
      if constexpr (kWeighted) {
#pragma unroll
        for (int t = 0; t < KD; ++t)
          ctc[t] = load4(io.ct + static_cast<size_t>(c) * D,
                         4 * (kWarp * t + lane), D, vec);
      }
      const float s = fwd_score<KA, kNormed>(h, hl, p, skc, qc, kn, buf, lane);
      float u, duds;
      u_duds(s - gmax, p.square_plus, &u, &duds);
      if constexpr (kWeighted) {
        float w = 0.0f;                       // ct[c] . x[n]
#pragma unroll
        for (int t = 0; t < KD; ++t) w = dot4(ctc[t], xn[t], w);
        den += u * warp_sum(w);
      } else {
        den += u;
      }
    }
  }
  if (lane < H) {
    if (slot < 0)
      io.out[static_cast<size_t>(n) * H + lane] = den;
    else                                      // a piece of a longer row
      io.part[static_cast<size_t>(slot) * H + lane] = den;
  }
}

// A row of several pieces: lane h adds head h's partial sums in piece
// order (a warp a row; the second pass when a row has several pieces)
__global__ void norm1_den_merge_kernel(Pieces pc, Proj p, DenIO io) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  const int H = p.heads;
  if (m >= pc.n_multi || lane >= H) return;
  float den = 0.0f;
  for (int s = pc.multi_ptr[m]; s < pc.multi_ptr[m + 1]; ++s)
    den += io.part[static_cast<size_t>(s) * H + lane];
  io.out[static_cast<size_t>(pc.multi_col[m]) * H + lane] = den;
}

template <typename TC, int KD, int KA, bool kNormed, bool kWeighted>
cudaError_t launch_den_k(const Pieces& pc, const Proj& p, const DenIO& io,
                         const void* xcol, const void* qtab,
                         const void* ktab, cudaStream_t s) {
  const auto kernel = norm1_den_kernel<TC, KD, KA, kNormed, kWeighted>;
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

// the walk of the call's mode and widths: the plain mode's tiles cover att
// only (KD = 1, unused); the weighted mode's are K9's (GNPDE_SYM_TILES);
// cosine_sim and pearson (kNormed) take 2 or 8 attention tiles
template <typename TC, bool kWeighted>
cudaError_t launch_den_walk(const Pieces& pc, const Proj& p, const DenIO& io,
                            const void* xcol, const void* qtab,
                            const void* ktab, cudaStream_t s) {
#define GNPDE_DEN_K(KD, KA, NORMED)                                      \
  launch_den_k<TC, KD, KA, NORMED, kWeighted>(pc, p, io, xcol, qtab, ktab, \
                                              s)
  const bool normed = p.score == kCosine || p.score == kPearson;
  if constexpr (!kWeighted) {
    if (normed)
      return p.att <= 64 ? GNPDE_DEN_K(1, 2, true) : GNPDE_DEN_K(1, 8, true);
    if (p.att <= 32) return GNPDE_DEN_K(1, 1, false);
    if (p.att <= 64) return GNPDE_DEN_K(1, 2, false);
    if (p.att <= 128) return GNPDE_DEN_K(1, 4, false);
    return GNPDE_DEN_K(1, 8, false);
  } else {
    if (normed) {
      if (p.dim <= 128)
        return p.att <= 64 ? GNPDE_DEN_K(1, 2, true)
                           : GNPDE_DEN_K(1, 8, true);
      return p.att <= 64 ? GNPDE_DEN_K(2, 2, true) : GNPDE_DEN_K(2, 8, true);
    }
#define GNPDE_DEN(KD, KA) GNPDE_DEN_K(KD, KA, false)
    GNPDE_SYM_TILES(GNPDE_DEN)
#undef GNPDE_DEN
  }
#undef GNPDE_DEN_K
}

template <typename TC>
cudaError_t launch_den(const Pieces& pc, const Proj& p, const DenIO& io,
                       const void* xcol, const void* qtab, const void* ktab,
                       cudaStream_t s) {
  return io.ct != nullptr
             ? launch_den_walk<TC, true>(pc, p, io, xcol, qtab, ktab, s)
             : launch_den_walk<TC, false>(pc, p, io, xcol, qtab, ktab, s);
}

}  // namespace

// K12 over the row pieces piece_ptr, piece_row, piece_slot [n_pieces] and
// multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py, ColPieces of rowptr:
// Graph.row_pieces) and the CSR columns col. With project != 0 it first
// fills the scratch tables qtab and ktab [n_rows, att] (q = x Qw + qb from
// the row side x, k = xcol Kw + kb from the column table); with project ==
// 0 it reads them as an earlier launch on the same operands left them.
// out [n_rows, heads]: the column denominators, or with ct [n_rows, dim]
// each term weighted by ct[c] . xcol[n]. part [multi_ptr[n_multi], heads]
// holds the pieces' partial sums (nullable without multi-piece rows). vec:
// dim % 4 == 0 and xcol (x with kTablesF32) and ct 16-byte aligned. flags:
// bits 0-2 the score family, bit 3 squareplus; var and ls as
// gnpde_fused_rhs_fwd's; `tables` as launch_tables takes it (kTablesF32:
// xcol is ignored and x is the column table; with a bfloat16 column table
// its k table is bfloat16, kw and kb the bf16-rounded projection).
// Nullable: var, ls, ct.
extern "C" int gnpde_norm1_den(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* x, const void* xcol, const void* qw, const void* qb,
    const void* kw, const void* kb, const void* gmax, const void* var,
    const void* ls, const void* ct, void* qtab, void* ktab, void* out,
    void* part, int n_rows, int n_pieces, int n_multi, int dim, int att,
    int heads, int flags, int vec, int project, int tables, void* stream) {
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
    const DenIO io = {static_cast<const int*>(col),
                      static_cast<const float*>(ct), static_cast<float*>(out),
                      static_cast<float*>(part), vec};
    err = tables == kTablesF32
              ? launch_den<float>(pc, p, io, x, qtab, ktab, s)
              : launch_den<__nv_bfloat16>(pc, p, io, xcol, qtab, ktab, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_multi > 0) {
      norm1_den_merge_kernel<<<row_blocks(n_multi), kWarpsPerBlock * kWarp,
                               0, s>>>(pc, p, io);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
