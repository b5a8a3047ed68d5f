// Device code shared by the fused attention kernels (fused_fwd.cu: K6, K7;
// fused_rhs.cu: K9, K17; fused_bwd_rows.cuh: K8; norm1.cu: K12-K14): the
// per-head score families and their derivatives, the warp-level sums and
// the row walks of K9 / K14 and of K6 / K13; the node projections into the
// q and k scratch tables and
// the deterministic two-pass reduction of dKw / dKb are dense.cuh's. Each
// source that includes this header gets its own copy (anonymous
// namespace), so the sources still compile independently, one nvcc each.
//
// The score families are the reference's four and BLEND's split-space
// exp_kernel_beltrami, the TPU kernels' _kernel_scores / _kernel_scores_bwd
// (graph_neural_pde_tpu/ops/pallas/fused_rhs.py), which reach it through a
// block-diagonal head selector over packed (Qx | Qp) operands. Here the
// packing stays (q and k are [.., 2 A]: features, then positions) and the
// lane that owns head h reads both of its halves; the derivative loops see
// 2 H half-heads of d_k columns each, so a head's coefficients hold its
// position half's beside its own (kCoef floats). It costs a second row of
// A floats per gathered q or k and a second exp per head and edge.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-16f;
constexpr float kEpsNorm = 1e-5f;     // the reference's cosine/pearson floor

enum Score {
  kScaledDot = 0, kCosine = 1, kPearson = 2, kExpKernel = 3, kBeltrami = 4
};

// floats of coef a head holds: (P ds, Q ds, R ds, mq, mk) for its columns
// of q and k and, for exp_kernel_beltrami, the same five for its position
// half (the derivative loops index them by column: a / d_k)
constexpr int kCoef = 10;

struct Graph {
  const int* rowptr;
  const int* col;
  int n_rows;
};

struct Proj {            // what a row walk reads beside its rows and tables
  const float* gmax;
  const float* var;      // exp_kernel [1]; exp_kernel_beltrami [2]: the
  const float* ls;       // feature factor's, then the position factor's
  int dim, att, heads, score, square_plus;
};

// The score's scalars, read once by each warp.
struct ScoreParams {
  float var, ls, var_p, ls_p;
};

__device__ __forceinline__ ScoreParams score_params(const Proj& p) {
  ScoreParams s = {1.0f, 1.0f, 1.0f, 1.0f};
  if (p.score == kExpKernel || p.score == kBeltrami) {
    s.var = p.var[0];
    s.ls = p.ls[0];
  }
  if (p.score == kBeltrami) {
    s.var_p = p.var[1];
    s.ls_p = p.ls[1];
  }
  return s;
}

// The columns of q and k one head's score reads: att / heads, and for
// exp_kernel_beltrami, whose q and k pack the feature projections (Qx, Kx:
// heads slices of d_k) before the position projections (Qp, Kp), the d_k
// of each half. Head h reads q[h d_k ..] and q[att / 2 + h d_k ..].
__device__ __forceinline__ int head_width(const Proj& p) {
  return p.att / (p.score == kBeltrami ? 2 * p.heads : p.heads);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// sum over the first `heads` lanes in lane order, the same in every lane
__device__ __forceinline__ float head_sum(float v, int heads) {
  float s = 0.0f;
  for (int h = 0; h < heads; ++h) s += __shfl_sync(kFull, v, h);
  return s;
}

// out[a] = b[a] + sum_d xs[d] W[d, a] for a in [0, att): lanes span a, J
// accumulators a lane, W read as coalesced rows. xs and out are in shared
// memory; b may be null. With W = Kw^T [ATT, D] it is the transposed
// product dk Kw^T.
template <int J>
__device__ __forceinline__ void project_j(const float* xs,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b,
                                          int dim, int att, int lane,
                                          float* out) {
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = lane + kWarp * j;
    acc[j] = (b != nullptr && a < att) ? __ldg(b + a) : 0.0f;
  }
  for (int d = 0; d < dim; ++d) {
    const float xv = xs[d];
    const float* wr = w + static_cast<size_t>(d) * att + lane;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + kWarp * j < att) acc[j] = fmaf(xv, __ldg(wr + kWarp * j), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = lane + kWarp * j;
    if (a < att) out[a] = acc[j];
  }
  __syncwarp();
}

__device__ __forceinline__ void project(const float* xs, const float* w,
                                        const float* b, int dim, int att,
                                        int lane, float* out) {
  switch ((att + kWarp - 1) / kWarp) {
    case 1: project_j<1>(xs, w, b, dim, att, lane, out); break;
    case 2: project_j<2>(xs, w, b, dim, att, lane, out); break;
    case 3: project_j<3>(xs, w, b, dim, att, lane, out); break;
    case 4: project_j<4>(xs, w, b, dim, att, lane, out); break;
    case 5: project_j<5>(xs, w, b, dim, att, lane, out); break;
    case 6: project_j<6>(xs, w, b, dim, att, lane, out); break;
    case 7: project_j<7>(xs, w, b, dim, att, lane, out); break;
    default: project_j<8>(xs, w, b, dim, att, lane, out); break;
  }
}

__device__ __forceinline__ void load_row(const float* __restrict__ table,
                                         int row, int dim, int lane,
                                         float* out) {
  const float* src = table + static_cast<size_t>(row) * dim;
  for (int d = lane; d < dim; d += kWarp) out[d] = src[d];
}

// A bfloat16 row (the bf16 column table and k table of K6 and K9), widened
// to float32: read as __nv_bfloat162 pairs when the width is even (rows
// start on 4-byte boundaries then), so 32 lanes cover 64 values in one
// 128-byte transaction, and stored as float2 pairs where `out` lies on an
// 8-byte boundary (two values a lane in one conflict-free store).
__device__ __forceinline__ void load_row(
    const __nv_bfloat16* __restrict__ table, int row, int dim, int lane,
    float* out) {
  const __nv_bfloat16* src = table + static_cast<size_t>(row) * dim;
  if ((dim % 2) == 0) {
    const __nv_bfloat162* src2 = reinterpret_cast<const __nv_bfloat162*>(src);
    const bool pairs = (reinterpret_cast<size_t>(out) % 8) == 0;
    for (int j = lane; j < dim / 2; j += kWarp) {
      const float2 v = __bfloat1622float2(src2[j]);
      if (pairs) {
        reinterpret_cast<float2*>(out)[j] = v;
      } else {
        out[2 * j] = v.x;
        out[2 * j + 1] = v.y;
      }
    }
  } else {
    for (int d = lane; d < dim; d += kWarp) out[d] = __bfloat162float(src[d]);
  }
}

// What the backward needs of one head's score: s itself and, for
//   dq[a] = P (k[a] - mk) - Q (q[a] - mq),  dk[a] = P (q[a] - mq) - R (k[a] - mk)
// per unit ds, the coefficients (P, Q, R) and the head means (pearson);
// the squared distances for the exp_kernel scalars' derivatives. For
// exp_kernel_beltrami (P, Q, R) hold for the feature half and P = Q = R =
// cp for the position half.
struct HeadScore {
  float s, p, q, r, mq, mk, dist, cp, dist_p;
};

// Score of head `h` from q and k (shared or global memory): d_k serial
// terms a half in a fixed order. exp_kernel and exp_kernel_beltrami read
// their scalars from sc, the latter its position half at q + heads d_k:
//   s = var^2 exp(-|dx|^2 / 2 ls^2) var_p^2 exp(-|dp|^2 / 2 ls_p^2).
__device__ __forceinline__ HeadScore head_score(const float* q, const float* k,
                                                int h, int d_k, int heads,
                                                int score,
                                                const ScoreParams& sc) {
  HeadScore o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const float* qh = q + h * d_k;
  const float* kh = k + h * d_k;
  if (score == kScaledDot) {
    float sp = 0.0f;
    for (int j = 0; j < d_k; ++j) sp = fmaf(qh[j], kh[j], sp);
    const float root = sqrtf(static_cast<float>(d_k));
    o.s = sp / root;
    o.p = 1.0f / root;
    return o;
  }
  if (score == kExpKernel || score == kBeltrami) {
    float dist = 0.0f;
    for (int j = 0; j < d_k; ++j) {
      const float df = qh[j] - kh[j];
      dist = fmaf(df, df, dist);
    }
    float s = sc.var * sc.var * expf(-dist / (2.0f * sc.ls * sc.ls));
    o.dist = dist;
    if (score == kBeltrami) {
      const float* qp = qh + heads * d_k;
      const float* kp = kh + heads * d_k;
      float dist_p = 0.0f;
      for (int j = 0; j < d_k; ++j) {
        const float df = qp[j] - kp[j];
        dist_p = fmaf(df, df, dist_p);
      }
      s = s * (sc.var_p * sc.var_p) *
          expf(-dist_p / (2.0f * sc.ls_p * sc.ls_p));
      o.dist_p = dist_p;
      o.cp = s / (sc.ls_p * sc.ls_p);
    }
    o.s = s;
    o.p = o.q = o.r = s / (sc.ls * sc.ls);
    return o;
  }
  if (score == kPearson) {
    float sq = 0.0f, sk = 0.0f;
    for (int j = 0; j < d_k; ++j) {
      sq += qh[j];
      sk += kh[j];
    }
    o.mq = sq / d_k;
    o.mk = sk / d_k;
  }
  float sp = 0.0f, ss = 0.0f, kk = 0.0f;
  for (int j = 0; j < d_k; ++j) {
    const float a = qh[j] - o.mq, b = kh[j] - o.mk;
    sp = fmaf(a, b, sp);
    ss = fmaf(a, a, ss);
    kk = fmaf(b, b, kk);
  }
  const float rs = sqrtf(ss), rk = sqrtf(kk);
  const float ns = fmaxf(rs, kEpsNorm), nk = fmaxf(rk, kEpsNorm);
  o.s = sp / (ns * nk);
  o.p = 1.0f / (ns * nk);
  // the clamped norm has no derivative: its term drops out below the floor
  o.q = rs > kEpsNorm ? o.s / fmaxf(ss, kEpsNorm * kEpsNorm) : 0.0f;
  o.r = rk > kEpsNorm ? o.s / fmaxf(kk, kEpsNorm * kEpsNorm) : 0.0f;
  return o;
}

// u = exp(sm) or squareplus(sm), and du/dsm
__device__ __forceinline__ void u_duds(float sm, int square_plus, float* u,
                                       float* duds) {
  if (square_plus) {
    const float r = sqrtf(sm * sm + 4.0f);
    *u = (sm + r) * 0.5f;
    *duds = (1.0f + sm / r) * 0.5f;
  } else {
    *u = expf(sm);
    *duds = *u;
  }
}

// A row's scalar sums over its edges and heads: ds (for dgmax) and the
// terms of the score scalars' derivatives, (var, ls) for exp_kernel and
// (var, ls, var_p, ls_p) for exp_kernel_beltrami.
struct RowSums {
  float ds, e0, e1, e2, e3;
};
constexpr int kRowSums = 5;

// Lane h: from head h's score and the edge's cotangent factors, ds and the
// coefficients of dq / dk, written to coef[h] = (P ds, Q ds, R ds, mq, mk)
// (with `coef` already at head h) and, for exp_kernel_beltrami, to the
// position half's coef[heads + h]; adds the head's terms of the row's
// scalar sums. Returns u.
__device__ __forceinline__ float head_backward(const HeadScore& hs, float sm,
                                               int square_plus, float dot,
                                               float rg, float ctd,
                                               const ScoreParams& sc,
                                               int score, int heads,
                                               float* coef, RowSums* sums) {
  float u, duds;
  u_duds(sm, square_plus, &u, &duds);
  const float ds = fmaf(rg, dot, ctd) * duds;
  coef[0] = hs.p * ds;
  coef[1] = hs.q * ds;
  coef[2] = hs.r * ds;
  coef[3] = hs.mq;
  coef[4] = hs.mk;
  sums->ds += ds;
  if (score == kExpKernel || score == kBeltrami) {
    sums->e0 += ds * (2.0f * hs.s / sc.var);
    sums->e1 += ds * hs.s * hs.dist / (sc.ls * sc.ls * sc.ls);
  }
  if (score == kBeltrami) {
    float* cp = coef + 5 * heads;
    cp[0] = cp[1] = cp[2] = hs.cp * ds;
    cp[3] = cp[4] = 0.0f;
    sums->e2 += ds * (2.0f * hs.s / sc.var_p);
    sums->e3 += ds * hs.s * hs.dist_p / (sc.ls_p * sc.ls_p * sc.ls_p);
  }
  return u;
}

int row_blocks(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

Proj make_proj(const void* gmax, const void* var, const void* ls, int dim,
               int att, int heads, int flags) {
  Proj p;
  p.gmax = static_cast<const float*>(gmax);
  p.var = static_cast<const float*>(var);
  p.ls = static_cast<const float*>(ls);
  p.dim = dim;
  p.att = att;
  p.heads = heads;
  p.score = flags & 7;
  p.square_plus = (flags >> 3) & 1;
  return p;
}

Graph make_graph(const void* rowptr, const void* col, int n_rows) {
  Graph g;
  g.rowptr = static_cast<const int*>(rowptr);
  g.col = static_cast<const int*>(col);
  g.n_rows = n_rows;
  return g;
}

// ------------------------------------------------------------------------
// K9 (fused_rhs_bwd_sym, softmax over rows) and K14 (norm1_bwd, over
// columns): the backward over a SYMMETRIC edge multiset, in place of the
// TPU kernels P13 _bwd_sym_kernel and P16 _norm1_bwd_kernel
// (graph_neural_pde_tpu/ops/pallas/fused_rhs.py). Each edge (n, c) of row
// n also evaluates its reverse edge (c, n) from node rows gathered at c,
// so that x[col]'s cotangent and dk land on the resident row and nothing
// is scattered (P13's and P16's one-pass design: no per-edge array, no
// reverse-edge map). Per edge the walk gathers x_c and ct_ax[c] (D
// values each), k_c and q_c (ATT each) and the node's (recip_p, ct_den)
// of every head, and scores two edges.
//
// What bounds it on the H100: the latency of those gathers and the
// per-edge chain behind them, times the warps an SM keeps in flight. The
// first version gathered each row into shared memory by a loop of its
// own, so an edge waited on six memory round trips in series
// (col[e], four rows, then the 2 H scalars), and then scored the heads on
// H lanes, d_k serial terms through shared memory each: 80 registers, 24
// resident warps an SM, 4.24 ms at arxiv scale for the walk alone, 35x
// the 0.12 ms bound of the whole call (PERF.md, section 6).
//
// Design (register-resident, lane-parallel):
// * A warp walks one edge at a time. In D tile t lane l owns the four
//   columns 4 (32 t + l) .. + 3 of every D-wide row, read as one 16-byte
//   load (8 bytes for a bfloat16 table), in A tile j the column 32 j + l
//   of every q or k row: KD and KA tiles, template sizes. The resident
//   row's x_n, ct_ax[n], q_n, k_n and its accumulators live in registers;
//   an edge's four rows and its (recip_p, ct_den) row (one [N, H] float2
//   table the wrapper packs) are loaded into registers together, one round
//   trip, and the column indices of 32 edges come in one coalesced load.
// * Heads are scored on all lanes: a head's terms are summed over its d_k
//   lanes by a segmented butterfly (both edges' sums in flight together),
//   so every lane holds its head's score, forms u, du/ds and the
//   coefficients of its own column, and the heads' sums (the reverse
//   edges' weight sum_h u recip_p, dgmax's ds and the score scalars'
//   terms) are a fold over the head groups. exp_kernel_beltrami's
//   position half reads its head's feature distance from the tile A / 2
//   columns on (or the lane A / 2 on, when A <= 32). A d_k that is not a
//   power of two, or a beltrami half that fits neither, sums each head's
//   terms in column order through a per-warp buffer of A floats.
// * Registers set the warps in flight, so a kernel holds one class of
//   score families (cosine_sim and pearson, kNormed, need six sums and
//   four means a tile; the others two or four) and its launch bounds cap
//   the registers (sym_min_blocks).
// * Rows are cut into pieces of at most COL_PIECE edges (ops/graph.py,
//   column_pieces of rowptr, which on a symmetric graph is the CSC view's
//   own column_pieces); a warp walks a piece, a row of one piece is
//   finished there, a longer row's pieces write partial sums that the
//   merge pass (sym_merge_rows) adds in piece order.
// Each output is summed in a fixed order (edges in a piece, then pieces in
// order; every butterfly and fold is the same on every run): no atomics,
// two launches agree bit for bit. The row's product (sum dk) Kw^T is read by
// lanes spanning D; dKw / dKb take two passes (dense.cuh's
// outer_reduce_kernel over the per-node dk sums, then the wrapper's sum).

// The pieces of a walk's rows or columns (ops/graph.py, ColPieces):
// piece p holds the edges [ptr[p], ptr[p + 1]) of row or column col[p];
// slot[p] >= 0 is its row of partial sums when that row has several
// pieces, and the second pass adds multi_col[m]'s partial rows
// [multi_ptr[m], multi_ptr[m + 1]).
struct Pieces {
  const int *ptr, *col, *slot, *multi_col, *multi_ptr;
  int n_pieces, n_multi;
};

// What K9 and K14's walk reads beside its pieces and tables, and writes
struct SymIO {
  const int* col;          // each edge's column
  const float* ct_ax;      // [N, D]
  const float2* rc;        // [N, H]: (recip_p, ct_den)
  const float* kw_t;       // Kw^T [ATT, D]
  float* dq;               // [N, ATT]
  float* dxrow;            // [N, D]
  float* dkn;              // [N, ATT]: dk summed over each node's reverse edges
  float* row_sums;         // [N, kRowSums]
  float* part;             // [slots, D + 2 ATT + kRowSums]: pieces' partials
  int vec;                 // D % 4 == 0 and the D-wide rows 16-byte aligned
};

__host__ __device__ constexpr int sym_part_floats(int dim, int att) {
  return dim + 2 * att + kRowSums;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// columns c0 .. c0 + 3 of a D-wide row (zero beyond D): one 16-byte load
// where `vec` (D % 4 == 0, aligned rows), else four guarded loads
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c0,
                                        int dim, bool vec) {
  if (vec)
    return c0 < dim ? __ldg(reinterpret_cast<const float4*>(row + c0))
                    : zero4();
  float4 v;
  v.x = c0 < dim ? __ldg(row + c0) : 0.0f;
  v.y = c0 + 1 < dim ? __ldg(row + c0 + 1) : 0.0f;
  v.z = c0 + 2 < dim ? __ldg(row + c0 + 2) : 0.0f;
  v.w = c0 + 3 < dim ? __ldg(row + c0 + 3) : 0.0f;
  return v;
}

// the same of a bfloat16 row, widened: one 8-byte load where `vec`
__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ row,
                                        int c0, int dim, bool vec) {
  if (vec) {
    if (c0 >= dim) return zero4();
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + c0));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float4 v;
  v.x = c0 < dim ? __bfloat162float(row[c0]) : 0.0f;
  v.y = c0 + 1 < dim ? __bfloat162float(row[c0 + 1]) : 0.0f;
  v.z = c0 + 2 < dim ? __bfloat162float(row[c0 + 2]) : 0.0f;
  v.w = c0 + 3 < dim ? __bfloat162float(row[c0 + 3]) : 0.0f;
  return v;
}

__device__ __forceinline__ void store4(float* row, int c0, int dim, bool vec,
                                       float4 v) {
  if (vec) {
    if (c0 < dim) *reinterpret_cast<float4*>(row + c0) = v;
    return;
  }
  if (c0 < dim) row[c0] = v.x;
  if (c0 + 1 < dim) row[c0 + 1] = v.y;
  if (c0 + 2 < dim) row[c0 + 2] = v.z;
  if (c0 + 3 < dim) row[c0 + 3] = v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 axpy4(float s, float4 x, float4 y) {
  return make_float4(fmaf(s, x.x, y.x), fmaf(s, x.y, y.y), fmaf(s, x.z, y.z),
                     fmaf(s, x.w, y.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// How a warp sums a head's terms: over d_k lanes of one tile (d_k a power
// of two <= 32), over the 32 lanes of d_k / 32 tiles (a power of two >
// 32), or through the warp's buffer (any other d_k, or a beltrami position
// half neither a tile nor a lane offset away).
enum HeadSum { kLaneHeads = 0, kTileHeads = 1, kBufferHeads = 2 };

// A lane's view of the heads, tile by tile (bit j of each mask for tile j)
template <int KA>
struct LaneHeads {
  int d_k, mode, span;     // span: tiles a head covers (kTileHeads)
  int fold;                // the fold over head groups starts at this offset
  int half;                // beltrami: the position half's tile offset, or 0
                           // (A <= 32: its lane offset A / 2)
  unsigned valid;          // the column is < A
  unsigned feat;           // and in a feature slice (every slice but
                           // beltrami's position halves)
  unsigned once;           // and counts its head once in the fold
  int head[KA];            // the head of the column's slice
};

template <int KA>
__device__ __forceinline__ LaneHeads<KA> make_heads(const Proj& p, int lane) {
  LaneHeads<KA> h;
  const int A = p.att, H = p.heads;
  h.d_k = head_width(p);
  const bool pow2 = (h.d_k & (h.d_k - 1)) == 0;
  const bool belt = p.score == kBeltrami;
  const bool paired = !belt || (A / 2) % kWarp == 0 || A <= kWarp;
  h.mode = !pow2 || !paired ? kBufferHeads
                            : (h.d_k <= kWarp ? kLaneHeads : kTileHeads);
  h.span = h.mode == kTileHeads ? h.d_k / kWarp : 1;
  h.fold = h.mode == kLaneHeads ? h.d_k : (h.mode == kTileHeads ? kWarp : 1);
  h.half = belt && A > kWarp ? A / 2 / kWarp : 0;
  h.valid = h.feat = h.once = 0u;
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane, slice = a / h.d_k;
    const bool v = a < A, f = v && slice < H;
    const bool first = h.mode == kLaneHeads  ? true
                       : h.mode == kTileHeads ? j % h.span == 0
                                              : a % h.d_k == 0;
    h.valid |= static_cast<unsigned>(v) << j;
    h.feat |= static_cast<unsigned>(f) << j;
    h.once |= static_cast<unsigned>(f && first) << j;
    h.head[j] = v ? slice % H : 0;
  }
  return h;
}

__device__ __forceinline__ bool bit(unsigned mask, int j) {
  return (mask >> j) & 1u;
}

// In place, for each of NV values a tile: the sum of the value over the
// lane's slice (d_k columns), the same in every lane of the slice. buf:
// the warp's A floats (kBufferHeads only).
template <int KA, int NV>
__device__ __forceinline__ void slice_sums(const LaneHeads<KA>& h,
                                           float (&v)[NV][KA], float* buf,
                                           int lane, int att) {
  if (h.mode == kBufferHeads) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j < KA; ++j)
        if (bit(h.valid, j)) buf[kWarp * j + lane] = v[i][j];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        const int a = kWarp * j + lane;
        float s = 0.0f;
        if (a < att) {
          const float* b = buf + (a / h.d_k) * h.d_k;
          for (int t = 0; t < h.d_k; ++t) s += b[t];
        }
        v[i][j] = s;
      }
      __syncwarp();
    }
    return;
  }
  if (h.mode == kTileHeads) {             // a head's tiles, in the lane first
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s[KA];
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        s[j] = 0.0f;
#pragma unroll
        for (int t = 0; t < KA; ++t)
          if (t / h.span == j / h.span) s[j] += v[i][t];
      }
#pragma unroll
      for (int j = 0; j < KA; ++j) v[i][j] = s[j];
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        const float t = __shfl_xor_sync(kFull, v[i][j], o);
        if (o < h.d_k) v[i][j] += t;
      }
  }
}

// For each tile, the slice sums s of the lane's beltrami partner half:
// the same head's position half for a feature column, and back
template <int KA>
__device__ __forceinline__ void partner(const LaneHeads<KA>& h,
                                        const float (&s)[KA], float (&out)[KA],
                                        float* buf, int lane,
                                        int att) {
  const int half = att / 2;
  if (h.mode == kBufferHeads) {
#pragma unroll
    for (int j = 0; j < KA; ++j)
      if (bit(h.valid, j)) buf[kWarp * j + lane] = s[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const int a = kWarp * j + lane;
      out[j] = a < att ? buf[bit(h.feat, j) ? a + half : a - half] : 0.0f;
    }
    __syncwarp();
  } else if (h.half > 0) {                // the same lane, h.half tiles on
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const int jp = bit(h.feat, j) ? j + h.half : j - h.half;
      float v = 0.0f;
#pragma unroll
      for (int t = 0; t < KA; ++t)
        if (t == jp) v = s[t];
      out[j] = v;
    }
  } else {                                // A <= G: A / 2 lanes on
    const bool f = bit(h.feat, 0);
    const int src = lane < att ? (f ? lane + half : lane - half) : lane;
#pragma unroll
    for (int j = 0; j < KA; ++j)
      out[j] = __shfl_sync(kFull, s[j], src);
  }
}

// the sum over the heads of a per-lane value: a fold over the slices of
// the warp (lanes d_k apart) after each lane added up its tiles' `once`
// values; the same in every lane
__device__ __forceinline__ float head_fold(float v, int fold) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float t = __shfl_xor_sync(kFull, v, o);
    if (o >= fold) v += t;
  }
  return v;
}

// The score's constants, read once by each warp: 1 / sqrt(d_k), 1 / d_k,
// and for exp_kernel (the position factor's for exp_kernel_beltrami, _p)
// -1 / (2 ls^2), 1 / ls^2, 1 / ls^3 and 2 / var, var^2
struct ScoreConsts {
  float root, inv_dk, ex, il2, il3, iv2, v2, ex_p, il2_p, il3_p, iv2_p,
      v2_p;
};

__device__ __forceinline__ ScoreConsts score_consts(const ScoreParams& sc,
                                                    int d_k) {
  ScoreConsts c;
  c.root = 1.0f / sqrtf(static_cast<float>(d_k));
  c.inv_dk = 1.0f / static_cast<float>(d_k);
  c.ex = -1.0f / (2.0f * sc.ls * sc.ls);
  c.il2 = 1.0f / (sc.ls * sc.ls);
  c.il3 = c.il2 / sc.ls;
  c.iv2 = 2.0f / sc.var;
  c.v2 = sc.var * sc.var;
  c.ex_p = -1.0f / (2.0f * sc.ls_p * sc.ls_p);
  c.il2_p = 1.0f / (sc.ls_p * sc.ls_p);
  c.il3_p = c.il2_p / sc.ls_p;
  c.iv2_p = 2.0f / sc.var_p;
  c.v2_p = sc.var_p * sc.var_p;
  return c;
}

// The slice sums an edge's two scores need, all heads and both
// directions at once (forward: q_n against k_c; reverse: q_c against
// k_n), so that their butterflies are in flight together. Without
// kNormed: scaled_dot v[0..1] the two dot products; exp_kernel(_beltrami)
// v[0..1] the squared distances and, for beltrami, v[2..3] the partner
// half's. With kNormed (cosine_sim, pearson): v[0..2] (q.k, q.q, k.k)
// forward and v[3..5] reverse over the centred columns, pearson's means
// m[0..3] (q_n, k_c, q_c, k_n), else 0.
template <int KA, bool kNormed>
__device__ __forceinline__ void edge_sums(
    const LaneHeads<KA>& h, const Proj& p, const ScoreConsts& k,
    const float (&qn)[KA], const float (&kc)[KA], const float (&qc)[KA],
    const float (&kn)[KA], float* buf, int lane,
    float (&v)[kNormed ? 6 : 4][KA], float (&m)[4][KA]) {
  const int A = p.att;
  if constexpr (!kNormed) {
    float t[2][KA];
    const bool dot = p.score == kScaledDot;
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const float df = qn[j] - kc[j], dr = qc[j] - kn[j];
      t[0][j] = dot ? qn[j] * kc[j] : df * df;
      t[1][j] = dot ? qc[j] * kn[j] : dr * dr;
    }
    slice_sums<KA, 2>(h, t, buf, lane, A);
    if (p.score == kBeltrami) {
      float w[KA];
      partner<KA>(h, t[0], w, buf, lane, A);
#pragma unroll
      for (int j = 0; j < KA; ++j) v[2][j] = w[j];
      partner<KA>(h, t[1], w, buf, lane, A);
#pragma unroll
      for (int j = 0; j < KA; ++j) v[3][j] = w[j];
    }
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      v[0][j] = t[0][j];
      v[1][j] = t[1][j];
    }
  } else {
    if (p.score == kPearson) {              // the head means first
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        m[0][j] = qn[j];
        m[1][j] = kc[j];
        m[2][j] = qc[j];
        m[3][j] = kn[j];
      }
      slice_sums<KA, 4>(h, m, buf, lane, A);
#pragma unroll
      for (int j = 0; j < KA; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i][j] *= k.inv_dk;
    }
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const float a = qn[j] - m[0][j], b = kc[j] - m[1][j];
      const float c = qc[j] - m[2][j], d = kn[j] - m[3][j];
      v[0][j] = a * b;
      v[1][j] = a * a;
      v[2][j] = b * b;
      v[3][j] = c * d;
      v[4][j] = c * c;
      v[5][j] = d * d;
    }
    slice_sums<KA, 6>(h, v, buf, lane, A);
  }
}

// One direction's score at one lane's column and, per unit ds, the
// coefficients of dq = P (k - mk) - Q (q - mq) and dk = P (q - mq) -
// R (k - mk) (exp_kernel_beltrami's position half: P = Q = R = s / ls_p^2),
// and the distances of the exp_kernel scalars' derivatives
struct TileScore {
  float s, p, q, r, dist, dist_p;
};

// v: the column's slice sums (edge_sums); e: 0 the forward direction, 1
// the reverse; feat: the column is in a feature slice (every column but
// beltrami's position halves)
template <bool kNormed>
__device__ __forceinline__ TileScore tile_score(int score,
                                                const ScoreConsts& k,
                                                const float* v, int e,
                                                bool feat) {
  TileScore o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (!kNormed) {
    if (score == kScaledDot) {
      o.s = v[e] * k.root;
      o.p = k.root;
      return o;
    }
    const bool belt = score == kBeltrami;
    const float own = v[e], other = belt ? v[2 + e] : 0.0f;
    o.dist = feat ? own : other;
    o.s = k.v2 * expf(o.dist * k.ex);
    if (belt) {
      o.dist_p = feat ? other : own;
      o.s = o.s * k.v2_p * expf(o.dist_p * k.ex_p);
    }
    o.p = o.q = o.r = o.s * (feat ? k.il2 : k.il2_p);
    return o;
  } else {
    const float sp = v[3 * e], ss = v[3 * e + 1], kk = v[3 * e + 2];
    const float rs = sqrtf(ss), rk = sqrtf(kk);
    const float ns = fmaxf(rs, kEpsNorm), nk = fmaxf(rk, kEpsNorm);
    o.p = 1.0f / (ns * nk);
    o.s = sp * o.p;
    // the clamped norm has no derivative: its term drops out below it
    o.q = rs > kEpsNorm ? o.s / fmaxf(ss, kEpsNorm * kEpsNorm) : 0.0f;
    o.r = rk > kEpsNorm ? o.s / fmaxf(kk, kEpsNorm * kEpsNorm) : 0.0f;
    return o;
  }
}

// The end of a row: dq and the summed dk written, dxrow[n] = dxa + (sum
// dk) Kw^T with lanes spanning D (dk broadcast from its lane, Kw^T's rows
// read as coalesced 16-byte loads), and the row's scalar sums
template <int KD, int KA>
__device__ __forceinline__ void finish_row(const SymIO& io, int n, int D,
                                           int A, int lane,
                                           const float4 (&dxa)[KD],
                                           const float (&dqa)[KA],
                                           const float (&dka)[KA],
                                           const float (&sums)[kRowSums]) {
  const bool vec = io.vec;
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane;
    if (a < A) {
      io.dq[static_cast<size_t>(n) * A + a] = dqa[j];
      io.dkn[static_cast<size_t>(n) * A + a] = dka[j];
    }
  }
  float4 acc[KD];
#pragma unroll
  for (int t = 0; t < KD; ++t) acc[t] = zero4();
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int cols = min(kWarp, A - kWarp * j);   // the tile's valid columns
#pragma unroll 8
    for (int l = 0; l < cols; ++l) {
      const float v = __shfl_sync(kFull, dka[j], l);
      const float* wr = io.kw_t + static_cast<size_t>(kWarp * j + l) * D;
#pragma unroll
      for (int t = 0; t < KD; ++t)
        acc[t] = axpy4(v, load4(wr, 4 * (kWarp * t + lane), D, vec), acc[t]);
    }
  }
  float* out = io.dxrow + static_cast<size_t>(n) * D;
#pragma unroll
  for (int t = 0; t < KD; ++t)
    store4(out, 4 * (kWarp * t + lane), D, vec, add4(dxa[t], acc[t]));
  if (lane == 0) {
    float* rs = io.row_sums + static_cast<size_t>(n) * kRowSums;
#pragma unroll
    for (int i = 0; i < kRowSums; ++i) rs[i] = sums[i];
  }
}

// An edge's gathered rows at its column c: x_c and ct_ax[c] (lanes
// spanning D), k_c, q_c and (recip_p, ct_den) of the column's head (lanes
// spanning A), every load issued before the first use
template <int KD, int KA>
struct EdgeRows {
  float4 xc[KD], ctc[KD];
  float kc[KA], qc[KA];
  float2 rcc[KA];
};

template <int KD, int KA, typename TC>
__device__ __forceinline__ EdgeRows<KD, KA> load_edge(
    int c, int lane, int D, int A, int H, bool vec, const LaneHeads<KA>& h,
    const TC* __restrict__ xcol, const float* __restrict__ qtab,
    const TC* __restrict__ ktab, const SymIO& io) {
  EdgeRows<KD, KA> e;
#pragma unroll
  for (int t = 0; t < KD; ++t) {
    const int c0 = 4 * (kWarp * t + lane);
    e.xc[t] = load4(xcol + static_cast<size_t>(c) * D, c0, D, vec);
    e.ctc[t] = load4(io.ct_ax + static_cast<size_t>(c) * D, c0, D, vec);
  }
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane;
    const bool v = bit(h.valid, j);
    e.kc[j] = v ? widen(ktab[static_cast<size_t>(c) * A + a]) : 0.0f;
    e.qc[j] = v ? __ldg(qtab + static_cast<size_t>(c) * A + a) : 0.0f;
    e.rcc[j] = v ? __ldg(io.rc + static_cast<size_t>(c) * H + h.head[j])
                 : make_float2(0.0f, 0.0f);
  }
  return e;
}

// Blocks of K9 and K14's walk an SM keeps resident, for __launch_bounds__:
// 6, 5 and 4 (registers capped at 80, 102 and 128 a thread, a few bytes
// spilled) for 1, 2 and 4 attention tiles; measured faster at every shape
// of PERF.md than the uncapped 95, 123 and 152 registers (24, 20 and 16
// resident warps instead of 20, 16 and 12; PERF.md, section 6). Eight
// tiles keep their registers.
__host__ __device__ constexpr int sym_min_blocks(int ka) {
  return ka == 1 ? 6 : ka == 2 ? 5 : ka == 4 ? 4 : 1;
}

// One piece of a row n of the symmetric backward (see the note above):
// kColumnNorm swaps the softmax groups (K14: the edge (n, c) reads
// recip_p and ct_den at its column c, its reverse (c, n) at n); kNormed
// takes cosine_sim and pearson, else scaled_dot, exp_kernel and
// exp_kernel_beltrami; xcol is the column-side table the values and k
// come from (x itself, or the bfloat16 copy K9 and K14 read under the
// bf16 payload, whose k table is bfloat16 too); the row side is the q
// table. smem: the block's dynamic shared memory, A floats a warp
// (kBufferHeads only).
template <bool kColumnNorm, typename TC, int KD, int KA, bool kNormed>
__device__ __forceinline__ void sym_backward_piece(
    float* smem, Pieces pc, Proj p, SymIO io, const TC* __restrict__ xcol,
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
  constexpr int kV = kNormed ? 6 : 4;           // slice sums an edge

  // the resident row n, and its accumulators
  float4 xn[KD], cta[KD], dxa[KD];
#pragma unroll
  for (int t = 0; t < KD; ++t) {
    const int c0 = 4 * (kWarp * t + lane);
    xn[t] = load4(xcol + static_cast<size_t>(n) * D, c0, D, vec);
    cta[t] = load4(io.ct_ax + static_cast<size_t>(n) * D, c0, D, vec);
    dxa[t] = zero4();
  }
  float qn[KA], kn[KA], dqa[KA], dka[KA];
  float2 rn[KA];
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane;
    const bool v = bit(h.valid, j);
    qn[j] = v ? __ldg(qtab + static_cast<size_t>(n) * A + a) : 0.0f;
    kn[j] = v ? widen(ktab[static_cast<size_t>(n) * A + a]) : 0.0f;
    rn[j] = v ? __ldg(io.rc + static_cast<size_t>(n) * H + h.head[j])
              : make_float2(0.0f, 0.0f);
    dqa[j] = dka[j] = 0.0f;
  }
  float sums[kRowSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int base = start; base < end; base += kWarp) {
    const int cnt = min(kWarp, end - base);
    const int cols = lane < cnt ? __ldg(io.col + base + lane) : n;
    for (int i = 0; i < cnt; ++i) {
      const EdgeRows<KD, KA> er = load_edge<KD, KA>(
          __shfl_sync(kFull, cols, i), lane, D, A, H, vec, h, xcol, qtab,
          ktab, io);
      float dot = 0.0f, dot_r = 0.0f;
#pragma unroll
      for (int t = 0; t < KD; ++t) {
        dot = dot4(cta[t], er.xc[t], dot);       // ct_ax[n] . x_c
        dot_r = dot4(er.ctc[t], xn[t], dot_r);   // ct_ax[c] . x_n
      }
      dot = warp_sum(dot);
      dot_r = warp_sum(dot_r);
      float v[kV][KA] = {}, m[4][KA] = {};
      edge_sums<KA, kNormed>(h, p, skc, qn, er.kc, er.qc, kn, buf, lane, v,
                             m);
      float w = 0.0f;                         // the reverse edges' weight
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        float vj[kV];
#pragma unroll
        for (int i2 = 0; i2 < kV; ++i2) vj[i2] = v[i2][j];
        const bool ft = bit(h.feat, j);
        const TileScore cf = tile_score<kNormed>(p.score, skc, vj, 0, ft);
        const TileScore cr = tile_score<kNormed>(p.score, skc, vj, 1, ft);
        // the softmax group of the edge (n, c) is its row n, that of its
        // reverse (c, n) the row c; normalised over columns, the other way
        // round
        const float2 rf = kColumnNorm ? er.rcc[j] : rn[j];
        const float2 rr = kColumnNorm ? rn[j] : er.rcc[j];
        float u, duds;
        u_duds(cf.s - gmax, p.square_plus, &u, &duds);
        const float ds = fmaf(rf.x, dot, rf.y) * duds;
        float ur, dudr;
        u_duds(cr.s - gmax, p.square_plus, &ur, &dudr);
        const float dr = fmaf(rr.x, dot_r, rr.y) * dudr;
        dqa[j] += cf.p * ds * (er.kc[j] - m[1][j]) -
                  cf.q * ds * (qn[j] - m[0][j]);
        dka[j] += cr.p * dr * (er.qc[j] - m[2][j]) -
                  cr.r * dr * (kn[j] - m[3][j]);
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
          w += rr.x * ur;
        }
      }
      w = head_fold(w, h.fold);               // sum_h u_h recip_p[c, h]
#pragma unroll
      for (int t = 0; t < KD; ++t) dxa[t] = axpy4(w, er.ctc[t], dxa[t]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowSums; ++i) sums[i] = head_fold(sums[i], h.fold);
  if (slot < 0) {
    finish_row<KD, KA>(io, n, D, A, lane, dxa, dqa, dka, sums);
    return;
  }
  // a piece of a longer row: its partial sums
  float* pr = io.part + static_cast<size_t>(slot) * sym_part_floats(D, A);
#pragma unroll
  for (int t = 0; t < KD; ++t)
    store4(pr, 4 * (kWarp * t + lane), D, false, dxa[t]);
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int a = kWarp * j + lane;
    if (a < A) {
      pr[D + a] = dqa[j];
      pr[D + A + a] = dka[j];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowSums; ++i) pr[D + 2 * A + i] = sums[i];
  }
}

// A row of several pieces: their partial sums added in piece order, then
// finished as a row of one piece is (a warp a row; the second pass of K9
// and K14 when a row has several pieces)
template <int KD, int KA>
__device__ __forceinline__ void sym_merge_rows(Pieces pc, Proj p, SymIO io) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= pc.n_multi) return;                // whole warp leaves together
  const int D = p.dim, A = p.att, W = sym_part_floats(D, A);
  const int n = pc.multi_col[m];
  float4 dxa[KD];
  float dqa[KA], dka[KA];
  float sums[kRowSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < KD; ++t) dxa[t] = zero4();
#pragma unroll
  for (int j = 0; j < KA; ++j) dqa[j] = dka[j] = 0.0f;
  for (int s = pc.multi_ptr[m]; s < pc.multi_ptr[m + 1]; ++s) {
    const float* pr = io.part + static_cast<size_t>(s) * W;
#pragma unroll
    for (int t = 0; t < KD; ++t)
      dxa[t] = add4(dxa[t], load4(pr, 4 * (kWarp * t + lane), D, false));
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const int a = kWarp * j + lane;
      if (a < A) {
        dqa[j] += pr[D + a];
        dka[j] += pr[D + A + a];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowSums; ++i) sums[i] += pr[D + 2 * A + i];
  }
  finish_row<KD, KA>(io, n, D, A, lane, dxa, dqa, dka, sums);
}

// K9 and K14's walk, the merge of multi-piece rows and the first pass of
// dKw / dKb, once the q and k tables hold every node's projections. Walk
// names each file's __global__ wrappers: Walk::walk<TC, KD, KA, kNormed>()
// and Walk::merge<KD, KA>().
template <typename Walk, typename TC, int KD, int KA, bool kNormed>
cudaError_t launch_walk_k(const Pieces& pc, const Proj& p, const SymIO& io,
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

// the register tiles: KD = ceil(D / 128) <= 2, KA = ceil(att / 32) rounded
// up to 1, 2, 4 or 8 (cosine_sim and pearson, kNormed: 2 or 8)
#define GNPDE_SYM_TILES(CALL)                                                \
  if (p.dim <= 128) {                                                        \
    if (p.att <= 32) return CALL(1, 1);                                      \
    if (p.att <= 64) return CALL(1, 2);                                      \
    if (p.att <= 128) return CALL(1, 4);                                     \
    return CALL(1, 8);                                                       \
  }                                                                          \
  if (p.att <= 32) return CALL(2, 1);                                        \
  if (p.att <= 64) return CALL(2, 2);                                        \
  if (p.att <= 128) return CALL(2, 4);                                       \
  return CALL(2, 8);

template <typename Walk, typename TC>
cudaError_t launch_walk(const Pieces& pc, const Proj& p, const SymIO& io,
                        const void* xcol, const void* qtab, const void* ktab,
                        cudaStream_t s) {
  if (p.score == kCosine || p.score == kPearson) {
#define GNPDE_WALK_NORMED(KD, KA) \
  launch_walk_k<Walk, TC, KD, KA, true>(pc, p, io, xcol, qtab, ktab, s)
    if (p.dim <= 128)
      return p.att <= 64 ? GNPDE_WALK_NORMED(1, 2) : GNPDE_WALK_NORMED(1, 8);
    return p.att <= 64 ? GNPDE_WALK_NORMED(2, 2) : GNPDE_WALK_NORMED(2, 8);
#undef GNPDE_WALK_NORMED
  }
#define GNPDE_WALK(KD, KA) \
  launch_walk_k<Walk, TC, KD, KA, false>(pc, p, io, xcol, qtab, ktab, s)
  GNPDE_SYM_TILES(GNPDE_WALK)
#undef GNPDE_WALK
}

template <typename Walk, int KD, int KA>
cudaError_t launch_merge_k(const Pieces& pc, const Proj& p, const SymIO& io,
                           cudaStream_t s) {
  Walk::template merge<KD, KA>()<<<row_blocks(pc.n_multi),
                                   kWarpsPerBlock * kWarp, 0, s>>>(pc, p, io);
  return cudaGetLastError();
}

template <typename Walk>
cudaError_t launch_merge(const Pieces& pc, const Proj& p, const SymIO& io,
                         cudaStream_t s) {
  if (pc.n_multi == 0) return cudaSuccess;
#define GNPDE_MERGE(KD, KA) launch_merge_k<Walk, KD, KA>(pc, p, io, s)
  GNPDE_SYM_TILES(GNPDE_MERGE)
#undef GNPDE_MERGE
}

// The launches behind K9 and K14: the q and k tables (unless the caller
// says they are filled already: project = 0), the walk over the row
// pieces, the merge of multi-piece rows and the first pass of the dKw /
// dKb reduction over the per-node dk sums and the column table. `tables`
// as launch_tables takes it; with kTablesF32, xcol is x. The walk reads x
// only as xcol (x may be bfloat16).
template <typename Walk>
int launch_sym_backward(
    int project, int tables, const void* piece_ptr, const void* piece_row,
    const void* piece_slot, const void* multi_row, const void* multi_ptr,
    const void* col, const void* x, const void* xcol, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* ct_ax, const void* rc,
    const void* kw_t, void* qtab, void* ktab, void* dq, void* dxrow,
    void* dkn, void* row_sums, void* part, void* partials, int n_rows,
    int n_pieces, int n_multi, int dim, int att, int heads, int flags,
    int reduce_blocks, int vec, void* stream) {
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
    const SymIO io = {static_cast<const int*>(col),
                      static_cast<const float*>(ct_ax),
                      static_cast<const float2*>(rc),
                      static_cast<const float*>(kw_t),
                      static_cast<float*>(dq),
                      static_cast<float*>(dxrow),
                      static_cast<float*>(dkn),
                      static_cast<float*>(row_sums),
                      static_cast<float*>(part),
                      vec};
    const void* table = tables == kTablesF32 ? x : xcol;
    err = tables == kTablesF32
              ? launch_walk<Walk, float>(pc, p, io, table, qtab, ktab, s)
              : launch_walk<Walk, __nv_bfloat16>(pc, p, io, table, qtab,
                                                 ktab, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_merge<Walk>(pc, p, io, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tables == kTablesF32)
      launch_outer_reduce(static_cast<const float*>(table), nullptr,
                          static_cast<const float*>(dkn),
                          static_cast<float*>(partials), n_rows,
                          reduce_blocks, dim, att, s);
    else
      launch_outer_reduce(static_cast<const __nv_bfloat16*>(table), nullptr,
                          static_cast<const float*>(dkn),
                          static_cast<float*>(partials), n_rows,
                          reduce_blocks, dim, att, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// K6 (fused_rhs_fwd, the softmax over rows) and K13 (norm1_fwd, over
// columns): the forward walk over row pieces, in place of the TPU kernels
// P7 _rhs_kernel_ax and P15 _norm1_fwd_kernel
// (graph_neural_pde_tpu/ops/pallas/fused_rhs.py). Per edge (n, c) of row n
// the walk gathers x_c (D values) and k_c (ATT), scores every head against
// the resident q_n and adds u_eh x_c into the row's sums: K6 one sum a
// head (the numerators num[n, h], beside the denominators den[n, h]), K13
// one sum, each edge weighted by sum_h u_eh recip[c, h] (1 / den at the
// column, gathered with the edge's rows).
//
// What bounds it on the H100: the latency of those gathers and of the
// chain behind them, times the warps an SM keeps in flight. The first
// version gave a warp a whole row and copied each edge's x_c and k_c into
// shared memory by a loop of its own after col[e] (K13 read recip[c] only
// after the score), scored the heads on H lanes, d_k serial FMAs through
// shared memory each, and kept K6's [H, D] numerators in shared memory:
// 1.53 ms at arxiv scale against a bound of 0.107 (PERF.md, section 6).
//
// Design (one direction of sym_backward_piece's):
// * One warp walks one piece of at most COL_PIECE edges of a row
//   (Graph.row_pieces), one edge at a time, in K9's lane layout (KD
//   16-byte column groups of a D-wide row, KA columns of a q or k row a
//   lane). q_n and every sum live in registers; an edge's x_c, k_c and
//   its per-head scalar (K6's shift, K13's recip[c, h]) are loaded
//   together, the column indices of 32 edges in one coalesced load.
// * A head's terms are summed over its lanes by slice_sums' segmented
//   butterfly (both score shapes: the scaled dot or squared distance, and
//   cosine_sim's and pearson's three centred sums); lane h < H then takes
//   head h's sums by one shuffle a tile (exp_kernel_beltrami: its feature
//   and its position half's) and forms the score and u, so each exp is
//   taken once an edge and head (fwd_score).
// * K6 keeps den_h in lane h and the numerators of KH heads in registers,
//   each edge's u_h broadcast from lane h; a row of more heads walks its
//   piece again for each further group of KH. K13 sums sum_h u_h recip_h
//   over the head lanes by a butterfly and keeps one D-wide sum.
// * A row of one piece is finished in the walk (K6: recip, ax = 1/H sum_h
//   num_h recip_h, den, num and the fold alpha (ax - x) with its guard;
//   K13: the 1/H scale). The pieces of a longer row write their partial
//   sums, which fwd_merge_rows adds in piece order before the same finish.
// Every sum has a fixed order (edges in a piece, then pieces in order;
// every butterfly the same on every run): no atomics, two launches agree
// bit for bit. K7 scores through the same fwd_score, so its row maxima
// are maxima of the very scores K6 shifts, and the exact mode's largest
// shifted score of a row is exactly 0.

// What K6 and K13's walk reads beside its pieces and tables, and writes
struct FwdIO {
  const int* col;          // each edge's column
  const void* xrow;        // K6's fold: the row side x [N, D], float32 or
  int xrow_bf16;           // (xrow_bf16) bfloat16
  const float* shifts;     // K6: per-edge score shifts [E, H], or null
  const float* alpha;      // K6: the fold's alpha [1], or null
  const float* recip;      // K13: 1 / (den + 1e-16) [N, H] at the columns
  float* out;              // [N, D]: ax, or K6's folded alpha (ax - x)
  float* den;              // K6: [N, H]
  float* num;              // K6: [N, H D], or null
  float* part;             // [slots, fwd_part_floats]: pieces' partials
  int vec;                 // D % 4 == 0 and the D-wide rows 16-byte aligned
};

// a piece's partial sums: K6 its H numerators [H, D] and H denominators,
// K13 its D-wide sum
__host__ __device__ constexpr int fwd_part_floats(bool column_norm, int dim,
                                                  int heads) {
  return column_norm ? dim : heads * dim + heads;
}

// Where lane h < H finds head h's slice sums after slice_sums: the first
// column of its feature slice, h d_k, and for exp_kernel_beltrami of its
// position slice, A / 2 + h d_k (tile and lane of each; lanes >= H read
// head 0's)
struct HeadLane {
  int tile, src, tile_p, src_p;
};

__device__ __forceinline__ HeadLane head_lane(const Proj& p, int d_k,
                                              int lane) {
  const int a = (lane < p.heads ? lane : 0) * d_k, ap = p.att / 2 + a;
  return {a / kWarp, a % kWarp, ap / kWarp, ap % kWarp};
}

// v[tile] of lane src, read by every lane at its own (tile, src): one
// shuffle a tile
template <int KA>
__device__ __forceinline__ float lane_gather(const float (&v)[KA], int tile,
                                             int src) {
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const float t = __shfl_sync(kFull, v[j], src);
    if (j == tile) r = t;
  }
  return r;
}

// The raw score of head `lane` (lanes < H) of q_n against k_c: the forward
// half of edge_sums, then tile_score at the head's lane. The products are
// rounded by __fmul_rn, so that no contraction into a neighbouring add
// lets K6's and K7's scores of one edge differ in a last bit.
template <int KA, bool kNormed>
__device__ __forceinline__ float fwd_score(const LaneHeads<KA>& h,
                                           const HeadLane& hl, const Proj& p,
                                           const ScoreConsts& k,
                                           const float (&qn)[KA],
                                           const float (&kc)[KA], float* buf,
                                           int lane) {
  const int A = p.att;
  if constexpr (!kNormed) {
    float t[1][KA];
    const bool dot = p.score == kScaledDot;
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const float df = qn[j] - kc[j];
      t[0][j] = dot ? __fmul_rn(qn[j], kc[j]) : __fmul_rn(df, df);
    }
    slice_sums<KA, 1>(h, t, buf, lane, A);
    const float own = lane_gather<KA>(t[0], hl.tile, hl.src);
    const float other = p.score == kBeltrami
                            ? lane_gather<KA>(t[0], hl.tile_p, hl.src_p)
                            : 0.0f;
    const float v[4] = {own, 0.0f, other, 0.0f};
    return tile_score<false>(p.score, k, v, 0, true).s;
  } else {
    float m[2][KA] = {};
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
    float v[3][KA];
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const float a = qn[j] - m[0][j], b = kc[j] - m[1][j];
      v[0][j] = __fmul_rn(a, b);
      v[1][j] = __fmul_rn(a, a);
      v[2][j] = __fmul_rn(b, b);
    }
    slice_sums<KA, 3>(h, v, buf, lane, A);
    const float w[3] = {lane_gather<KA>(v[0], hl.tile, hl.src),
                        lane_gather<KA>(v[1], hl.tile, hl.src),
                        lane_gather<KA>(v[2], hl.tile, hl.src)};
    return tile_score<true>(p.score, k, w, 0, true).s;
  }
}

// the sum over the head lanes [0, H) of a value that is 0 on the others:
// a butterfly over the lanes of the first power of two >= H, read from
// lane 0 by every lane
__device__ __forceinline__ float head_lanes_sum(float v, int heads) {
  for (int o = 1; o < heads; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// ax += num_h recip_h, column by column (fmaf, the heads in order)
__device__ __forceinline__ float4 fma4(float4 a, float s, float4 acc) {
  return make_float4(fmaf(a.x, s, acc.x), fmaf(a.y, s, acc.y),
                     fmaf(a.z, s, acc.z), fmaf(a.w, s, acc.w));
}

// The end of a row of K6: den written by its head lanes, then ax / H, or
// the fold alpha (ax / H - x_n), NaN over the whole row when a head's den
// under- or overflowed (den <= 0 on a row with edges, or not finite).
// ax holds sum_h num_h recip_h.
template <int KD>
__device__ __forceinline__ void fwd_finish_rhs(const FwdIO& io, int n, int D,
                                               int H, int lane, bool edges,
                                               float den,
                                               const float4 (&ax)[KD]) {
  if (lane < H) io.den[static_cast<size_t>(n) * H + lane] = den;
  const bool vec = io.vec;
  bool bad = false;
  float alpha = 0.0f;
  if (io.alpha != nullptr) {
    bad = __any_sync(kFull, lane < H && ((den <= 0.0f && edges) ||
                                         !isfinite(den)));
    alpha = __ldg(io.alpha);
  }
  const float scale = 1.0f / H;
#pragma unroll
  for (int t = 0; t < KD; ++t) {
    const int c0 = 4 * (kWarp * t + lane);
    float4 v = scale4(ax[t], scale);
    if (io.alpha != nullptr) {
      const size_t at = static_cast<size_t>(n) * D;
      const float4 xn =
          io.xrow_bf16
              ? load4(static_cast<const __nv_bfloat16*>(io.xrow) + at, c0, D,
                      vec)
              : load4(static_cast<const float*>(io.xrow) + at, c0, D, vec);
      v = bad ? make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                            CUDART_NAN_F)
              : make_float4(alpha * (v.x - xn.x), alpha * (v.y - xn.y),
                            alpha * (v.z - xn.z), alpha * (v.w - xn.w));
    }
    store4(io.out + static_cast<size_t>(n) * D, c0, D, vec, v);
  }
}

// One piece of a row n of the forward walk (see the note above):
// kColumnNorm K13, else K6; kNormed takes cosine_sim and pearson, else
// scaled_dot, exp_kernel and exp_kernel_beltrami; KH: the heads K6 sums at
// once (K13: 1); xcol is the column-side table the values and k come from
// (x itself, or the bfloat16 copy under the bf16 payload, whose k table is
// bfloat16 too); the row side is the q table. smem: the block's dynamic
// shared memory, A floats a warp (kBufferHeads only).
template <bool kColumnNorm, typename TC, int KD, int KA, bool kNormed, int KH>
__device__ __forceinline__ void fwd_walk_piece(
    float* smem, Pieces pc, Proj p, FwdIO io, const TC* __restrict__ xcol,
    const float* __restrict__ qtab, const TC* __restrict__ ktab) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pi = blockIdx.x * kWarpsPerBlock + warp;
  if (pi >= pc.n_pieces) return;              // whole warp leaves together
  const int D = p.dim, A = p.att, H = p.heads;
  const bool vec = io.vec, head = lane < H;
  const int n = pc.col[pi], slot = pc.slot[pi];
  const int start = pc.ptr[pi], end = pc.ptr[pi + 1];
  float* buf = smem + static_cast<size_t>(warp) * A;
  const LaneHeads<KA> h = make_heads<KA>(p, lane);
  const HeadLane hl = head_lane(p, h.d_k, lane);
  const float gmax = *p.gmax;
  const ScoreConsts skc = score_consts(score_params(p), h.d_k);
  float qn[KA];
#pragma unroll
  for (int j = 0; j < KA; ++j)
    qn[j] = bit(h.valid, j)
                ? __ldg(qtab + static_cast<size_t>(n) * A + kWarp * j + lane)
                : 0.0f;
  constexpr int kSums = kColumnNorm ? 1 : KH;
  const int W = fwd_part_floats(kColumnNorm, D, H);
  float* pr = slot >= 0 ? io.part + static_cast<size_t>(slot) * W : nullptr;
  float den = 0.0f;                     // K6, lane h: head h's sum of u
  float4 ax[KD];                        // K6: sum_h num_h recip_h
#pragma unroll
  for (int t = 0; t < KD; ++t) ax[t] = zero4();
  const int groups = kColumnNorm ? 1 : (H + KH - 1) / KH;
  for (int g = 0; g < groups; ++g) {
    const int g0 = g * KH;
    float4 acc[kSums][KD];
#pragma unroll
    for (int i = 0; i < kSums; ++i)
#pragma unroll
      for (int t = 0; t < KD; ++t) acc[i][t] = zero4();
    for (int base = start; base < end; base += kWarp) {
      const int cnt = min(kWarp, end - base);
      const int cols = lane < cnt ? __ldg(io.col + base + lane) : n;
      for (int i = 0; i < cnt; ++i) {
        const int c = __shfl_sync(kFull, cols, i);
        // the edge's rows and its per-head scalar, every load started
        // before the first use
        float4 xc[KD];
#pragma unroll
        for (int t = 0; t < KD; ++t)
          xc[t] = load4(xcol + static_cast<size_t>(c) * D,
                        4 * (kWarp * t + lane), D, vec);
        float kc[KA];
#pragma unroll
        for (int j = 0; j < KA; ++j)
          kc[j] = bit(h.valid, j)
                      ? widen(ktab[static_cast<size_t>(c) * A + kWarp * j +
                                   lane])
                      : 0.0f;
        float hv = 0.0f;
        if (kColumnNorm) {
          if (head) hv = __ldg(io.recip + static_cast<size_t>(c) * H + lane);
        } else if (io.shifts != nullptr && head) {
          hv = __ldg(io.shifts + static_cast<size_t>(base + i) * H + lane);
        }
        const float s =
            fwd_score<KA, kNormed>(h, hl, p, skc, qn, kc, buf, lane);
        float u, duds;
        u_duds(kColumnNorm ? s - gmax : (s - gmax) - hv, p.square_plus, &u,
               &duds);
        u = head ? u : 0.0f;
        if constexpr (kColumnNorm) {
          const float w = head_lanes_sum(u * hv, H);  // sum_h u_h recip_h
#pragma unroll
          for (int t = 0; t < KD; ++t) acc[0][t] = axpy4(w, xc[t], acc[0][t]);
        } else {
          if (g == 0) den += u;
#pragma unroll
          for (int hh = 0; hh < KH; ++hh) {
            if (g0 + hh >= H) break;
            const float uh = __shfl_sync(kFull, u, g0 + hh);
#pragma unroll
            for (int t = 0; t < KD; ++t)
              acc[hh][t] = axpy4(uh, xc[t], acc[hh][t]);
          }
        }
      }
    }
    if constexpr (kColumnNorm) {
#pragma unroll
      for (int t = 0; t < KD; ++t) {
        const int c0 = 4 * (kWarp * t + lane);
        if (pr != nullptr)
          store4(pr, c0, D, false, acc[0][t]);
        else
          store4(io.out + static_cast<size_t>(n) * D, c0, D, vec,
                 scale4(acc[0][t], 1.0f / H));
      }
    } else {
      if (pr != nullptr && g == 0 && head) pr[H * D + lane] = den;
      const float recip = 1.0f / (den + kEps);
#pragma unroll
      for (int hh = 0; hh < KH; ++hh) {
        const int hg = g0 + hh;
        if (hg >= H) break;
        if (pr != nullptr) {                  // a piece of a longer row
#pragma unroll
          for (int t = 0; t < KD; ++t)
            store4(pr + hg * D, 4 * (kWarp * t + lane), D, false,
                   acc[hh][t]);
          continue;
        }
        const float rh = __shfl_sync(kFull, recip, hg);
#pragma unroll
        for (int t = 0; t < KD; ++t) {
          ax[t] = fma4(acc[hh][t], rh, ax[t]);
          if (io.num != nullptr)
            store4(io.num + (static_cast<size_t>(n) * H + hg) * D,
                   4 * (kWarp * t + lane), D, vec, acc[hh][t]);
        }
      }
    }
  }
  if constexpr (!kColumnNorm) {
    if (pr == nullptr)
      fwd_finish_rhs<KD>(io, n, D, H, lane, end > start, den, ax);
  }
}

// A row of several pieces: their partial sums added in piece order, then
// finished as a row of one piece is (a warp a row; the second pass of K6
// and K13 when a row has several pieces)
template <bool kColumnNorm, int KD>
__device__ __forceinline__ void fwd_merge_rows(Pieces pc, Proj p, FwdIO io) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  if (m >= pc.n_multi) return;                // whole warp leaves together
  const int D = p.dim, H = p.heads, W = fwd_part_floats(kColumnNorm, D, H);
  const bool vec = io.vec;
  const int n = pc.multi_col[m];
  const int s0 = pc.multi_ptr[m], s1 = pc.multi_ptr[m + 1];
  if constexpr (kColumnNorm) {
#pragma unroll
    for (int t = 0; t < KD; ++t) {
      const int c0 = 4 * (kWarp * t + lane);
      float4 acc = zero4();
      for (int s = s0; s < s1; ++s)
        acc = add4(acc, load4(io.part + static_cast<size_t>(s) * W, c0, D,
                              false));
      store4(io.out + static_cast<size_t>(n) * D, c0, D, vec,
             scale4(acc, 1.0f / H));
    }
  } else {
    float den = 0.0f;
    if (lane < H)
      for (int s = s0; s < s1; ++s)
        den += io.part[static_cast<size_t>(s) * W + H * D + lane];
    const float recip = 1.0f / (den + kEps);
    float4 ax[KD];
#pragma unroll
    for (int t = 0; t < KD; ++t) ax[t] = zero4();
    for (int hg = 0; hg < H; ++hg) {
      const float rh = __shfl_sync(kFull, recip, hg);
#pragma unroll
      for (int t = 0; t < KD; ++t) {
        const int c0 = 4 * (kWarp * t + lane);
        float4 num = zero4();
        for (int s = s0; s < s1; ++s)
          num = add4(num, load4(io.part + static_cast<size_t>(s) * W + hg * D,
                                c0, D, false));
        ax[t] = fma4(num, rh, ax[t]);
        if (io.num != nullptr)
          store4(io.num + (static_cast<size_t>(n) * H + hg) * D, c0, D, vec,
                 num);
      }
    }
    fwd_finish_rhs<KD>(io, n, D, H, lane, true, den, ax);
  }
}

// Blocks of K6 and K13's walk an SM keeps resident, for __launch_bounds__
// (kh: K6's heads in registers, 1 for K13; tc: bytes of a column-table
// value). The walk waits on its gathers, so warps in flight pay more than
// the few bytes a cap spills (PERF.md, section 6): with 1 or 2 attention
// tiles, registers are capped at 48 (10 blocks, 40 warps) for K6 over a
// float32 table and at 40 (12, 48 warps) for K6 over the bfloat16 table and
// for K13; with 4 tiles at 64 (8), with 8 at 80 (6); K6 with 8 heads in
// registers at 80 (6) up to 4 tiles, and uncapped (4 blocks: its 118-128)
// at 8 (118-119 registers), where a cap cost the kNN graph 15%.
__host__ __device__ constexpr int fwd_min_blocks(int ka, int kh, int tc) {
  return kh == 8    ? (ka == 8 ? 4 : 6)
         : ka <= 2  ? (kh == 2 && tc == 4 ? 10 : 12)
         : ka == 4  ? 8
                    : 6;
}

// The walk and its merge once the q and k tables hold every node's
// projections. Walk names each file's __global__ wrappers:
// Walk::walk<TC, KD, KA, kNormed, KH>() and Walk::merge<KD>(), and
// Walk::kColumnNorm.
template <typename Walk, typename TC, int KD, int KA, bool kNormed, int KH>
cudaError_t launch_fwd_walk_k(const Pieces& pc, const Proj& p,
                              const FwdIO& io, const void* xcol,
                              const void* qtab, const void* ktab,
                              cudaStream_t s) {
  const auto kernel = Walk::template walk<TC, KD, KA, kNormed, KH>();
  const size_t bytes = sizeof(float) * kWarpsPerBlock * p.att;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<row_blocks(pc.n_pieces), kWarpsPerBlock * kWarp, bytes, s>>>(
      pc, p, io, static_cast<const TC*>(xcol),
      static_cast<const float*>(qtab), static_cast<const TC*>(ktab));
  return cudaGetLastError();
}

// K6's numerators in registers: 2 heads at once, or 8 (KD = 1) when the
// row has more; K13 sums once
template <typename Walk, typename TC, int KD, int KA, bool kNormed>
cudaError_t launch_fwd_heads(const Pieces& pc, const Proj& p,
                             const FwdIO& io, const void* xcol,
                             const void* qtab, const void* ktab,
                             cudaStream_t s) {
  if constexpr (Walk::kColumnNorm) {
    return launch_fwd_walk_k<Walk, TC, KD, KA, kNormed, 1>(pc, p, io, xcol,
                                                           qtab, ktab, s);
  } else {
    if constexpr (KD == 1) {
      if (p.heads > 2)
        return launch_fwd_walk_k<Walk, TC, KD, KA, kNormed, 8>(
            pc, p, io, xcol, qtab, ktab, s);
    }
    return launch_fwd_walk_k<Walk, TC, KD, KA, kNormed, 2>(pc, p, io, xcol,
                                                           qtab, ktab, s);
  }
}

template <typename Walk, typename TC>
cudaError_t launch_fwd_walk(const Pieces& pc, const Proj& p, const FwdIO& io,
                            const void* xcol, const void* qtab,
                            const void* ktab, cudaStream_t s) {
  if (p.score == kCosine || p.score == kPearson) {
#define GNPDE_FWD_NORMED(KD, KA) \
  launch_fwd_heads<Walk, TC, KD, KA, true>(pc, p, io, xcol, qtab, ktab, s)
    if (p.dim <= 128)
      return p.att <= 64 ? GNPDE_FWD_NORMED(1, 2) : GNPDE_FWD_NORMED(1, 8);
    return p.att <= 64 ? GNPDE_FWD_NORMED(2, 2) : GNPDE_FWD_NORMED(2, 8);
#undef GNPDE_FWD_NORMED
  }
#define GNPDE_FWD(KD, KA) \
  launch_fwd_heads<Walk, TC, KD, KA, false>(pc, p, io, xcol, qtab, ktab, s)
  GNPDE_SYM_TILES(GNPDE_FWD)
#undef GNPDE_FWD
}

template <typename Walk>
cudaError_t launch_fwd_merge(const Pieces& pc, const Proj& p,
                             const FwdIO& io, cudaStream_t s) {
  if (pc.n_multi == 0) return cudaSuccess;
  if (p.dim <= 128)
    Walk::template merge<1>()<<<row_blocks(pc.n_multi),
                                kWarpsPerBlock * kWarp, 0, s>>>(pc, p, io);
  else
    Walk::template merge<2>()<<<row_blocks(pc.n_multi),
                                kWarpsPerBlock * kWarp, 0, s>>>(pc, p, io);
  return cudaGetLastError();
}

// The launches behind K6 and K13: the q and k tables (unless the caller
// says they are filled already: project = 0), the walk over the row
// pieces and the merge of multi-piece rows. `tables` as launch_tables
// takes it; with kTablesF32, xcol is x.
template <typename Walk>
int launch_forward(int project, int tables, const void* piece_ptr,
                   const void* piece_row, const void* piece_slot,
                   const void* multi_row, const void* multi_ptr,
                   const void* x, const void* xcol, const void* qw,
                   const void* qb, const void* kw, const void* kb,
                   void* qtab, void* ktab, const Proj& p, FwdIO io,
                   int n_rows, int n_pieces, int n_multi, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (project)
      err = launch_tables(tables, x, tables == kTablesF32 ? x : xcol, qw, qb,
                          kw, kb, qtab, ktab, n_rows, p.dim, p.att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Pieces pc = {static_cast<const int*>(piece_ptr),
                       static_cast<const int*>(piece_row),
                       static_cast<const int*>(piece_slot),
                       static_cast<const int*>(multi_row),
                       static_cast<const int*>(multi_ptr), n_pieces, n_multi};
    io.xrow = x;
    io.xrow_bf16 = tables == kTablesBf16;
    const void* table = tables == kTablesF32 ? x : xcol;
    err = tables == kTablesF32
              ? launch_fwd_walk<Walk, float>(pc, p, io, table, qtab, ktab, s)
              : launch_fwd_walk<Walk, __nv_bfloat16>(pc, p, io, table, qtab,
                                                     ktab, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_fwd_merge<Walk>(pc, p, io, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
