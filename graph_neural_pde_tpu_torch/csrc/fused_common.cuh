// Device code shared by the fused attention kernels (fused_rhs.cu: K6-K9,
// K17, norm1.cu: K12-K14): the per-head score families and their derivatives,
// the node projections into the q and k scratch tables, the warp-level sums
// and the deterministic two-pass reduction of dKw / dKb. Each source that
// includes this header gets its own copy (anonymous namespace), so the
// sources still compile independently, one nvcc each.
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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

constexpr int kNodesPerWarp = 8;

// How a table entry is summed and stored. float32: x W + b summed in
// float32 from the bias. The bfloat16 k table: the JAX package's two
// roundings of k_e = x[col] @ Kw.astype(bf16) + kb.astype(bf16) in
// bfloat16 (the product rounded, then its sum with the bias), from W and b
// that the wrapper has rounded to bfloat16 already. Its product is summed
// in float64, where the products of bfloat16 values add up exactly at
// these widths, so the rounding to bfloat16 does not depend on the order
// of the sum: the plain version (a float64 matmul) rounds the same sums
// the same way. A float32 sum's own rounding would decide a last bf16 bit
// now and then, and a k off by one bf16 step moves every score it enters.
template <typename TO> struct ProjAcc { using type = float; };
template <> struct ProjAcc<__nv_bfloat16> { using type = double; };

__device__ __forceinline__ float proj_fma(float x, float w, float acc) {
  return fmaf(x, w, acc);
}
__device__ __forceinline__ double proj_fma(float x, float w, double acc) {
  return fma(static_cast<double>(x), static_cast<double>(w), acc);
}
__device__ __forceinline__ float proj_start(const float*, float bias) {
  return bias;
}
__device__ __forceinline__ double proj_start(const __nv_bfloat16*, float) {
  return 0.0;
}
__device__ __forceinline__ void proj_store(float* out, float acc, float) {
  *out = acc;
}
__device__ __forceinline__ void proj_store(__nv_bfloat16* out, double acc,
                                           float bias) {
  *out = __float2bfloat16_rn(round_bf16(__double2float_rn(acc)) + bias);
}

// out[n] = x[n] W + b for every node n: the q and k tables the row walks
// gather from. A warp projects eight nodes at once, so each coalesced row
// of W is loaded once for eight products; the nodes' x rows sit transposed
// in shared memory (xs[d][i]) and are read as two float4 broadcasts. TO is
// the table's type (see proj_store).
template <int J, typename TO>
__device__ __forceinline__ void node_project_j(const float* xs,
                                               const float* __restrict__ w,
                                               const float* __restrict__ b,
                                               TO* __restrict__ out,
                                               int n0, int n_rows, int dim,
                                               int att, int lane) {
  using Acc = typename ProjAcc<TO>::type;
  Acc acc[kNodesPerWarp][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = lane + kWarp * j;
    const Acc bias = proj_start(out, a < att ? __ldg(b + a) : 0.0f);
#pragma unroll
    for (int i = 0; i < kNodesPerWarp; ++i) acc[i][j] = bias;
  }
  for (int d = 0; d < dim; ++d) {
    const float4* xv4 =
        reinterpret_cast<const float4*>(xs + d * kNodesPerWarp);
    const float4 lo = xv4[0], hi = xv4[1];
    const float xv[kNodesPerWarp] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
    const float* wr = w + static_cast<size_t>(d) * att + lane;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float wv = lane + kWarp * j < att ? __ldg(wr + kWarp * j) : 0.0f;
#pragma unroll
      for (int i = 0; i < kNodesPerWarp; ++i)
        acc[i][j] = proj_fma(xv[i], wv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kNodesPerWarp; ++i) {
    const int n = n0 + i;
    if (n >= n_rows) break;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int a = lane + kWarp * j;
      if (a < att)
        proj_store(out + static_cast<size_t>(n) * att + a, acc[i][j],
                   __ldg(b + a));
    }
  }
}

// kJ: the accumulators a lane holds (att up to 32 kJ); the launch picks
// the kernel of the call's width, so each holds only its own registers
template <typename TX, typename TO, int kJ>
__global__ void node_project_kernel(const TX* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b,
                                    TO* __restrict__ out, int n_rows,
                                    int dim, int att) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n0 = (blockIdx.x * kWarpsPerBlock + warp) * kNodesPerWarp;
  if (n0 >= n_rows) return;
  float* xs = smem + static_cast<size_t>(warp) * kNodesPerWarp * dim;
  for (int i = 0; i < kNodesPerWarp; ++i) {
    const TX* src = x + static_cast<size_t>(min(n0 + i, n_rows - 1)) * dim;
    for (int d = lane; d < dim; d += kWarp)
      xs[d * kNodesPerWarp + i] = widen(src[d]);
  }
  __syncwarp();
  node_project_j<kJ>(xs, w, b, out, n0, n_rows, dim, att, lane);
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

// row_sums[n] = the row's sums over its head lanes [kRowSums]
__device__ __forceinline__ void write_row_sums(float* row_sums, int n,
                                               int heads, int lane,
                                               const RowSums& s) {
  const float t[kRowSums] = {head_sum(s.ds, heads), head_sum(s.e0, heads),
                             head_sum(s.e1, heads), head_sum(s.e2, heads),
                             head_sum(s.e3, heads)};
  if (lane == 0) {
    float* r = row_sums + static_cast<size_t>(n) * kRowSums;
    for (int i = 0; i < kRowSums; ++i) r[i] = t[i];
  }
}

// One row n of the backward over a SYMMETRIC edge multiset: K9
// (fused_rhs_bwd_sym, softmax over rows) and, with kColumnNorm, K14
// (norm1_bwd, softmax over columns). Each edge (n, c) also evaluates its
// reverse edge (c, n) from node rows gathered at c, so that x[col]'s
// cotangent and dk land on the resident row and nothing is scattered.
// xcol is the column-side table the values and k were taken from (x
// itself, or the bfloat16 copy of it that K9 and K14 read under the bf16
// payload, whose k table is bfloat16 too); the
// row side is the q table. smem is the block's dynamic shared memory,
// 5 D + 6 ATT + 2 kCoef H floats a warp.
template <bool kColumnNorm, typename TC>
__device__ __forceinline__ void sym_backward_row(
    float* smem, Graph g, Proj p, const TC* __restrict__ xcol,
    const float* __restrict__ qtab, const TC* __restrict__ ktab,
    const float* __restrict__ kw_t,
    const float* __restrict__ ct_ax, const float* __restrict__ recip_p,
    const float* __restrict__ ct_den, float* __restrict__ dq,
    float* __restrict__ dxrow, float* __restrict__ dkn_out,
    float* __restrict__ row_sums) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= g.n_rows) return;                    // whole warp leaves together
  const int D = p.dim, A = p.att, H = p.heads, d_k = head_width(p);
  float* xn = smem + static_cast<size_t>(warp) * (5 * D + 6 * A + 2 * kCoef * H);
  float* xc = xn + D;
  float* cta = xc + D;                          // ct_ax[n]
  float* ctc = cta + D;                         // ct_ax[c]
  float* dxa = ctc + D;                         // dxrow[n] accumulator
  float* q = dxa + D;                           // q_n
  float* kn = q + A;                            // k_n: the reverse edges' k
  float* ke = kn + A;                           // k_c
  float* qc = ke + A;                           // q_c: the reverse edge's q
  float* dqa = qc + A;
  float* dkn = dqa + A;                         // sum of the reverse edges' dk
  float* coef = dkn + A;                        // [H, kCoef] forward edge
  float* coef_r = coef + kCoef * H;             // [H, kCoef] reverse edge
  load_row(xcol, n, D, lane, xn);
  load_row(ct_ax, n, D, lane, cta);
  for (int d = lane; d < D; d += kWarp) dxa[d] = 0.0f;
  for (int a = lane; a < A; a += kWarp) dqa[a] = dkn[a] = 0.0f;
  load_row(qtab, n, A, lane, q);
  load_row(ktab, n, A, lane, kn);
  __syncwarp();
  const float gmax = *p.gmax;
  const ScoreParams sc = score_params(p);
  const float rg = lane < H ? recip_p[static_cast<size_t>(n) * H + lane] : 0.0f;
  const float ctd = lane < H ? ct_den[static_cast<size_t>(n) * H + lane] : 0.0f;
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  RowSums sums = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = start; e < end; ++e) {
    const int c = g.col[e];
    load_row(xcol, c, D, lane, xc);
    load_row(ct_ax, c, D, lane, ctc);
    load_row(ktab, c, A, lane, ke);
    load_row(qtab, c, A, lane, qc);
    __syncwarp();
    float part = 0.0f, part_r = 0.0f;
    for (int d = lane; d < D; d += kWarp) {
      part = fmaf(cta[d], xc[d], part);
      part_r = fmaf(ctc[d], xn[d], part_r);
    }
    const float dot = warp_sum(part);           // ct_ax[n] . x_c
    const float dot_r = warp_sum(part_r);       // ct_ax[c] . x_n
    float w_r = 0.0f;
    if (lane < H) {
      // the softmax group of the edge (n, c) is its row n, that of its
      // reverse (c, n) the row c; normalised over columns, the other way
      // round
      const float rg_c = recip_p[static_cast<size_t>(c) * H + lane];
      const float ctd_c = ct_den[static_cast<size_t>(c) * H + lane];
      const float rg_f = kColumnNorm ? rg_c : rg;
      const float ctd_f = kColumnNorm ? ctd_c : ctd;
      const float rg_r = kColumnNorm ? rg : rg_c;
      const float ctd_r = kColumnNorm ? ctd : ctd_c;
      // the edge (n, c): dq[n], and the sums over all edges
      const HeadScore hs = head_score(q, ke, lane, d_k, H, p.score, sc);
      head_backward(hs, hs.s - gmax, p.square_plus, dot, rg_f, ctd_f, sc,
                    p.score, H, coef + 5 * lane, &sums);
      // its reverse (c, n): q_c against k_n; its x[col] cotangent lands on
      // x_n
      const HeadScore hr = head_score(qc, kn, lane, d_k, H, p.score, sc);
      RowSums unused = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      w_r = rg_r * head_backward(hr, hr.s - gmax, p.square_plus, dot_r, rg_r,
                                 ctd_r, sc, p.score, H, coef_r + 5 * lane,
                                 &unused);
    }
    const float wsum_r = head_sum(w_r, H);
    __syncwarp();
    for (int a = lane; a < A; a += kWarp) {
      const int h = a / d_k;                    // a head or its position half
      const float* cf = coef + 5 * h;
      dqa[a] += cf[0] * (ke[a] - cf[4]) - cf[1] * (q[a] - cf[3]);
      const float* cr = coef_r + 5 * h;
      dkn[a] += cr[0] * (qc[a] - cr[3]) - cr[2] * (kn[a] - cr[4]);
    }
    for (int d = lane; d < D; d += kWarp) dxa[d] = fmaf(wsum_r, ctc[d], dxa[d]);
    __syncwarp();
  }
  for (int a = lane; a < A; a += kWarp) {
    dq[static_cast<size_t>(n) * A + a] = dqa[a];
    dkn_out[static_cast<size_t>(n) * A + a] = dkn[a];
  }
  __syncwarp();
  project(dkn, kw_t, nullptr, A, D, lane, xc);  // xc: (sum of dk) Kw^T
  for (int d = lane; d < D; d += kWarp)
    dxrow[static_cast<size_t>(n) * D + d] = dxa[d] + xc[d];
  write_row_sums(row_sums, n, H, lane, sums);
}

// partial[p, d, a] = sum over block p's rows r of [x[idx[r]] | 1][d] b[r, a]
// (idx null: r itself), d in [0, dim]: the first pass of dKw (rows < dim)
// and dKb (row dim). Each block owns a fixed row range and a 32 x 32 tile.
// The chains are thousands of terms long, so each sum is compensated
// (Kahan): its rounding error stays that of a single addition.
template <typename TX>
__global__ void outer_reduce_kernel(const TX* __restrict__ x,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ b,
                                    float* __restrict__ partial, int rows,
                                    int rows_per_block, int dim, int att) {
  const int a = blockIdx.z * 32 + threadIdx.x;
  const int d_base = blockIdx.y * 32 + threadIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float lost[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float bv = a < att ? b[static_cast<size_t>(r) * att + a] : 0.0f;
    const TX* xr = x + static_cast<size_t>(idx ? idx[r] : r) * dim;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d_base + 8 * k;
      const float xv = d < dim ? widen(xr[d]) : (d == dim ? 1.0f : 0.0f);
      const float term = xv * bv - lost[k];
      const float sum = acc[k] + term;
      lost[k] = (sum - acc[k]) - term;
      acc[k] = sum;
    }
  }
  if (a >= att) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = d_base + 8 * k;
    if (d <= dim)
      partial[(static_cast<size_t>(blockIdx.x) * (dim + 1) + d) * att + a] =
          acc[k];
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int row_blocks(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

template <typename TX, typename TO, int kJ>
cudaError_t launch_node_project_j(const void* x, const void* w,
                                  const void* b, void* table, int n_rows,
                                  int dim, int att, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * kWarpsPerBlock * kNodesPerWarp * dim;
  cudaError_t err = allow_shared(node_project_kernel<TX, TO, kJ>, bytes);
  if (err != cudaSuccess) return err;
  const int groups = (n_rows + kNodesPerWarp - 1) / kNodesPerWarp;
  node_project_kernel<TX, TO, kJ><<<row_blocks(groups),
                                    kWarpsPerBlock * kWarp, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<TO*>(table), n_rows, dim,
      att);
  return cudaGetLastError();
}

// table[n] = x[n] w + b for every node, into the wrapper's scratch (TX
// the type of x, TO the table's: see proj_store), by the kernel whose
// accumulator count covers att
template <typename TX = float, typename TO = float>
cudaError_t launch_node_project(const void* x, const void* w, const void* b,
                                void* table, int n_rows, int dim, int att,
                                cudaStream_t stream) {
  switch ((att + kWarp - 1) / kWarp) {
#define GNPDE_NODE_PROJECT_J(J)                                              \
  case J:                                                                    \
    return launch_node_project_j<TX, TO, J>(x, w, b, table, n_rows, dim, att, \
                                            stream);
    GNPDE_NODE_PROJECT_J(1)
    GNPDE_NODE_PROJECT_J(2)
    GNPDE_NODE_PROJECT_J(3)
    GNPDE_NODE_PROJECT_J(4)
    GNPDE_NODE_PROJECT_J(5)
    GNPDE_NODE_PROJECT_J(6)
    GNPDE_NODE_PROJECT_J(7)
#undef GNPDE_NODE_PROJECT_J
    default:
      return launch_node_project_j<TX, TO, 8>(x, w, b, table, n_rows, dim, att,
                                              stream);
  }
}

// both tables: q = x Qw + qb and k = x Kw + kb
cudaError_t launch_tables(const void* x, const void* qw, const void* qb,
                          const void* kw, const void* kb, void* qtab,
                          void* ktab, int n_rows, int dim, int att,
                          cudaStream_t stream) {
  cudaError_t err = launch_node_project(x, qw, qb, qtab, n_rows, dim, att,
                                        stream);
  if (err != cudaSuccess) return err;
  return launch_node_project(x, kw, kb, ktab, n_rows, dim, att, stream);
}

// The TABLES code of K6-K9, K12-K14 and K17: 0 float32 (x is also the
// column table), 1 a float32 row side x beside a bfloat16 column table
// xcol, 2 both bfloat16 (the bf16 ODE state: xcol is x).
enum Tables { kTablesF32 = 0, kTablesF32Bf16 = 1, kTablesBf16 = 2 };

bool valid_tables(int tables) {
  return tables == kTablesF32 || tables == kTablesF32Bf16 ||
         tables == kTablesBf16;
}

// q from the row side, k from the column side: for the bfloat16 column
// table a bfloat16 k table, rounded as the JAX package rounds k_e (kw and
// kb come rounded to bfloat16 from the wrapper)
cudaError_t launch_tables(int tables, const void* x, const void* xcol,
                          const void* qw, const void* qb, const void* kw,
                          const void* kb, void* qtab, void* ktab, int n_rows,
                          int dim, int att, cudaStream_t stream) {
  if (tables == kTablesF32)
    return launch_tables(x, qw, qb, kw, kb, qtab, ktab, n_rows, dim, att,
                         stream);
  cudaError_t err =
      tables == kTablesF32Bf16
          ? launch_node_project<float, float>(x, qw, qb, qtab, n_rows, dim,
                                              att, stream)
          : launch_node_project<__nv_bfloat16, float>(x, qw, qb, qtab, n_rows,
                                                      dim, att, stream);
  if (err != cudaSuccess) return err;
  return launch_node_project<__nv_bfloat16, __nv_bfloat16>(
      xcol, kw, kb, ktab, n_rows, dim, att, stream);
}

template <typename TX>
void launch_outer_reduce(const TX* x, const int* idx, const float* b,
                         float* partial, int rows, int blocks, int dim,
                         int att, cudaStream_t stream) {
  if (rows <= 0) return;
  const int rows_per_block = (rows + blocks - 1) / blocks;
  const dim3 grid(blocks, (dim + 1 + 31) / 32, (att + 31) / 32);
  outer_reduce_kernel<TX><<<grid, dim3(32, 8), 0, stream>>>(
      x, idx, b, partial, rows, rows_per_block, dim, att);
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

// The launches behind K9 and K14: the q and k tables (unless the caller
// says they are filled already: project = 0), the row walk `kernel` (a
// __global__ wrapper of sym_backward_row over the column table of type TC)
// and the first pass of the dKw / dKb reduction over the per-node dk sums
// and the column table. `tables` as launch_tables takes it; with
// kTablesF32, xcol is x. The walk reads x only as xcol (x may be
// bfloat16).
template <typename TC, typename Kernel>
int launch_sym_backward(
    Kernel kernel, int project, int tables, const void* rowptr,
    const void* col, const void* x, const void* xcol,
    const void* qw, const void* qb, const void* kw, const void* kb,
    const void* gmax, const void* var, const void* ls, const void* ct_ax,
    const void* recip_p, const void* ct_den, const void* kw_t, void* qtab,
    void* ktab, void* dq, void* dxrow, void* dkn, void* row_sums,
    void* partials, int n_rows, int dim, int att, int heads, int flags,
    int reduce_blocks, void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (project)
      err = launch_tables(tables, x, xcol, qw, qb, kw, kb, qtab, ktab, n_rows,
                          dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = sizeof(float) * kWarpsPerBlock *
                         (5 * dim + 6 * att + 2 * kCoef * heads);
    err = allow_shared(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<row_blocks(n_rows), kWarpsPerBlock * kWarp, bytes, s>>>(
        make_graph(rowptr, col, n_rows),
        make_proj(gmax, var, ls, dim, att, heads, flags),
        static_cast<const TC*>(xcol), static_cast<const float*>(qtab),
        static_cast<const TC*>(ktab),
        static_cast<const float*>(kw_t), static_cast<const float*>(ct_ax),
        static_cast<const float*>(recip_p), static_cast<const float*>(ct_den),
        static_cast<float*>(dq), static_cast<float*>(dxrow),
        static_cast<float*>(dkn), static_cast<float*>(row_sums));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_outer_reduce(static_cast<const TC*>(xcol), nullptr,
                        static_cast<const float*>(dkn),
                        static_cast<float*>(partials), n_rows, reduce_blocks,
                        dim, att, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
