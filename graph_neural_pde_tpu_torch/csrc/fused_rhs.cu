// K6 fused_rhs_fwd, K7 fused_rowmax, K8 fused_rhs_bwd, K9 fused_rhs_bwd_sym:
// one evaluation of the GRAND-nl attention right-hand side over a row-sorted
// CSR graph, its per-row score maxima, and its two backward passes.
//
// Replace the TPU kernels of graph_neural_pde_tpu/ops/pallas/fused_rhs.py:
// _rhs_kernel_ax / _fused_ax_call (K6), _rowmax_kernel / fused_rowmax (K7),
// _bwd_kernel / _fused_bwd_mega_call (K8) and _bwd_sym_kernel /
// _fused_bwd_mega_sym_call (K9). Those walk a stripe plan of padded edge
// chunks and do every gather, scatter and per-head sum as a one-hot or
// selector matmul, because a TPU core has no fast indexed access and runs
// its grid in order. Neither holds here: these kernels walk the CSR rowptr,
// gather x[col] themselves and keep every per-row sum in the warp that owns
// the row, so no [E, .] operand is read and, but for K8's per-edge outputs,
// none is written.
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
// arithmetic per edge is 2 ATT + 2 H D flop. K8 alone still multiplies per
// edge (dxg[e] needs dk_e Kw^T) and is bound by that.
//
// Design: one warp per row, four warps a block. Lanes span ATT for the
// node projections (Kw / Qw are read through the L1 as coalesced rows),
// lane h owns head h for the scores and their derivatives (d_k serial
// terms, so the order of every sum is fixed), lanes span D for the
// aggregation. The per-head numerators, the row's q, the edge's x_c and
// k_c live in the warp's slice of dynamic shared memory. There are no
// atomics anywhere.
// Sums over all edges (dKw, dKb, dgmax and the exp_kernel scalars) are
// taken in two passes with a fixed order: K8 writes each edge's dk_e, K9
// each node's dk summed over its reverse edges, plus per-row scalar sums;
// outer_reduce_kernel then forms per-block partial sums of [x_c | 1]^T dk
// over fixed row ranges, and the wrapper adds the partials up in order. Two
// launches on the same inputs therefore agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-16f;
constexpr float kEpsNorm = 1e-5f;     // the reference's cosine/pearson floor

enum Score { kScaledDot = 0, kCosine = 1, kPearson = 2, kExpKernel = 3 };

struct Graph {
  const int* rowptr;
  const int* col;
  int n_rows;
};

struct Proj {            // what a row walk reads beside the q and k tables
  const float* x;
  const float* gmax;
  const float* var;      // exp_kernel only
  const float* ls;
  int dim, att, heads, score, square_plus;
};

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

// What the backward needs of one head's score: s itself and, for
//   dq[a] = P (k[a] - mk) - Q (q[a] - mq),  dk[a] = P (q[a] - mq) - R (k[a] - mk)
// per unit ds, the coefficients (P, Q, R) and the head means (pearson).
struct HeadScore {
  float s, p, q, r, mq, mk, dist;
};

// Score of head `h` from q and k in shared memory: d_k serial terms in a
// fixed order. exp_kernel reads var and ls.
__device__ __forceinline__ HeadScore head_score(const float* q, const float* k,
                                                int h, int d_k, int score,
                                                float var, float ls) {
  HeadScore o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
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
  if (score == kExpKernel) {
    float dist = 0.0f;
    for (int j = 0; j < d_k; ++j) {
      const float df = qh[j] - kh[j];
      dist = fmaf(df, df, dist);
    }
    o.s = var * var * expf(-dist / (2.0f * ls * ls));
    o.dist = dist;
    o.p = o.q = o.r = o.s / (ls * ls);
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

// out[n] = x[n] W + b for every node n: the q and k tables the row walks
// gather from. A warp projects eight nodes at once, so each coalesced row
// of W is loaded once for eight products; the nodes' x rows sit transposed
// in shared memory (xs[d][i]) and are read as two float4 broadcasts.
template <int J>
__device__ __forceinline__ void node_project_j(const float* xs,
                                               const float* __restrict__ w,
                                               const float* __restrict__ b,
                                               float* __restrict__ out,
                                               int n0, int n_rows, int dim,
                                               int att, int lane) {
  float acc[kNodesPerWarp][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = lane + kWarp * j;
    const float bias = a < att ? __ldg(b + a) : 0.0f;
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
        acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kNodesPerWarp; ++i) {
    const int n = n0 + i;
    if (n >= n_rows) break;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int a = lane + kWarp * j;
      if (a < att) out[static_cast<size_t>(n) * att + a] = acc[i][j];
    }
  }
}

__global__ void node_project_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b,
                                    float* __restrict__ out, int n_rows,
                                    int dim, int att) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n0 = (blockIdx.x * kWarpsPerBlock + warp) * kNodesPerWarp;
  if (n0 >= n_rows) return;
  float* xs = smem + static_cast<size_t>(warp) * kNodesPerWarp * dim;
  for (int i = 0; i < kNodesPerWarp; ++i) {
    const float* src =
        x + static_cast<size_t>(min(n0 + i, n_rows - 1)) * dim;
    for (int d = lane; d < dim; d += kWarp)
      xs[d * kNodesPerWarp + i] = src[d];
  }
  __syncwarp();
  switch ((att + kWarp - 1) / kWarp) {
    case 1: node_project_j<1>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    case 2: node_project_j<2>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    case 3: node_project_j<3>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    case 4: node_project_j<4>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    case 5: node_project_j<5>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    case 6: node_project_j<6>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    case 7: node_project_j<7>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
    default: node_project_j<8>(xs, w, b, out, n0, n_rows, dim, att, lane); break;
  }
}

// ----------------------------------------------------------------------- K6

__global__ void fused_rhs_fwd_kernel(Graph g, Proj p,
                                     const float* __restrict__ qtab,
                                     const float* __restrict__ ktab,
                                     const float* __restrict__ shifts,
                                     const float* __restrict__ alpha,
                                     float* __restrict__ out,
                                     float* __restrict__ den,
                                     float* __restrict__ num) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= g.n_rows) return;                    // whole warp leaves together
  const int D = p.dim, A = p.att, H = p.heads, d_k = A / H;
  float* xn = smem + static_cast<size_t>(warp) * (2 * D + 2 * A + H * D);
  float* xc = xn + D;
  float* q = xc + D;
  float* ke = q + A;
  float* acc = ke + A;                          // [H, D] numerators
  load_row(p.x, n, D, lane, xn);
  load_row(qtab, n, A, lane, q);
  for (int i = lane; i < H * D; i += kWarp) acc[i] = 0.0f;
  __syncwarp();
  const float gmax = *p.gmax;
  const float var = p.score == kExpKernel ? *p.var : 0.0f;
  const float ls = p.score == kExpKernel ? *p.ls : 1.0f;
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  float den_h = 0.0f;                           // lane h: head h
  for (int e = start; e < end; ++e) {
    const int c = g.col[e];
    load_row(p.x, c, D, lane, xc);
    load_row(ktab, c, A, lane, ke);
    __syncwarp();
    float u = 0.0f;
    if (lane < H) {
      const HeadScore hs = head_score(q, ke, lane, d_k, p.score, var, ls);
      float sm = hs.s - gmax;
      if (shifts) sm -= shifts[static_cast<size_t>(e) * H + lane];
      float duds;
      u_duds(sm, p.square_plus, &u, &duds);
      den_h += u;
    }
    for (int h = 0; h < H; ++h) {
      const float uh = __shfl_sync(kFull, u, h);
      float* ah = acc + h * D;
      for (int d = lane; d < D; d += kWarp) ah[d] = fmaf(uh, xc[d], ah[d]);
    }
    __syncwarp();                               // xc and ke are reused
  }
  const float recip = lane < H ? 1.0f / (den_h + kEps) : 0.0f;
  bool bad = false;
  if (alpha) {
    const bool mine = lane < H && ((den_h <= 0.0f && end > start) ||
                                   !isfinite(den_h));
    bad = __any_sync(kFull, mine);
  }
  const float scale = 1.0f / H;
  for (int d0 = 0; d0 < D; d0 += kWarp) {
    const int d = d0 + lane;
    float ax = 0.0f;
    for (int h = 0; h < H; ++h) {
      const float rh = __shfl_sync(kFull, recip, h);
      if (d < D) ax = fmaf(acc[h * D + d], rh, ax);
    }
    ax *= scale;
    if (d < D) {
      float v = ax;
      if (alpha) v = bad ? CUDART_NAN_F : *alpha * (ax - xn[d]);
      out[static_cast<size_t>(n) * D + d] = v;
    }
  }
  if (lane < H) den[static_cast<size_t>(n) * H + lane] = den_h;
  if (num) {
    float* nr = num + static_cast<size_t>(n) * H * D;
    for (int i = lane; i < H * D; i += kWarp) nr[i] = acc[i];
  }
}

// ----------------------------------------------------------------------- K7

__global__ void fused_rowmax_kernel(Graph g, Proj p,
                                    const float* __restrict__ qtab,
                                    const float* __restrict__ ktab,
                                    float* __restrict__ smax) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= g.n_rows) return;
  const int A = p.att, H = p.heads, d_k = A / H;
  float* q = smem + static_cast<size_t>(warp) * (2 * A);
  float* ke = q + A;
  load_row(qtab, n, A, lane, q);
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  float m = -CUDART_INF_F;
  for (int e = start; e < end; ++e) {
    load_row(ktab, g.col[e], A, lane, ke);
    __syncwarp();
    if (lane < H)
      m = fmaxf(m, head_score(q, ke, lane, d_k, kScaledDot, 0.0f, 1.0f).s);
    __syncwarp();
  }
  if (lane < H)
    smax[static_cast<size_t>(n) * H + lane] = isfinite(m) ? m : 0.0f;
}

// ------------------------------------------------------------- K8 and K9

// Lane h: from head h's score and the edge's cotangent factors, ds and the
// coefficients of dq / dk, written to coef[h] = (P ds, Q ds, R ds, mq, mk);
// adds the head's terms of the row's scalar sums. Returns u.
__device__ __forceinline__ float head_backward(const HeadScore& hs, float sm,
                                               int square_plus, float dot,
                                               float rg, float ctd, float var,
                                               float ls, int score,
                                               float* coef, float* sum_ds,
                                               float* sum_var, float* sum_ls) {
  float u, duds;
  u_duds(sm, square_plus, &u, &duds);
  const float ds = fmaf(rg, dot, ctd) * duds;
  coef[0] = hs.p * ds;
  coef[1] = hs.q * ds;
  coef[2] = hs.r * ds;
  coef[3] = hs.mq;
  coef[4] = hs.mk;
  *sum_ds += ds;
  if (score == kExpKernel) {
    *sum_var += ds * (2.0f * hs.s / var);
    *sum_ls += ds * hs.s * hs.dist / (ls * ls * ls);
  }
  return u;
}

__device__ __forceinline__ void write_row_sums(float* row_sums, int n,
                                               int heads, int lane, float s0,
                                               float s1, float s2) {
  s0 = head_sum(s0, heads);
  s1 = head_sum(s1, heads);
  s2 = head_sum(s2, heads);
  if (lane == 0) {
    float* r = row_sums + static_cast<size_t>(n) * 3;
    r[0] = s0;
    r[1] = s1;
    r[2] = s2;
  }
}

__global__ void fused_rhs_bwd_kernel(Graph g, Proj p,
                                     const float* __restrict__ qtab,
                                     const float* __restrict__ ktab,
                                     const float* __restrict__ kw_t,
                                     const float* __restrict__ shifts,
                                     const float* __restrict__ ct_ax,
                                     const float* __restrict__ recip_p,
                                     const float* __restrict__ ct_den,
                                     float* __restrict__ dq,
                                     float* __restrict__ dxg,
                                     float* __restrict__ dke_out,
                                     float* __restrict__ row_sums) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= g.n_rows) return;
  const int D = p.dim, A = p.att, H = p.heads, d_k = A / H;
  float* dkw = smem + static_cast<size_t>(warp) * (3 * D + 4 * A + 5 * H);
  float* xc = dkw + D;                          // dkw: this edge's dk Kw^T
  float* cta = xc + D;                          // ct_ax[n]
  float* q = cta + D;
  float* ke = q + A;
  float* dqa = ke + A;                          // dq[n] accumulator
  float* dke = dqa + A;                         // this edge's dk
  float* coef = dke + A;                        // [H, 5]
  load_row(ct_ax, n, D, lane, cta);
  load_row(qtab, n, A, lane, q);
  for (int a = lane; a < A; a += kWarp) dqa[a] = 0.0f;
  __syncwarp();
  const float gmax = *p.gmax;
  const float var = p.score == kExpKernel ? *p.var : 1.0f;
  const float ls = p.score == kExpKernel ? *p.ls : 1.0f;
  const float rg = lane < H ? recip_p[static_cast<size_t>(n) * H + lane] : 0.0f;
  const float ctd = lane < H ? ct_den[static_cast<size_t>(n) * H + lane] : 0.0f;
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int e = start; e < end; ++e) {
    const int c = g.col[e];
    load_row(p.x, c, D, lane, xc);
    load_row(ktab, c, A, lane, ke);
    __syncwarp();
    float part = 0.0f;
    for (int d = lane; d < D; d += kWarp) part = fmaf(cta[d], xc[d], part);
    const float dot = warp_sum(part);
    float w = 0.0f;
    if (lane < H) {
      const HeadScore hs = head_score(q, ke, lane, d_k, p.score, var, ls);
      float sm = hs.s - gmax;
      if (shifts) sm -= shifts[static_cast<size_t>(e) * H + lane];
      w = rg * head_backward(hs, sm, p.square_plus, dot, rg, ctd, var, ls,
                             p.score, coef + 5 * lane, &s0, &s1, &s2);
    }
    const float wsum = head_sum(w, H);          // sum_h u_h recip_p[n, h]
    __syncwarp();
    for (int a = lane; a < A; a += kWarp) {
      const float* c = coef + 5 * (a / d_k);
      const float qq = q[a] - c[3], kk = ke[a] - c[4];
      dqa[a] += c[0] * kk - c[1] * qq;
      const float dk = c[0] * qq - c[2] * kk;
      dke[a] = dk;
      dke_out[static_cast<size_t>(e) * A + a] = dk;
    }
    __syncwarp();
    project(dke, kw_t, nullptr, A, D, lane, dkw);
    float* xo = dxg + static_cast<size_t>(e) * D;
    for (int d = lane; d < D; d += kWarp) xo[d] = fmaf(wsum, cta[d], dkw[d]);
    __syncwarp();
  }
  for (int a = lane; a < A; a += kWarp)
    dq[static_cast<size_t>(n) * A + a] = dqa[a];
  write_row_sums(row_sums, n, H, lane, s0, s1, s2);
}

__global__ void fused_rhs_bwd_sym_kernel(Graph g, Proj p,
                                         const float* __restrict__ qtab,
                                         const float* __restrict__ ktab,
                                         const float* __restrict__ kw_t,
                                         const float* __restrict__ ct_ax,
                                         const float* __restrict__ recip_p,
                                         const float* __restrict__ ct_den,
                                         float* __restrict__ dq,
                                         float* __restrict__ dxrow,
                                         float* __restrict__ dkn_out,
                                         float* __restrict__ row_sums) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= g.n_rows) return;
  const int D = p.dim, A = p.att, H = p.heads, d_k = A / H;
  float* xn = smem + static_cast<size_t>(warp) * (5 * D + 6 * A + 10 * H);
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
  float* coef = dkn + A;                        // [H, 5] forward edge
  float* coef_r = coef + 5 * H;                 // [H, 5] reverse edge
  load_row(p.x, n, D, lane, xn);
  load_row(ct_ax, n, D, lane, cta);
  for (int d = lane; d < D; d += kWarp) dxa[d] = 0.0f;
  for (int a = lane; a < A; a += kWarp) dqa[a] = dkn[a] = 0.0f;
  load_row(qtab, n, A, lane, q);
  load_row(ktab, n, A, lane, kn);
  __syncwarp();
  const float gmax = *p.gmax;
  const float var = p.score == kExpKernel ? *p.var : 1.0f;
  const float ls = p.score == kExpKernel ? *p.ls : 1.0f;
  const float rg = lane < H ? recip_p[static_cast<size_t>(n) * H + lane] : 0.0f;
  const float ctd = lane < H ? ct_den[static_cast<size_t>(n) * H + lane] : 0.0f;
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int e = start; e < end; ++e) {
    const int c = g.col[e];
    load_row(p.x, c, D, lane, xc);
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
      // the edge (n, c): dq[n], and the sums over all edges
      const HeadScore hs = head_score(q, ke, lane, d_k, p.score, var, ls);
      head_backward(hs, hs.s - gmax, p.square_plus, dot, rg, ctd, var, ls,
                    p.score, coef + 5 * lane, &s0, &s1, &s2);
      // its reverse (c, n): row c's factors, q_c against k_n; its x[col]
      // cotangent lands on x_n
      const HeadScore hr = head_score(qc, kn, lane, d_k, p.score, var, ls);
      const float rg_c = recip_p[static_cast<size_t>(c) * H + lane];
      const float ctd_c = ct_den[static_cast<size_t>(c) * H + lane];
      float unused0 = 0.0f, unused1 = 0.0f, unused2 = 0.0f;
      w_r = rg_c * head_backward(hr, hr.s - gmax, p.square_plus, dot_r, rg_c,
                                 ctd_c, var, ls, p.score, coef_r + 5 * lane,
                                 &unused0, &unused1, &unused2);
    }
    const float wsum_r = head_sum(w_r, H);
    __syncwarp();
    for (int a = lane; a < A; a += kWarp) {
      const int h = a / d_k;
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
  write_row_sums(row_sums, n, H, lane, s0, s1, s2);
}

// partial[p, d, a] = sum over block p's rows r of [x[idx[r]] | 1][d] b[r, a]
// (idx null: r itself), d in [0, dim]: the first pass of dKw (rows < dim)
// and dKb (row dim). Each block owns a fixed row range and a 32 x 32 tile.
// The chains are thousands of terms long, so each sum is compensated
// (Kahan): its rounding error stays that of a single addition.
__global__ void outer_reduce_kernel(const float* __restrict__ x,
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
    const float* xr = x + static_cast<size_t>(idx ? idx[r] : r) * dim;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d_base + 8 * k;
      const float xv = d < dim ? xr[d] : (d == dim ? 1.0f : 0.0f);
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

// table[n] = x[n] w + b for every node, into the wrapper's scratch
cudaError_t launch_node_project(const void* x, const void* w, const void* b,
                                void* table, int n_rows, int dim, int att,
                                cudaStream_t stream);

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

cudaError_t launch_node_project(const void* x, const void* w, const void* b,
                                void* table, int n_rows, int dim, int att,
                                cudaStream_t stream) {
  const size_t bytes = sizeof(float) * kWarpsPerBlock * kNodesPerWarp * dim;
  cudaError_t err = allow_shared(node_project_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int groups = (n_rows + kNodesPerWarp - 1) / kNodesPerWarp;
  node_project_kernel<<<row_blocks(groups), kWarpsPerBlock * kWarp, bytes,
                        stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(table), n_rows, dim,
      att);
  return cudaGetLastError();
}

void launch_outer_reduce(const float* x, const int* idx, const float* b,
                         float* partial, int rows, int blocks, int dim,
                         int att, cudaStream_t stream) {
  if (rows <= 0) return;
  const int rows_per_block = (rows + blocks - 1) / blocks;
  const dim3 grid(blocks, (dim + 1 + 31) / 32, (att + 31) / 32);
  outer_reduce_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      x, idx, b, partial, rows, rows_per_block, dim, att);
}

Proj make_proj(const void* x, const void* gmax, const void* var,
               const void* ls, int dim, int att, int heads, int flags) {
  Proj p;
  p.x = static_cast<const float*>(x);
  p.gmax = static_cast<const float*>(gmax);
  p.var = static_cast<const float*>(var);
  p.ls = static_cast<const float*>(ls);
  p.dim = dim;
  p.att = att;
  p.heads = heads;
  p.score = flags & 3;
  p.square_plus = (flags >> 2) & 1;
  return p;
}

Graph make_graph(const void* rowptr, const void* col, int n_rows) {
  Graph g;
  g.rowptr = static_cast<const int*>(rowptr);
  g.col = static_cast<const int*>(col);
  g.n_rows = n_rows;
  return g;
}

}  // namespace

// Every entry point first fills the scratch tables qtab and ktab
// [n_rows, att] (q = x Qw + qb, k = x Kw + kb), then walks the rows.
// flags: bits 0-1 the score family, bit 2 squareplus.

// Nullable: var, ls, shifts, alpha, num.
extern "C" int gnpde_fused_rhs_fwd(
    const void* rowptr, const void* col, const void* x, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* shifts, const void* alpha,
    void* qtab, void* ktab, void* out, void* den, void* num, int n_rows,
    int dim, int att, int heads, int flags, void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        launch_tables(x, qw, qb, kw, kb, qtab, ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes =
        sizeof(float) * kWarpsPerBlock * (2 * dim + 2 * att + heads * dim);
    err = allow_shared(fused_rhs_fwd_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_rhs_fwd_kernel<<<row_blocks(n_rows), kWarpsPerBlock * kWarp, bytes,
                           s>>>(
        make_graph(rowptr, col, n_rows),
        make_proj(x, gmax, var, ls, dim, att, heads, flags),
        static_cast<const float*>(qtab), static_cast<const float*>(ktab),
        static_cast<const float*>(shifts), static_cast<const float*>(alpha),
        static_cast<float*>(out), static_cast<float*>(den),
        static_cast<float*>(num));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gnpde_fused_rowmax(const void* rowptr, const void* col,
                                  const void* x, const void* qw,
                                  const void* qb, const void* kw,
                                  const void* kb, void* qtab, void* ktab,
                                  void* smax, int n_rows, int dim, int att,
                                  int heads, void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        launch_tables(x, qw, qb, kw, kb, qtab, ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = sizeof(float) * kWarpsPerBlock * (2 * att);
    err = allow_shared(fused_rowmax_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_rowmax_kernel<<<row_blocks(n_rows), kWarpsPerBlock * kWarp, bytes,
                          s>>>(
        make_graph(rowptr, col, n_rows),
        make_proj(x, nullptr, nullptr, nullptr, dim, att, heads, kScaledDot),
        static_cast<const float*>(qtab), static_cast<const float*>(ktab),
        static_cast<float*>(smax));
  }
  return static_cast<int>(cudaGetLastError());
}

// kw_t is Kw^T [att, dim]. dke [n_slots, att] and row_sums [n_rows, 3] are
// scratch the wrapper reduces; partials [reduce_blocks, dim + 1, att] are
// zero on entry. Nullable: var, ls, shifts.
extern "C" int gnpde_fused_rhs_bwd(
    const void* rowptr, const void* col, const void* x, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* shifts, const void* ct_ax,
    const void* recip_p, const void* ct_den, const void* kw_t, void* qtab,
    void* ktab, void* dq, void* dxg, void* dke, void* row_sums,
    void* partials, int n_rows, int dim, int att, int heads, int flags,
    int n_slots, int reduce_blocks, void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        launch_tables(x, qw, qb, kw, kb, qtab, ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes =
        sizeof(float) * kWarpsPerBlock * (3 * dim + 4 * att + 5 * heads);
    err = allow_shared(fused_rhs_bwd_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_rhs_bwd_kernel<<<row_blocks(n_rows), kWarpsPerBlock * kWarp, bytes,
                           s>>>(
        make_graph(rowptr, col, n_rows),
        make_proj(x, gmax, var, ls, dim, att, heads, flags),
        static_cast<const float*>(qtab), static_cast<const float*>(ktab),
        static_cast<const float*>(kw_t), static_cast<const float*>(shifts),
        static_cast<const float*>(ct_ax), static_cast<const float*>(recip_p),
        static_cast<const float*>(ct_den), static_cast<float*>(dq),
        static_cast<float*>(dxg), static_cast<float*>(dke),
        static_cast<float*>(row_sums));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_outer_reduce(static_cast<const float*>(x),
                        static_cast<const int*>(col),
                        static_cast<const float*>(dke),
                        static_cast<float*>(partials), n_slots, reduce_blocks,
                        dim, att, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// kw_t is Kw^T [att, dim]. dkn [n_rows, att] and row_sums [n_rows, 3] are
// scratch the wrapper reduces; partials [reduce_blocks, dim + 1, att] are
// zero on entry. Nullable: var, ls.
extern "C" int gnpde_fused_rhs_bwd_sym(
    const void* rowptr, const void* col, const void* x, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* ct_ax, const void* recip_p,
    const void* ct_den, const void* kw_t, void* qtab, void* ktab, void* dq,
    void* dxrow, void* dkn, void* row_sums, void* partials, int n_rows,
    int dim, int att, int heads, int flags, int reduce_blocks, void* stream) {
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        launch_tables(x, qw, qb, kw, kb, qtab, ktab, n_rows, dim, att, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes =
        sizeof(float) * kWarpsPerBlock * (5 * dim + 6 * att + 10 * heads);
    err = allow_shared(fused_rhs_bwd_sym_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_rhs_bwd_sym_kernel<<<row_blocks(n_rows), kWarpsPerBlock * kWarp,
                               bytes, s>>>(
        make_graph(rowptr, col, n_rows),
        make_proj(x, gmax, var, ls, dim, att, heads, flags),
        static_cast<const float*>(qtab), static_cast<const float*>(ktab),
        static_cast<const float*>(kw_t), static_cast<const float*>(ct_ax),
        static_cast<const float*>(recip_p), static_cast<const float*>(ct_den),
        static_cast<float*>(dq), static_cast<float*>(dxrow),
        static_cast<float*>(dkn), static_cast<float*>(row_sums));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_outer_reduce(static_cast<const float*>(x), nullptr,
                        static_cast<const float*>(dkn),
                        static_cast<float*>(partials), n_rows, reduce_blocks,
                        dim, att, s);
  }
  return static_cast<int>(cudaGetLastError());
}
