// K18 fused_aggregate, K19 fused_score_max and K8's per-head mode
// fused_rhs_bwd_heads: the GRAND-nl attention right-hand side's numerators
// and denominators over a per-EDGE payload x_g [n_slots, D] (row-sorted,
// edge e at row e) instead of x[col], its global score maximum, and its
// backward from per-head cotangents. Replace the TPU kernels of
// graph_neural_pde_tpu/ops/pallas/fused_rhs.py: _rhs_kernel / _fused_call
// (K18), _max_kernel / _fused_score_max_impl (K19) and _bwd_kernel's
// non-separable branch / _fused_bwd_mega_call with recip_p=None (the
// backward of fused_rhs_aggregate). Kept apart from fused_rhs.cu (K6-K9,
// K17), whose walks over node tables they share only fused_common.cuh with,
// so that the two compile side by side. For the scaled-dot score K18 and
// the per-head mode run payload_fwd.cu / payload_bwd.cu instead (Kw folded
// into each row's query: no edge's key); the walks here serve the four
// families whose scores need each edge's key, and K19.
//
// K18, K19 and K8's per-head mode take the payload's bfloat16 mode too
// (the JAX package's _fused_call / _fused_score_max_impl /
// _fused_bwd_mega_call over a bfloat16 x_g): the payload rows of type TX
// and (K18, the per-head mode) the node row of type TR are widened to
// float32 as they are loaded into the same shared-memory layout, and k_e
// is projected from the widened row with the float32 Kw and kb and is not
// rounded, as every route of the JAX package computes it there. Every
// cotangent, sum and output stays float32; the per-head mode's dKw is
// reduced over the bfloat16 payload.
//
// What bounds them on the H100: the same issue-bound row walks as K6-K9,
// plus the per-edge key projection (x_g is no node table, so k_e =
// x_g[e] Kw + kb is projected per edge, as the TPU kernels do).
//
// Design: a warp owns a row and takes its edges kGroup at a time:
//   * it loads the group's payload rows with kGroup loads in flight a lane
//     (a row's edges are contiguous, so each load is coalesced) into shared
//     memory, transposed ([D, kGroup]);
//   * it projects the group's keys at once (group_project), so that each
//     element of Kw read from shared memory serves kGroup products;
//   * lane l scores the pair (edge l / H, head l % H) of the group, so all
//     kGroup H scores run side by side;
//   * K18 adds u x_g into the row's [H, D] numerators, a lane per column,
//     in edge order; K8's per-head mode forms each edge's dk and then the
//     group's dk Kw^T as one more group product.
// The block (kPayloadWarps warps) stages Qw and Kw in shared memory first,
// each row padded by one float, so that a column can be read without bank
// conflicts too (K19 stages Kw only); q_n = x_n Qw + qb is projected by the
// warp that owns row n (K19 reads q from its table). Every sum runs in a
// fixed order: no atomics.

#include "fused_common.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kPayloadWarps = 8;
static_assert(kGroup == 8, "load_group packs a group as two float4");

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// out[i * out_stride + o] = b[o] + sum_k xs[k * G + i] w[k * w_k + o * w_o]
// for i < count, o < n_out: xs holds G rows of n_in floats transposed
// (16-byte aligned), w is a matrix in shared memory read through its two
// strides, lanes span o with J accumulators a lane and row. b may be null.
template <int G, int J>
__device__ __forceinline__ void group_project_j(
    const float* xs, const float* w, int w_k, int w_o,
    const float* __restrict__ b, int n_in, int n_out, int lane, int count,
    float* out, int out_stride) {
  float acc[G][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = lane + kWarp * j;
    const float bias = (b != nullptr && o < n_out) ? __ldg(b + o) : 0.0f;
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i][j] = bias;
  }
  for (int k = 0; k < n_in; ++k) {
    float xv[G];
    if constexpr (G % 4 == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xs + k * G);
#pragma unroll
      for (int i = 0; i < G / 4; ++i) {
        const float4 v = x4[i];
        xv[4 * i] = v.x;
        xv[4 * i + 1] = v.y;
        xv[4 * i + 2] = v.z;
        xv[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) xv[i] = xs[k * G + i];
    }
    const float* wr = w + k * w_k + lane * w_o;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float wv = lane + kWarp * j < n_out ? wr[kWarp * j * w_o] : 0.0f;
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i >= count) break;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int o = lane + kWarp * j;
      if (o < n_out) out[i * out_stride + o] = acc[i][j];
    }
  }
  __syncwarp();
}

template <int G>
__device__ __forceinline__ void group_project(const float* xs, const float* w,
                                              int w_k, int w_o, const float* b,
                                              int n_in, int n_out, int lane,
                                              int count, float* out,
                                              int out_stride) {
#define GNPDE_GROUP_PROJECT(J)                                              \
  group_project_j<G, J>(xs, w, w_k, w_o, b, n_in, n_out, lane, count, out, \
                        out_stride)
  switch ((n_out + kWarp - 1) / kWarp) {
    case 1: GNPDE_GROUP_PROJECT(1); break;
    case 2: GNPDE_GROUP_PROJECT(2); break;
    case 3: GNPDE_GROUP_PROJECT(3); break;
    case 4: GNPDE_GROUP_PROJECT(4); break;
    case 5: GNPDE_GROUP_PROJECT(5); break;
    case 6: GNPDE_GROUP_PROJECT(6); break;
    case 7: GNPDE_GROUP_PROJECT(7); break;
    default: GNPDE_GROUP_PROJECT(8); break;
  }
#undef GNPDE_GROUP_PROJECT
}

// ws[d (att + 1) + a] = w[d, a] (and ws2 from w2, when given): the block's
// copy of [dim, att] weights, each row padded by one float
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              const float* __restrict__ w2,
                                              float* ws, float* ws2, int dim,
                                              int att) {
  for (int i = threadIdx.x; i < dim * att; i += blockDim.x) {
    const int at = (i / att) * (att + 1) + i % att;
    ws[at] = w[i];
    if (w2 != nullptr) ws2[at] = w2[i];
  }
  __syncthreads();
}

// one payload element through the read-only path, widened to float32
__device__ __forceinline__ float load_widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_widen(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// payload rows [e0, e0 + count) of type TX into xs [dim, kGroup], widened
// to float32 and transposed, the columns past count 0
template <typename TX>
__device__ __forceinline__ void load_group(const TX* __restrict__ xg,
                                           int e0, int count, int dim,
                                           int lane, float* xs) {
  for (int d = lane; d < dim; d += kWarp) {
    float v[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      v[i] = i < count
                 ? load_widen(xg + static_cast<size_t>(e0 + i) * dim + d)
                 : 0.0f;
    float4* dst = reinterpret_cast<float4*>(xs + d * kGroup);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncwarp();
}

// Floats of shared memory: the block's weights, and each warp's slice (a
// multiple of 4 floats, so that every warp's xs stays 16-byte aligned).
// kernels/fused_rhs.py checks the same sums against the device's limit.
__host__ __device__ __forceinline__ int padded_weight_floats(int d, int a) {
  return round4(d * (a + 1));
}
__host__ __device__ __forceinline__ int aggregate_warp_floats(int d, int a,
                                                              int h) {
  return round4(kGroup * d + a + kGroup * (a + 1) + h * d + kGroup * h);
}
__host__ __device__ __forceinline__ int score_max_warp_floats(int d, int a) {
  return round4(kGroup * d + a + kGroup * (a + 1));
}
__host__ __device__ __forceinline__ int bwd_heads_warp_floats(int d, int a,
                                                              int h) {
  return round4(kGroup * d + a * kGroup + 2 * a + kGroup * (a + 1) +
                h * (d + 1) + kGroup * kCoef * h + 2 * kGroup * h);
}

// ---------------------------------------------------------------------- K18
//
// num[n, h D + d] = sum_e u_eh x_g[e, d] and den[n, h] = sum_e u_eh over
// the edges e of row n, u_eh = exp(s_eh - gmax - shift_eh) (or
// squareplus), s_eh the score of q_n and k_e = x_g[e] Kw + kb; each sum in
// the row's edge order. The node rows x_n of type TR, the payload of type
// TX (see the note above K6 on the bfloat16 mode).
template <typename TR, typename TX>
__global__ void __launch_bounds__(kPayloadWarps * kWarp, 2)
fused_aggregate_kernel(Graph g, Proj p, const TR* __restrict__ xn,
                       const TX* __restrict__ xg,
                       const float* __restrict__ qw,
                       const float* __restrict__ qb,
                       const float* __restrict__ kw,
                       const float* __restrict__ kb,
                       const float* __restrict__ shifts,
                       float* __restrict__ num, float* __restrict__ den) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, A = p.att, H = p.heads, d_k = head_width(p);
  const int wsk = A + 1, ks = A + 1;            // padded row strides
  float* qw_s = smem;
  float* kw_s = qw_s + padded_weight_floats(D, A);
  stage_weights(qw, kw, qw_s, kw_s, D, A);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kPayloadWarps + warp;
  if (n >= g.n_rows) return;                    // after the block's barrier
  float* xs = kw_s + padded_weight_floats(D, A) +
              static_cast<size_t>(warp) * aggregate_warp_floats(D, A, H);
  float* q = xs + kGroup * D;
  float* ke = q + A;                            // [kGroup, A + 1]
  float* acc = ke + kGroup * ks;                // [H, D] numerators
  float* uu = acc + H * D;                      // [kGroup, H]
  load_row(xn, n, D, lane, xs);
  __syncwarp();
  group_project<1>(xs, qw_s, wsk, 1, qb, D, A, lane, 1, q, A);
  for (int i = lane; i < H * D; i += kWarp) acc[i] = 0.0f;
  const float gmax = *p.gmax;
  const ScoreParams sc = score_params(p);
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  float den_h = 0.0f;                           // lane h: head h
  for (int e0 = start; e0 < end; e0 += kGroup) {
    const int count = min(kGroup, end - e0);
    load_group(xg, e0, count, D, lane, xs);
    group_project<kGroup>(xs, kw_s, wsk, 1, kb, D, A, lane, count, ke, ks);
    for (int l = lane; l < count * H; l += kWarp) {
      const int i = l / H, h = l % H;
      const HeadScore hs = head_score(q, ke + i * ks, h, d_k, H, p.score, sc);
      float sm = hs.s - gmax;
      if (shifts) sm -= shifts[static_cast<size_t>(e0 + i) * H + h];
      float u, duds;
      u_duds(sm, p.square_plus, &u, &duds);
      uu[l] = u;
    }
    __syncwarp();
    if (lane < H)
      for (int i = 0; i < count; ++i) den_h += uu[i * H + lane];
    for (int d = lane; d < D; d += kWarp) {
      const float4* x4 = reinterpret_cast<const float4*>(xs + d * kGroup);
      const float4 lo = x4[0], hi = x4[1];
      const float xv[kGroup] = {lo.x, lo.y, lo.z, lo.w,
                                hi.x, hi.y, hi.z, hi.w};
      for (int h = 0; h < H; ++h) {
        float a = acc[h * D + d];
        for (int i = 0; i < count; ++i) a = fmaf(uu[i * H + h], xv[i], a);
        acc[h * D + d] = a;
      }
    }
    __syncwarp();                               // xs, ke and uu are reused
  }
  if (lane < H) den[static_cast<size_t>(n) * H + lane] = den_h;
  float* nr = num + static_cast<size_t>(n) * H * D;
  for (int i = lane; i < H * D; i += kWarp) nr[i] = acc[i];
}

// ---------------------------------------------------------------------- K19
//
// The largest scaled-dot score <q[n], x_g[e] Kw + kb>_h / sqrt(d_k) over
// every edge and head: each block writes its rows' maximum to partial[b],
// score_max_finish_kernel reduces the partials in one block. A NaN score
// wins, as in the plain version; a maximum does not depend on the order of
// its terms, so two launches agree bit for bit.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

template <typename TX>
__global__ void __launch_bounds__(kPayloadWarps * kWarp, 2)
fused_score_max_kernel(Graph g, Proj p, const float* __restrict__ qtab,
                       const TX* __restrict__ xg,
                       const float* __restrict__ kw,
                       const float* __restrict__ kb,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, A = p.att, H = p.heads, d_k = A / H;
  const int wsk = A + 1, ks = A + 1;
  float* kw_s = smem;
  stage_weights(kw, nullptr, kw_s, nullptr, D, A);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* xs = kw_s + padded_weight_floats(D, A) +
              static_cast<size_t>(warp) * score_max_warp_floats(D, A);
  float* q = xs + kGroup * D;
  float* ke = q + A;
  float* block_max = kw_s + padded_weight_floats(D, A) +
                     kPayloadWarps * score_max_warp_floats(D, A);
  const int n = blockIdx.x * kPayloadWarps + warp;
  float m = -CUDART_INF_F;
  if (n < g.n_rows) {                           // no early return: a barrier
    load_row(qtab, n, A, lane, q);              // follows
    const ScoreParams unit = {1.0f, 1.0f, 1.0f, 1.0f};
    const int start = g.rowptr[n], end = g.rowptr[n + 1];
    for (int e0 = start; e0 < end; e0 += kGroup) {
      const int count = min(kGroup, end - e0);
      load_group(xg, e0, count, D, lane, xs);
      group_project<kGroup>(xs, kw_s, wsk, 1, kb, D, A, lane, count, ke, ks);
      for (int l = lane; l < count * H; l += kWarp)
        m = max_nan(m, head_score(q, ke + (l / H) * ks, l % H, d_k, H,
                                  kScaledDot, unit).s);
      __syncwarp();
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) block_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = block_max[0];
    for (int w = 1; w < kPayloadWarps; ++w) b = max_nan(b, block_max[w]);
    partial[blockIdx.x] = b;
  }
}

// out[0] = the maximum of partial[0 .. count), 0 unless it is finite (an
// edgeless graph: -inf)
__global__ void score_max_finish_kernel(const float* __restrict__ partial,
                                        int count, float* __restrict__ out) {
  __shared__ float red[256];
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    m = max_nan(m, partial[i]);
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = max_nan(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = isfinite(red[0]) ? red[0] : 0.0f;
}

// ------------------------------------------------------- K8, per-head mode
//
// The backward of K18 from the per-head cotangents ct_num [N, H D] and
// ct_den [N, H]: for each edge e of row n,
//     du_eh  = <ct_num[n, h], x_g[e]> + ct_den[n, h],  ds_eh = du_eh du/ds,
//     dq[n] += ds . ds/dq,  dk_e = ds . ds/dk,
//     dxg[e] = sum_h u_eh ct_num[n, h] + dk_e Kw^T,
// each row's sums of ds and of the score scalars' terms into row_sums, and
// each edge's dk_e into dke_out, from which outer_reduce_kernel forms dKw =
// sum_e x_g[e]^T dk_e and dKb as K8 does. Per group: the keys and the dots
// <ct_num[n, h], x_g[e]> as two group products, the (edge, head) pairs'
// scores and derivatives in parallel lanes, dq and dk edge by edge, and
// dk Kw^T as a third group product. The node rows x_n of type TR, the
// payload of type TX.
template <typename TR, typename TX>
__global__ void __launch_bounds__(kPayloadWarps * kWarp, 2)
fused_rhs_bwd_heads_kernel(
    Graph g, Proj p, const TR* __restrict__ xn, const TX* __restrict__ xg,
    const float* __restrict__ qw, const float* __restrict__ qb,
    const float* __restrict__ kw, const float* __restrict__ kb,
    const float* __restrict__ ct_num, const float* __restrict__ ct_den,
    float* __restrict__ dq,
    float* __restrict__ dxg, float* __restrict__ dke_out,
    float* __restrict__ row_sums) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, A = p.att, H = p.heads, d_k = head_width(p);
  const int wsk = A + 1, ks = A + 1, cs = D + 1;    // padded row strides
  const int cf = kCoef * H;                         // coef floats an edge
  float* qw_s = smem;
  float* kw_s = qw_s + padded_weight_floats(D, A);
  stage_weights(qw, kw, qw_s, kw_s, D, A);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kPayloadWarps + warp;
  if (n >= g.n_rows) return;                    // after the block's barrier
  float* xs = kw_s + padded_weight_floats(D, A) +
              static_cast<size_t>(warp) * bwd_heads_warp_floats(D, A, H);
  float* dkt = xs + kGroup * D;                 // the group's dk, [A, kGroup]
  float* q = dkt + A * kGroup;
  float* dqa = q + A;                           // dq[n] accumulator
  float* ke = dqa + A;                          // [kGroup, A + 1]
  float* ctn = ke + kGroup * ks;                // ct_num[n], [H, D + 1]
  float* coef = ctn + H * cs;                   // [kGroup, H, kCoef]
  float* uu = coef + kGroup * cf;               // [kGroup, H]
  float* dots = uu + kGroup * H;                // [kGroup, H]
  load_row(xn, n, D, lane, xs);
  for (int h = 0; h < H; ++h)
    load_row(ct_num + static_cast<size_t>(n) * H * D, h, D, lane,
             ctn + h * cs);
  for (int a = lane; a < A; a += kWarp) dqa[a] = 0.0f;
  __syncwarp();
  group_project<1>(xs, qw_s, wsk, 1, qb, D, A, lane, 1, q, A);
  const float gmax = *p.gmax;
  const ScoreParams sc = score_params(p);
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  RowSums sums = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // this lane's pairs
  for (int e0 = start; e0 < end; e0 += kGroup) {
    const int count = min(kGroup, end - e0);
    load_group(xg, e0, count, D, lane, xs);
    group_project<kGroup>(xs, kw_s, wsk, 1, kb, D, A, lane, count, ke, ks);
    group_project<kGroup>(xs, ctn, 1, cs, nullptr, D, H, lane, count, dots,
                          H);
    for (int l = lane; l < count * H; l += kWarp) {
      const int i = l / H, h = l % H;
      const HeadScore hs = head_score(q, ke + i * ks, h, d_k, H, p.score, sc);
      uu[l] = head_backward(hs, hs.s - gmax, p.square_plus, dots[l], 1.0f,
                            ct_den[static_cast<size_t>(n) * H + h], sc,
                            p.score, H, coef + i * cf + 5 * h, &sums);
    }
    __syncwarp();
    for (int i = 0; i < count; ++i) {
      const float* kei = ke + i * ks;
      const float* ci = coef + i * cf;
      float* out = dke_out + static_cast<size_t>(e0 + i) * A;
      for (int a = lane; a < A; a += kWarp) {
        const float* c = ci + 5 * (a / d_k);    // a head or its position half
        const float qq = q[a] - c[3], kk = kei[a] - c[4];
        dqa[a] += c[0] * kk - c[1] * qq;
        const float dk = c[0] * qq - c[2] * kk;
        dkt[a * kGroup + i] = dk;
        out[a] = dk;
      }
    }
    __syncwarp();
    // xs[i D + d] = (dk_i Kw^T)[d]: Kw's column d read along its padded row
    group_project<kGroup>(dkt, kw_s, 1, wsk, nullptr, A, D, lane, count, xs,
                          D);
    for (int i = 0; i < count; ++i) {
      float* xo = dxg + static_cast<size_t>(e0 + i) * D;
      for (int d = lane; d < D; d += kWarp) {
        float v = xs[i * D + d];
        for (int h = 0; h < H; ++h) v = fmaf(uu[i * H + h], ctn[h * cs + d], v);
        xo[d] = v;
      }
    }
    __syncwarp();                               // xs, dkt, coef, uu reused
  }
  for (int a = lane; a < A; a += kWarp)
    dq[static_cast<size_t>(n) * A + a] = dqa[a];
  const float t[kRowSums] = {warp_sum(sums.ds), warp_sum(sums.e0),
                             warp_sum(sums.e1), warp_sum(sums.e2),
                             warp_sum(sums.e3)};
  if (lane == 0) {
    float* r = row_sums + static_cast<size_t>(n) * kRowSums;
    for (int i = 0; i < kRowSums; ++i) r[i] = t[i];
  }
}

int payload_blocks(int n_rows) {
  return (n_rows + kPayloadWarps - 1) / kPayloadWarps;
}

// K18 over the node rows x of type TR and the payload xg of type TX
template <typename TR, typename TX>
cudaError_t launch_aggregate(Graph g, Proj p, const void* x, const void* xg,
                             const void* qw, const void* qb, const void* kw,
                             const void* kb, const void* shifts, void* num,
                             void* den, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (2 * padded_weight_floats(p.dim, p.att) +
                       kPayloadWarps *
                           aggregate_warp_floats(p.dim, p.att, p.heads));
  cudaError_t err = allow_shared(fused_aggregate_kernel<TR, TX>, bytes);
  if (err != cudaSuccess) return err;
  fused_aggregate_kernel<TR, TX><<<payload_blocks(g.n_rows),
                                   kPayloadWarps * kWarp, bytes, s>>>(
      g, p, static_cast<const TR*>(x), static_cast<const TX*>(xg),
      static_cast<const float*>(qw), static_cast<const float*>(qb),
      static_cast<const float*>(kw), static_cast<const float*>(kb),
      static_cast<const float*>(shifts), static_cast<float*>(num),
      static_cast<float*>(den));
  return cudaGetLastError();
}

// K19 over the payload xg of type TX
template <typename TX>
cudaError_t launch_score_max(Graph g, Proj p, const void* q, const void* xg,
                             const void* kw, const void* kb, void* partial,
                             cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (padded_weight_floats(p.dim, p.att) +
                       kPayloadWarps * score_max_warp_floats(p.dim, p.att) +
                       kPayloadWarps);
  cudaError_t err = allow_shared(fused_score_max_kernel<TX>, bytes);
  if (err != cudaSuccess) return err;
  fused_score_max_kernel<TX><<<payload_blocks(g.n_rows),
                               kPayloadWarps * kWarp, bytes, s>>>(
      g, p, static_cast<const float*>(q), static_cast<const TX*>(xg),
      static_cast<const float*>(kw), static_cast<const float*>(kb),
      static_cast<float*>(partial));
  return cudaGetLastError();
}

// K8's per-head operands beside the graph, the rows and the weights (see
// gnpde_fused_rhs_bwd_heads)
struct Heads {
  const void *ct_num, *ct_den;
  void *dq, *dxg, *dke, *row_sums, *partials;
  int n_slots, reduce_blocks;
};

// K8's per-head walk over the node rows x of type TR and the payload xg of
// type TX, then the first pass of dKw / dKb over the payload's rows
template <typename TR, typename TX>
cudaError_t launch_bwd_heads(Graph g, Proj p, const void* x, const void* xg,
                             const void* qw, const void* qb, const void* kw,
                             const void* kb, const Heads& b, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (2 * padded_weight_floats(p.dim, p.att) +
                       kPayloadWarps *
                           bwd_heads_warp_floats(p.dim, p.att, p.heads));
  cudaError_t err = allow_shared(fused_rhs_bwd_heads_kernel<TR, TX>, bytes);
  if (err != cudaSuccess) return err;
  fused_rhs_bwd_heads_kernel<TR, TX><<<payload_blocks(g.n_rows),
                                       kPayloadWarps * kWarp, bytes, s>>>(
      g, p, static_cast<const TR*>(x), static_cast<const TX*>(xg),
      static_cast<const float*>(qw), static_cast<const float*>(qb),
      static_cast<const float*>(kw), static_cast<const float*>(kb),
      static_cast<const float*>(b.ct_num), static_cast<const float*>(b.ct_den),
      static_cast<float*>(b.dq), static_cast<float*>(b.dxg),
      static_cast<float*>(b.dke), static_cast<float*>(b.row_sums));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_outer_reduce(static_cast<const TX*>(xg), nullptr,
                      static_cast<const float*>(b.dke),
                      static_cast<float*>(b.partials), b.n_slots,
                      b.reduce_blocks, p.dim, p.att, s);
  return cudaGetLastError();
}

}  // namespace

// K18, K19 and K8's per-head mode take `tables` as K6-K9 do, for the
// node rows x and the per-edge payload xg: kTablesF32 both float32,
// kTablesF32Bf16 x float32 and xg bfloat16, kTablesBf16 both bfloat16
// (K19 reads no node row: kTablesF32 or kTablesF32Bf16). The weights, q,
// gmax, every cotangent and every output are float32.

// K18 over the per-edge payload xg [n_slots, dim] (edge e at row e of the
// row-sorted CSR prefix): num [n_rows, heads dim], den [n_rows, heads].
// Nullable: var, ls, shifts.
extern "C" int gnpde_fused_aggregate(
    const void* rowptr, const void* xg, const void* x, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* shifts, void* num, void* den,
    int n_rows, int dim, int att, int heads, int flags, int tables,
    void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Graph g = make_graph(rowptr, nullptr, n_rows);
    const Proj p = make_proj(gmax, var, ls, dim, att, heads, flags);
    cudaError_t err;
    if (tables == kTablesF32)
      err = launch_aggregate<float, float>(g, p, x, xg, qw, qb, kw, kb,
                                           shifts, num, den, s);
    else if (tables == kTablesF32Bf16)
      err = launch_aggregate<float, __nv_bfloat16>(g, p, x, xg, qw, qb, kw,
                                                   kb, shifts, num, den, s);
    else
      err = launch_aggregate<__nv_bfloat16, __nv_bfloat16>(
          g, p, x, xg, qw, qb, kw, kb, shifts, num, den, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K19: out[0], the largest scaled-dot score of q [n_rows, att] against the
// per-edge keys xg Kw + kb (0 unless finite). partial [max(1, n_rows / 8
// rounded up)] is scratch.
extern "C" int gnpde_fused_score_max(
    const void* rowptr, const void* q, const void* xg, const void* kw,
    const void* kb, void* partial, void* out, int n_rows, int dim, int att,
    int heads, int tables, void* stream) {
  if (tables != kTablesF32 && tables != kTablesF32Bf16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    const Graph g = make_graph(rowptr, nullptr, n_rows);
    const Proj p = make_proj(nullptr, nullptr, nullptr, dim, att,
                             heads, kScaledDot);
    const cudaError_t err =
        tables == kTablesF32
            ? launch_score_max<float>(g, p, q, xg, kw, kb, partial, s)
            : launch_score_max<__nv_bfloat16>(g, p, q, xg, kw, kb, partial,
                                              s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  score_max_finish_kernel<<<1, 256, 0, s>>>(static_cast<const float*>(partial),
                                            payload_blocks(n_rows),
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K8's per-head mode over the per-edge payload xg [n_slots, dim]: ct_num
// [n_rows, heads dim], ct_den [n_rows, heads]. dxg [n_slots, dim] and dke
// [n_slots, att] are zero on entry (padding slots stay 0), row_sums
// [n_rows, 5] is scratch the wrapper reduces, partials [reduce_blocks,
// dim + 1, att] are written whole (dense.cuh's outer_reduce_kernel), and
// dKw is reduced over the payload.
// Nullable: var, ls.
extern "C" int gnpde_fused_rhs_bwd_heads(
    const void* rowptr, const void* xg, const void* x, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* ct_num, const void* ct_den,
    void* dq, void* dxg, void* dke, void* row_sums, void* partials,
    int n_rows, int dim, int att, int heads, int flags, int n_slots,
    int reduce_blocks, int tables, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Graph g = make_graph(rowptr, nullptr, n_rows);
    const Proj p = make_proj(gmax, var, ls, dim, att, heads, flags);
    const Heads b = {ct_num, ct_den, dq, dxg, dke, row_sums, partials,
                     n_slots, reduce_blocks};
    cudaError_t err;
    if (tables == kTablesF32)
      err = launch_bwd_heads<float, float>(g, p, x, xg, qw, qb, kw, kb, b, s);
    else if (tables == kTablesF32Bf16)
      err = launch_bwd_heads<float, __nv_bfloat16>(g, p, x, xg, qw, qb, kw,
                                                   kb, b, s);
    else
      err = launch_bwd_heads<__nv_bfloat16, __nv_bfloat16>(g, p, x, xg, qw,
                                                           qb, kw, kb, b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
