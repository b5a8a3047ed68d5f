// K8's per-head mode fused_rhs_bwd_heads for the scaled-dot score, the
// backward of K18 (payload_fwd.cu) from the per-head cotangents ct_num
// [N, H D] and ct_den [N, H]: see payload_walk.cuh for what it replaces,
// what bounds it and how its walk is laid out. For each edge e of row n:
//
//   ds_eh  = (<ct_num[n, h], x_g[e]> + ct_den[n, h]) du/ds
//   dxg[e] = sum_h (u_eh ct_num[n, h] + ds_eh r_nh)
//   a_nh  += ds_eh x_g[e],  b_nh += ds_eh
//
// then a node pass forms, head by head,
//
//   dq_nh = (Kw_h^T a_nh + b_nh kb_h) / sqrt(d_k)
//   [dKw | dKb]_h = sum_n [a_nh | b_nh]^T q_nh / sqrt(d_k),  dgmax = -sum b
//
// Both products are block-diagonal in the heads: over [a | b] whole ([N,
// H (D + 1)] by [H (D + 1), ATT]) they would take H times the work. So a
// block of the node pass owns one head (and up to 32 of its d_k columns)
// over a contiguous range of nodes. Its threads hold [Kw_h | kb_h]'s
// (D + 1) x d_k entries in registers, R rows a thread (8, or 16 where 8
// would take more than 512 threads): each staged node of the tile (its
// a_nh | b_nh and q_nh in shared memory) adds a_nh[d] q_nh[j] to the
// thread's dKw rows and a_nh[d] Kw[d, j] to its share of dq_nh[j], whose
// shares the block then adds in row order. The block writes its [D + 1,
// d_k] partial of [dKw | dKb] and its sum of b; a last kernel adds the
// ranges' partials in order. So two launches agree bit for bit, and
// nothing is zeroed.

#include "cp_async.cuh"
#include "payload_walk.cuh"

namespace {

// The walk over one piece a group: each edge's dxg row whole, and a and b
// of the piece to the row's [a | b] (a row of one piece) or to its partial
// row part[slot]. Every thread also writes its share of dxg's padding
// slots (0), so the wrapper allocates dxg without a memset.
template <typename T, int G, int V, int K, int HP>
__global__ void __launch_bounds__(
    kThreads, payload_min_blocks(HP, K, sizeof(T), true))
payload_bwd_kernel(Pieces pc, PayloadArgs a) {
  // the butterfly sums 2 HP values an edge (each head's score and ct_num
  // dot, interleaved): lane l ends with head l HP / G, both values where
  // 2 HP > G, else one of the two, its neighbour's at xor kPair
  constexpr int P2 = 2 * HP;
  static_assert(G >= HP, "a lane holds one head after the butterfly");
  constexpr int kPair = P2 <= G ? G / P2 : 0;
  using RawT = typename Raw<T, V>::type;
  constexpr int U = batch_of(kPayloadBatchRegs, K * kRawRegs<T, V>);
  const int dim = a.dim, heads = a.heads, vecs = dim / V;
  {
    const int n_valid = pc.ptr[pc.n_pieces];   // where the last piece ends
    const long long t =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(n_valid) * dim + t;
         i < static_cast<long long>(a.n_slots) * dim; i += stride)
      a.dxg[i] = 0.0f;
  }
  const int lane = threadIdx.x % G;
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;            // whole groups leave together
  const unsigned group = group_mask<G>();
  const int row = pc.row[piece];
  const int start = pc.ptr[piece], end = pc.ptr[piece + 1];
  const int slot = pc.slot[piece];
  const size_t hd = static_cast<size_t>(heads) * dim;
  float* abrow = (slot < 0 ? a.ab + static_cast<size_t>(row) * a.stride
                           : a.part + static_cast<size_t>(slot) * a.stride);
  const T* xg = static_cast<const T*>(a.xg);
  const float gmax = __ldg(a.gmax);
  const int hl = lane * HP / G;                // the lane's head
  const bool odd = kPair > 0 && ((lane / (kPair > 0 ? kPair : 1)) & 1);
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    float r[HP][K][V], c[HP];
    fold_row<G, V, K, HP>(a, row, h0, nh, lane, end > start, r, c);
    float ctn[HP][K][V];                       // ct_num[row]'s heads
    const float* crow = a.ct_num + row * hd + static_cast<size_t>(h0) * dim;
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = lane + G * k;
        if (h < nh && v < vecs) {
          load_floats<V>(crow + static_cast<size_t>(h) * dim, v, ctn[h][k]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) ctn[h][k][i] = 0.0f;
        }
      }
    const float cl = at_head<HP>(c, hl);
    const float cden =
        hl < nh ? __ldg(a.ct_den + static_cast<size_t>(row) * heads + h0 + hl)
                : 0.0f;
    float acc[HP][K][V];                       // a_nh
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[h][k][i] = 0.0f;
    float bsum = 0.0f;                         // b of head hl, edge order
#pragma unroll 1
    for (int e0 = start; e0 < end; e0 += U) {
      RawT xr[U][K];
      load_batch<T, G, V, K, U>(xg, e0, end, dim, lane, xr);
#pragma unroll
      for (int b = 0; b < U; ++b) {
        if (e0 + b >= end) break;              // the same for the group
        const int e = e0 + b;
        float xv[K][V];
        float s[P2];                           // score, ct dot of each head
#pragma unroll
        for (int j = 0; j < P2; ++j) s[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = lane + G * k;
          if (v < vecs) {
            widen(xr[b][k], xv[k]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) xv[k][i] = 0.0f;
          }
#pragma unroll
          for (int h = 0; h < HP; ++h)
#pragma unroll
            for (int i = 0; i < V; ++i) {
              s[2 * h] = fmaf(r[h][k][i], xv[k][i], s[2 * h]);
              s[2 * h + 1] = fmaf(ctn[h][k][i], xv[k][i], s[2 * h + 1]);
            }
        }
        group_head_sums<G, P2>(s, group, lane);
        float score, dot;
        if constexpr (kPair > 0) {
          const float other = __shfl_xor_sync(group, s[0], kPair, G);
          score = odd ? other : s[0];
          dot = odd ? s[0] : other;
        } else {
          score = s[0];
          dot = s[1];
        }
        float u, duds;
        payload_u(score + cl - gmax, a.square_plus, &u, &duds);
        const float ds = (dot + cden) * duds;
        bsum += ds;
        float uh[HP], dh[HP];
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          uh[h] = from_lane<G>(group, u, h * (G / HP));
          dh[h] = from_lane<G>(group, ds, h * (G / HP));
        }
        float* xo = a.dxg + static_cast<size_t>(e) * dim;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = lane + G * k;
          if (v < vecs) {
            float o[V];
            if (h0 > 0) {
              load_written<V>(xo, v, o);
            } else {
#pragma unroll
              for (int i = 0; i < V; ++i) o[i] = 0.0f;
            }
#pragma unroll
            for (int h = 0; h < HP; ++h)
#pragma unroll
              for (int i = 0; i < V; ++i) {
                o[i] = fmaf(uh[h], ctn[h][k][i], o[i]);
                o[i] = fmaf(dh[h], r[h][k][i], o[i]);
                acc[h][k][i] = fmaf(dh[h], xv[k][i], acc[h][k][i]);
              }
            store<V>(xo, v, o);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HP; ++h)
      if (h < nh)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = lane + G * k;
          if (v < vecs)
            store<V>(abrow + static_cast<size_t>(h0 + h) * dim, v, acc[h][k]);
        }
    if (writes_head<G, HP>(lane) && hl < nh) abrow[hd + h0 + hl] = bsum;
  }
}

struct BwdWalk {
  template <typename T, int G, int V, int K, int HP>
  static cudaError_t launch(const Pieces& pc, const PayloadArgs& a,
                            cudaStream_t s) {
    payload_bwd_kernel<T, G, V, K, HP>
        <<<blocks_for<G>(pc), kThreads, 0, s>>>(pc, a);
    return cudaGetLastError();
  }
};

// The second pass over the rows of several pieces (merge_partials): their
// partial [a | b] rows, S floats each, into ab
__global__ void __launch_bounds__(kMergeThreads)
payload_bwd_merge_kernel(
    Pieces pc, const float* __restrict__ part, int stride, int width,
    float* __restrict__ out_a, int width_a, float* __restrict__ out_b) {
  merge_partials(pc.multi_ptr, pc.multi_row, pc.n_multi, part, stride,
                 width, out_a, width_a, out_b);
}

constexpr int kNodeTile = 32;      // nodes a stage of the node pass
constexpr int kNodeCols = 32;      // a head's d_k columns a block, at most

// What the node pass reads and writes
struct NodeArgs {
  const float* ab;       // [n_rows, stride]: [a | b]
  const float* q;        // [n_rows, att]
  const float* kw;       // [dim, att]
  const float* kb;       // [att]
  float* dq;             // [n_rows, att]
  float* part;           // [ranges, dim + 1, att]: [dKw | dKb] partials
  float* bsum;           // [ranges, heads]: the ranges' sums of b
  int n_rows, dim, att, heads, stride, ranges, per_range;
  int chunks;            // C: row chunks of R over the D + 1 rows
  int cols, col_blocks;  // JC columns a block, d_k / JC blocks a head
  float scale;
};

// Stage nodes n0 .. n0 + kNodeTile - 1 (those before end; 0 past it):
// their [a_h | b_h | 0] rows (rows_pad floats) in as and their q_h
// columns j0 .. j0 + JC - 1 in qs, a warp a node, its lanes along the row
__device__ __forceinline__ void stage_nodes(const NodeArgs& g, int n0,
                                            int end, int h, int j0,
                                            int rows_pad, float* as,
                                            float* qs) {
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int dim = g.dim, dk = g.att / g.heads;
  for (int n = threadIdx.x / 32; n < kNodeTile; n += warps) {
    const bool node = n0 + n < end;
    const float* row = g.ab + (node ? static_cast<size_t>(n0 + n) * g.stride
                                    : 0);
    for (int d = lane; d < rows_pad; d += 32) {
      const float* src = row + (d < dim ? static_cast<size_t>(h) * dim + d
                                        : static_cast<size_t>(g.heads) * dim
                                              + h);
      const bool ok = node && d <= dim;
      cp_async4(as + n * rows_pad + d, ok ? src : g.ab, ok);
    }
    const float* qrow =
        g.q + (node ? static_cast<size_t>(n0 + n) * g.att : 0) + h * dk + j0;
    for (int j = lane; j < g.cols; j += 32) {
      const bool ok = node && j0 + j < dk;
      cp_async4(qs + n * g.cols + j, ok ? qrow + j : g.q, ok);
    }
  }
  cp_async_commit();
}

// One head (blockIdx.y / col_blocks) and JC of its columns over one range
// of nodes (blockIdx.x): dq of those nodes and columns, the range's
// partial [dKw | dKb] of the columns, and (the first column block) the
// range's sum of the head's b. Thread t holds rows c R .. c R + R - 1
// (row D is kb / b) of column j, c = t / JC, j = t % JC. The stages are
// double-buffered: the next tile's copies are in flight while this one is
// summed.
template <int R>
__global__ void __launch_bounds__(R == 8 ? 512 : 544, R == 8 ? 2 : 1)
payload_node_kernel(NodeArgs g) {
  extern __shared__ __align__(16) float sm[];
  const int rows_pad = g.chunks * R;           // a staged node's [a | b | 0]
  const int jcols = g.cols;
  const int stage = kNodeTile * (rows_pad + jcols);
  float* red = sm + 2 * stage;                 // [kNodeTile, C, JC]
  const int dk = g.att / g.heads;
  const int h = blockIdx.y / g.col_blocks;
  const int j0 = (blockIdx.y % g.col_blocks) * jcols;
  const int t = threadIdx.x;
  const int chunk = t / jcols, jj = t % jcols;
  const bool active = chunk < g.chunks && j0 + jj < dk;
  const int col = h * dk + j0 + jj;
  const int dim = g.dim;
  float w[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int d = chunk * R + i;
    w[i] = !active ? 0.0f
           : d < dim ? __ldg(g.kw + static_cast<size_t>(d) * g.att + col)
           : d == dim ? __ldg(g.kb + col) : 0.0f;
    acc[i] = 0.0f;
  }
  const bool sums_b = t == 0 && j0 == 0;
  float bsum = 0.0f;
  const int start =
      min(g.n_rows, static_cast<int>(blockIdx.x) * g.per_range);
  const int end = min(g.n_rows, start + g.per_range);
  if (start < end)
    stage_nodes(g, start, end, h, j0, rows_pad, sm, sm + kNodeTile * rows_pad);
  for (int n0 = start, buf = 0; n0 < end; n0 += kNodeTile, buf ^= 1) {
    if (n0 + kNodeTile < end) {
      float* next = sm + (buf ^ 1) * stage;
      stage_nodes(g, n0 + kNodeTile, end, h, j0, rows_pad, next,
                  next + kNodeTile * rows_pad);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = sm + buf * stage;
    const float* qs = as + kNodeTile * rows_pad;
    if (active) {
#pragma unroll 2
      for (int n = 0; n < kNodeTile; ++n) {
        const float qv = qs[n * jcols + jj];
        const float4* ar =
            reinterpret_cast<const float4*>(as + n * rows_pad + chunk * R);
        float share = 0.0f;
#pragma unroll
        for (int m = 0; m < R / 4; ++m) {
          const float4 v = ar[m];
          const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[4 * m + i] = fmaf(av[i], qv, acc[4 * m + i]);
            share = fmaf(av[i], w[4 * m + i], share);
          }
        }
        red[(n * g.chunks + chunk) * jcols + jj] = share;
        if (sums_b) bsum += as[n * rows_pad + dim];
      }
    }
    // (the shares are complete, and every thread is done with this
    // buffer, which the next iteration's copies overwrite)
    __syncthreads();
    for (int i = t; i < kNodeTile * jcols; i += blockDim.x) {
      const int n = i / jcols, j = i - n * jcols;
      if (n0 + n < end && j0 + j < dk) {
        float s = 0.0f;
        for (int c = 0; c < g.chunks; ++c)
          s += red[(n * g.chunks + c) * jcols + j];
        g.dq[static_cast<size_t>(n0 + n) * g.att + h * dk + j0 + j] =
            s * g.scale;
      }
    }
  }
  if (active) {
    float* out = g.part + static_cast<size_t>(blockIdx.x) * (dim + 1) * g.att;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int d = chunk * R + i;
      if (d <= dim) out[static_cast<size_t>(d) * g.att + col] = acc[i];
    }
  }
  if (sums_b) g.bsum[blockIdx.x * g.heads + h] = bsum;
}

// [dKw | dKb] = scale x the ranges' partials added in range order (one
// thread an element), and dgmax = -(the ranges' sums of b, in order)
__global__ void __launch_bounds__(256) payload_node_finish_kernel(
    NodeArgs g, float* __restrict__ dkw, float* __restrict__ dkb,
    float* __restrict__ dgmax) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int cells = (g.dim + 1) * g.att;
  if (e < cells) {
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < g.ranges; ++r)
      s += g.part[static_cast<size_t>(r) * cells + e];
    if (e < g.dim * g.att) dkw[e] = s * g.scale;
    else dkb[e - g.dim * g.att] = s * g.scale;
  } else if (e == cells) {
    float s = 0.0f;
    for (int i = 0; i < g.ranges * g.heads; ++i) s += g.bsum[i];
    dgmax[0] = -s;
  }
}

// The node pass's rows a thread: 8, or 16 where 8 would take more than
// 512 threads a block (kernels/fused_rhs.py, node_design)
int node_rows(int dim, int cols) {
  return (dim + 8) / 8 * cols <= 512 ? 8 : 16;
}

template <int R>
cudaError_t launch_node_kernel(const NodeArgs& g, cudaStream_t s) {
  const int threads = (g.chunks * g.cols + 31) / 32 * 32;
  const size_t bytes = sizeof(float) * kNodeTile *
                       (2 * (g.chunks * R + g.cols) + g.chunks * g.cols);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        payload_node_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  payload_node_kernel<R><<<dim3(g.ranges, g.heads * g.col_blocks), threads,
                           bytes, s>>>(g);
  return cudaGetLastError();
}

cudaError_t launch_node_pass(NodeArgs g, float* dkw, float* dkb,
                             float* dgmax, cudaStream_t s) {
  const int dk = g.att / g.heads;
  g.cols = min(dk, kNodeCols);
  g.col_blocks = (dk + g.cols - 1) / g.cols;
  const int r = node_rows(g.dim, g.cols);
  g.chunks = (g.dim + r) / r;
  g.per_range = (g.n_rows + g.ranges - 1) / g.ranges;
  cudaError_t err = r == 8 ? launch_node_kernel<8>(g, s)
                           : launch_node_kernel<16>(g, s);
  if (err != cudaSuccess) return err;
  const int cells = (g.dim + 1) * g.att + 1;
  payload_node_finish_kernel<<<(cells + 255) / 256, 256, 0, s>>>(g, dkw, dkb,
                                                                 dgmax);
  return cudaGetLastError();
}

}  // namespace

// K8's per-head mode for the scaled-dot score over the row pieces
// (Graph.scatter_pieces, as gnpde_payload_aggregate) and the per-edge
// payload xg [n_slots, dim] (float32, or bfloat16: tables 1), from ct_num
// [n_rows, heads dim] and ct_den [n_rows, heads]. The walk writes dxg
// [n_slots, dim], every slot (0 past the valid edges), and ab [n_rows, S]
// each row's [a | b] (S = heads (dim + 1) rounded up to a multiple of 4);
// the node pass dq [n_rows, att], dkw [dim, att], dkb [att] and dgmax [1]
// through node_part [ranges, dim + 1, att] and node_bsum [ranges, heads]
// (ranges: kernels/fused_rhs.py, node_ranges). q, kwt, kb, gmax, part and
// lanes, vec as gnpde_payload_aggregate takes them; kw [dim, att].
extern "C" int gnpde_payload_bwd(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* xg,
    const void* q, const void* kwt, const void* kw, const void* kb,
    const void* gmax, const void* ct_num, const void* ct_den, void* dxg,
    void* ab, void* part, void* dq, void* node_part, void* node_bsum,
    void* dkw, void* dkb, void* dgmax, int n_rows, int n_pieces,
    int n_multi, int n_slots, int dim, int att, int heads, int square_plus,
    int lanes, int vec, int tables, int ranges, void* stream) {
  if (n_rows <= 0 || dim <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (att % heads != 0 || ranges <= 0 || dim > 511)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Pieces pc = make_pieces(piece_ptr, piece_row, piece_slot, multi_row,
                                multi_ptr, n_pieces, n_multi);
  PayloadArgs a = payload_args(xg, q, kwt, kb, gmax, dim, att, heads,
                               square_plus);
  a.ct_num = static_cast<const float*>(ct_num);
  a.ct_den = static_cast<const float*>(ct_den);
  a.dxg = static_cast<float*>(dxg);
  a.ab = static_cast<float*>(ab);
  a.part = static_cast<float*>(part);
  a.n_slots = n_slots;
  cudaError_t err = launch_payload<BwdWalk>(lanes, vec, tables, pc, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = merge(payload_bwd_merge_kernel, pc, part, a.stride, a.stride, ab,
              a.stride, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  NodeArgs g = {};
  g.ab = static_cast<const float*>(ab);
  g.q = static_cast<const float*>(q);
  g.kw = static_cast<const float*>(kw);
  g.kb = static_cast<const float*>(kb);
  g.dq = static_cast<float*>(dq);
  g.part = static_cast<float*>(node_part);
  g.bsum = static_cast<float*>(node_bsum);
  g.n_rows = n_rows;
  g.dim = dim;
  g.att = att;
  g.heads = heads;
  g.stride = a.stride;
  g.ranges = ranges;
  g.scale = a.scale;
  err = launch_node_pass(g, static_cast<float*>(dkw), static_cast<float*>(dkb),
                         static_cast<float*>(dgmax), s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
