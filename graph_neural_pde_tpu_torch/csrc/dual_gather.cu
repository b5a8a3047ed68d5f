// K11 dual_gather: the gradient of K10 dual_scatter, the aggregation of
// the composed attention right-hand side, given its outputs' cotangents:
//
//   du[e, h] = ct_num[row[e], h, :] . x[col[e], :] + ct_den[row[e], h]
//   dx[c, :] = sum_{e: col[e] = c} sum_h u[e, h] * ct_num[row[e], h, :]
//
// It replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _gather2_kernel / _stripe_gather2_call together with the products XLA
// forms around it. What bounds it on the H100 and how it is laid out is in
// dual_scatter.cu's note (K10 and K11 walk the same row pieces on lane
// groups sized by the row width; dual_common.cuh holds what they share).
//
// K11 is two walks behind one call, as K17 is two passes:
// * the du walk (dual_gather_kernel) keeps ct_num[row]'s heads in
//   registers, loads U edges' x[col] rows (widened as loaded) before their
//   arithmetic, forms each edge's H partial dot products on its lanes and
//   reduces them over the group by the transposed butterfly, then adds
//   ct_den[row]; every thread also writes its share of du's padding slots
//   (0), so the wrapper allocates du without a memset. It is the whole of
//   K11 on a directed graph (rev = dx = null), whose dx is K1 (csr_spmm.cu)
//   over the CSC view in table mode.
// * the dx walk (dual_gather_dx_kernel), on a symmetric edge multiset, sums
//   dx[row] = sum over the row's edges e' of sum_h u[rev[e'], h] *
//   ct_num[col[e'], h, :] (the edges whose column is n are the reverses
//   of row n's own) in registers in edge order, each edge's ct_num[col]
//   heads and u[rev] loaded together before its arithmetic; it reads
//   float32 rows only, so its lane group follows the float32 row
//   (kernels/lanes.py, ct_num); the rows of several pieces add their
//   partial rows in piece order (dual_gather_merge_kernel).
// The first design formed both in one walk: each edge's x, ct_num and u
// loads together took 110-159 registers a thread and 1.49 ms at arxiv scale
// against 1.25 for the two walks (probes/lanes.py, PERF.md). No atomics;
// two launches agree bit for bit.

#include "dual_common.cuh"

namespace {

// The registers one batch of the du walk's x rows may take;
// probes/lanes.py builds variants
#ifndef GNPDE_GATHER_BATCH_REGS
#define GNPDE_GATHER_BATCH_REGS 8
#endif

// K11's du walk over one piece a group: du of the piece's edges.
template <typename T, int G, int V, int K, int HP>
__global__ void __launch_bounds__(kThreads) dual_gather_kernel(
    Pieces pc, const int* __restrict__ col, const T* __restrict__ x,
    const float* __restrict__ ct_num, const float* __restrict__ ct_den,
    float* __restrict__ du, int dim, int heads, int n_slots) {
  using RawT = typename Raw<T, V>::type;
  constexpr int U = batch_of(GNPDE_GATHER_BATCH_REGS, K * kRawRegs<T, V>);
  constexpr int J = HP >= G ? HP / G : 1;
  {
    const int n_valid = pc.ptr[pc.n_pieces];   // where the last piece ends
    const long long t =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(n_valid) * heads + t;
         i < static_cast<long long>(n_slots) * heads; i += stride)
      du[i] = 0.0f;
  }
  const int lane = threadIdx.x % G;
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;            // whole groups leave together
  const unsigned group = group_mask<G>();
  const int start = pc.ptr[piece], end = pc.ptr[piece + 1];
  const int row = pc.row[piece];
  const int vecs = dim / V;
  const size_t hd = static_cast<size_t>(heads) * dim;
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    float ctn[HP][K][V];                       // ct_num[row]'s heads
    float cden[J];
    const float* crow = ct_num + row * hd + static_cast<size_t>(h0) * dim;
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
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int h = head_of<G, HP>(lane, j);
      cden[j] = h < nh ? ct_den[static_cast<size_t>(row) * heads + h0 + h]
                       : 0.0f;
    }
    for (int e0 = start; e0 < end; e0 += G) {  // G >= 4 >= U: a lane an edge
      const int c = e0 + lane < end ? col[e0 + lane] : 0;
      const int n = min(G, end - e0);
#pragma unroll 1
      for (int j = 0; j < n; j += U) {
        RawT xr[U][K];
#pragma unroll
        for (int b = 0; b < U; ++b) {
          const T* xrow =
              x + static_cast<size_t>(from_lane<G>(group, c, j + b)) * dim;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = lane + G * k;
            if (j + b < n && v < vecs) xr[b][k] = load<T, V>(xrow, v);
          }
        }
#pragma unroll
        for (int b = 0; b < U; ++b) {
          if (j + b >= n) break;               // the same for the group
          float s[HP];
#pragma unroll
          for (int h = 0; h < HP; ++h) s[h] = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = lane + G * k;
            if (v < vecs) {
              float xv[V];
              widen(xr[b][k], xv);
#pragma unroll
              for (int h = 0; h < HP; ++h)
#pragma unroll
                for (int i = 0; i < V; ++i)
                  s[h] = fmaf(ctn[h][k][i], xv[i], s[h]);
            }
          }
          group_head_sums<G, HP>(s, group, lane);
          if (writes_head<G, HP>(lane)) {
            const size_t e = static_cast<size_t>(e0 + j + b);
#pragma unroll
            for (int jj = 0; jj < J; ++jj) {
              const int h = head_of<G, HP>(lane, jj);
              if (h < nh) du[e * heads + h0 + h] = s[jj] + cden[jj];
            }
          }
        }
      }
    }
  }
}

// K11's dx walk over one piece a group (a symmetric edge multiset): dx of
// its row, to the row (a row of one piece) or to its partial row
// part[slot]. Each edge's HP * K loads of ct_num[col] and its u[rev] go
// in flight together before its arithmetic; batches of two and four
// edges' took 1.3112 and 1.7515 ms at arxiv scale against 1.2272 for one
// edge (probes/lanes.py, PERF.md).
template <int G, int V, int K, int HP>
__global__ void __launch_bounds__(kThreads) dual_gather_dx_kernel(
    Pieces pc, const int* __restrict__ col, const int* __restrict__ rev,
    const float* __restrict__ u, const float* __restrict__ ct_num,
    float* __restrict__ dx, float* __restrict__ part, int dim, int heads,
    int uvec) {
  const int lane = threadIdx.x % G;
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;            // whole groups leave together
  const unsigned group = group_mask<G>();
  const int start = pc.ptr[piece], end = pc.ptr[piece + 1];
  const int vecs = dim / V;
  const size_t hd = static_cast<size_t>(heads) * dim;
  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    for (int e0 = start; e0 < end; e0 += G) {
      const int e = e0 + lane;
      const int c = e < end ? col[e] : 0;
      const int rv = e < end ? rev[e] : 0;
      const int n = min(G, end - e0);
      for (int j = 0; j < n; ++j) {
        float cn[HP][K][V];
        float ur[HP];
        load_heads<HP>(u, from_lane<G>(group, rv, j), h0, heads, uvec, true,
                       ur);
        const float* cc =
            ct_num + static_cast<size_t>(from_lane<G>(group, c, j)) * hd
            + static_cast<size_t>(h0) * dim;
#pragma unroll
        for (int h = 0; h < HP; ++h)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = lane + G * k;
            if (h < nh && v < vecs)
              load_floats<V>(cc + static_cast<size_t>(h) * dim, v, cn[h][k]);
          }
#pragma unroll
        for (int h = 0; h < HP; ++h)
          if (h < nh)
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int v = lane + G * k;
              if (v < vecs)
#pragma unroll
                for (int i = 0; i < V; ++i)
                  acc[k][i] = fmaf(ur[h], cn[h][k][i], acc[k][i]);
            }
      }
    }
  }
  const int slot = pc.slot[piece];
  float* orow = slot < 0 ? dx + static_cast<size_t>(pc.row[piece]) * dim
                         : part + static_cast<size_t>(slot) * dim;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = lane + G * k;
    if (v < vecs) store<V>(orow, v, acc[k]);
  }
}

struct DuWalk {
  static constexpr bool kHalfVectors = false;
  template <typename T, int G, int V, int K, int HP>
  static cudaError_t launch(const Pieces& pc, const DualArgs& a,
                            cudaStream_t s) {
    dual_gather_kernel<T, G, V, K, HP><<<blocks_for<G>(pc), kThreads, 0, s>>>(
        pc, static_cast<const int*>(a.col), static_cast<const T*>(a.x),
        static_cast<const float*>(a.ct_num),
        static_cast<const float*>(a.ct_den), static_cast<float*>(a.du),
        a.dim, a.heads, a.n_slots);
    return cudaGetLastError();
  }
};

struct DxWalk {
  static constexpr bool kHalfVectors = false;
  template <typename T, int G, int V, int K, int HP>
  static cudaError_t launch(const Pieces& pc, const DualArgs& a,
                            cudaStream_t s) {
    dual_gather_dx_kernel<G, V, K, HP><<<blocks_for<G>(pc), kThreads, 0, s>>>(
        pc, static_cast<const int*>(a.col), static_cast<const int*>(a.rev),
        static_cast<const float*>(a.u), static_cast<const float*>(a.ct_num),
        static_cast<float*>(a.dx), static_cast<float*>(a.part), a.dim,
        a.heads, a.uvec);
    return cudaGetLastError();
  }
};

// The second pass over the rows of several pieces (merge_partials)
__global__ void __launch_bounds__(kMergeThreads)
dual_gather_merge_kernel(
    Pieces pc, const float* __restrict__ part, int stride, int width,
    float* __restrict__ out_a, int width_a, float* __restrict__ out_b) {
  merge_partials(pc.multi_ptr, pc.multi_row, pc.n_multi, part, stride,
                 width, out_a, width_a, out_b);
}

}  // namespace

// K11 over the row pieces piece_ptr, piece_row, piece_slot [n_pieces] and
// multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py, ColPieces of rowptr:
// Graph.row_pieces) and the CSR columns col: du [n_slots, heads] (its
// padding slots, from the valid edges' end piece_ptr[n_pieces] on,
// written 0) and, with rev, dx [n_rows, dim], from u [n_slots, heads], the
// table x [n_rows, dim], ct_num [n_rows, heads * dim] and ct_den [n_rows,
// heads]. rev and dx are null together (a directed graph: du only); part
// [multi_ptr[n_multi], dim] holds the pieces' partial rows of dx
// (nullable without rev or without multi-piece rows). lanes, vec: the du
// walk's G and V, and tables, as gnpde_dual_scatter takes them (ct_num on
// a 16-byte boundary with 16-byte vectors); dx_lanes, dx_vec: the dx
// walk's over the float32 rows of ct_num (kernels/lanes.py).
extern "C" int gnpde_dual_gather(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* rev, const void* u, const void* x, const void* ct_num,
    const void* ct_den, void* du, void* dx, void* part, int n_rows,
    int n_pieces, int n_multi, int n_slots, int dim, int heads, int lanes,
    int vec, int dx_lanes, int dx_vec, int tables, void* stream) {
  if ((rev == nullptr) != (dx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || dim <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const Pieces pc = make_pieces(piece_ptr, piece_row, piece_slot, multi_row,
                                multi_ptr, n_pieces, n_multi);
  DualArgs a{col, rev, u,    x,   ct_num, ct_den,  nullptr, nullptr,
             du,  dx,  part, dim, heads,  n_slots, 1};
  cudaError_t err = launch_dual<DuWalk>(lanes, vec, tables, pc, a, s);
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  err = launch_dual<DxWalk, false>(dx_lanes, dx_vec, 0, pc, a, s);
  if (err == cudaSuccess)
    err = merge(dual_gather_merge_kernel, pc, part, dim, dim, dx, dim,
                nullptr, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
