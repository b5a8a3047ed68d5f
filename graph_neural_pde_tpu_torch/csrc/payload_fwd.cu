// K18 fused_aggregate for the scaled-dot score: see payload_walk.cuh for
// what it replaces, what bounds it and how its walk is laid out.
//
//   num[n, h D + d] = sum_e u_eh x_g[e, d],  den[n, h] = sum_e u_eh,
//   u_eh = exp(<x_g[e], r_nh> + c_nh - gmax - shift_eh)   (or squareplus)
//
// over the edges e of row n in order.

#include "payload_walk.cuh"

namespace {

// K18 over one piece a group: num and den of the piece's edges, to the row
// (a row of one piece) or to its partial row part[slot] ([num | den]).
template <typename T, int G, int V, int K, int HP>
__global__ void __launch_bounds__(
    kThreads, payload_min_blocks(HP, K, sizeof(T), false))
payload_aggregate_kernel(Pieces pc, PayloadArgs a) {
  static_assert(G >= HP, "a lane holds one head after the butterfly");
  using RawT = typename Raw<T, V>::type;
  constexpr int U = batch_of(kPayloadBatchRegs, K * kRawRegs<T, V>);
  const int lane = threadIdx.x % G;
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;            // whole groups leave together
  const unsigned group = group_mask<G>();
  const int row = pc.row[piece];
  const int start = pc.ptr[piece], end = pc.ptr[piece + 1];
  const int slot = pc.slot[piece];
  const int dim = a.dim, heads = a.heads, vecs = dim / V;
  const size_t hd = static_cast<size_t>(heads) * dim;
  float* nrow = slot < 0 ? a.num + row * hd
                         : a.part + static_cast<size_t>(slot) * a.stride;
  float* drow = slot < 0 ? a.den + static_cast<size_t>(row) * heads
                         : nrow + hd;
  const T* xg = static_cast<const T*>(a.xg);
  const float gmax = __ldg(a.gmax);
  const int hl = lane * HP / G;                // the lane's head
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    float r[HP][K][V], c[HP];
    fold_row<G, V, K, HP>(a, row, h0, nh, lane, end > start, r, c);
    const float cl = at_head<HP>(c, hl);
    float acc[HP][K][V];
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[h][k][i] = 0.0f;
    float dsum = 0.0f;                         // den of head hl, edge order
#pragma unroll 1
    for (int e0 = start; e0 < end; e0 += U) {
      RawT xr[U][K];
      load_batch<T, G, V, K, U>(xg, e0, end, dim, lane, xr);
#pragma unroll
      for (int b = 0; b < U; ++b) {
        if (e0 + b >= end) break;              // the same for the group
        float xv[K][V];
        float s[HP];
#pragma unroll
        for (int h = 0; h < HP; ++h) s[h] = 0.0f;
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
            for (int i = 0; i < V; ++i) s[h] = fmaf(r[h][k][i], xv[k][i], s[h]);
        }
        group_head_sums<G, HP>(s, group, lane);
        float sm = s[0] + cl - gmax;
        if (a.shifts != nullptr && hl < nh)
          sm -= __ldg(a.shifts + static_cast<size_t>(e0 + b) * heads + h0 +
                      hl);
        float u, duds;
        payload_u(sm, a.square_plus, &u, &duds);
        dsum += u;
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          const float uh = from_lane<G>(group, u, h * (G / HP));
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[h][k][i] = fmaf(uh, xv[k][i], acc[h][k][i]);
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
            store<V>(nrow + static_cast<size_t>(h0 + h) * dim, v, acc[h][k]);
        }
    if (writes_head<G, HP>(lane) && hl < nh) drow[h0 + hl] = dsum;
  }
}

struct AggregateWalk {
  template <typename T, int G, int V, int K, int HP>
  static cudaError_t launch(const Pieces& pc, const PayloadArgs& a,
                            cudaStream_t s) {
    payload_aggregate_kernel<T, G, V, K, HP>
        <<<blocks_for<G>(pc), kThreads, 0, s>>>(pc, a);
    return cudaGetLastError();
  }
};

// The second pass over the rows of several pieces (merge_partials)
__global__ void __launch_bounds__(kMergeThreads)
payload_aggregate_merge_kernel(
    Pieces pc, const float* __restrict__ part, int stride, int width,
    float* __restrict__ out_a, int width_a, float* __restrict__ out_b) {
  merge_partials(pc, part, stride, width, out_a, width_a, out_b);
}

}  // namespace

// K18 for the scaled-dot score over the row pieces piece_ptr, piece_row,
// piece_slot [n_pieces] and multi_row, multi_ptr [n_multi (+ 1)]
// (ops/graph.py, Graph.scatter_pieces) and the per-edge payload xg
// [n_slots, dim] (float32, or bfloat16: tables 1): num [n_rows, heads dim],
// den [n_rows, heads]. q [n_rows, att] = x_n Qw + qb; kwt [att, dim] = Kw^T
// (the walk folds each row from them); shifts [n_slots, heads] nullable;
// part [multi_ptr[n_multi], S] (S = heads (dim + 1) rounded up to a
// multiple of 4; nullable without multi-piece rows). lanes: G, vec: V (kernels/lanes.py,
// payload_walk).
extern "C" int gnpde_payload_aggregate(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* xg,
    const void* q, const void* kwt, const void* kb, const void* gmax,
    const void* shifts, void* num, void* den, void* part,
    int n_rows, int n_pieces, int n_multi, int dim, int att, int heads,
    int square_plus, int lanes, int vec, int tables, void* stream) {
  if (n_rows <= 0 || dim <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  if (att % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Pieces pc = make_pieces(piece_ptr, piece_row, piece_slot, multi_row,
                                multi_ptr, n_pieces, n_multi);
  PayloadArgs a = payload_args(xg, q, kwt, kb, gmax, dim, att, heads,
                               square_plus);
  a.shifts = static_cast<const float*>(shifts);
  a.num = static_cast<float*>(num);
  a.den = static_cast<float*>(den);
  a.part = static_cast<float*>(part);
  cudaError_t err = launch_payload<AggregateWalk>(lanes, vec, tables, pc, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = merge(payload_aggregate_merge_kernel, pc, part, a.stride,
              heads * (dim + 1), num, heads * dim, den, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
