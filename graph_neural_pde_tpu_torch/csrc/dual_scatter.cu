// K10 dual_scatter and K11 dual_gather: the aggregation of the composed
// attention right-hand side (squareplus, reweighted or GAT attention over a
// row-sorted graph) and its gradient.
//
//   K10  num[n, h*D + d] = sum_{e in row n} u[e, h] * x[col[e], d]
//        den[n, h]       = sum_{e in row n} u[e, h]
//   K11  du[e, h] = ct_num[row[e], h, :] . x[col[e], :] + ct_den[row[e], h]
//        dx[c, :] = sum_{e: col[e] = c} sum_h u[e, h] * ct_num[row[e], h, :]
//
// K10 replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _scatter2_kernel / _stripe_scatter2_call, K11 its gradient
// _gather2_kernel / _stripe_gather2_call together with the products XLA
// forms around them. On the TPU the per-edge outer product
// vals = u (x) x[col] is first written out as an [E, H*D] array and then
// summed per row by a one-hot matmul, and the gradient gathers ct_num[row]
// back to [E, H*D] before XLA contracts it; both forms exist because a TPU
// has no fast indexed access. Here the x[col] gather and the outer product
// are fused into the row walk, and the gradient's dot products and sums
// into its own, so no [E, H*D] array ever exists in device memory.
//
// What bounds them on the H100: the gathers. K10 does 2*H flops per
// gathered element of x[col[e]] and writes H*D floats per row; K11
// gathers x[col[e]] (D elements) and, on a symmetric graph, ct_num[col[e]]
// (H*D floats) per edge for 4*H*D flops. The arithmetic intensity stays
// far below the card's ridge point, so what decides the time is how many
// gathered rows are in flight and how many lanes do useful work.
//
// Design (K1's lane groups, csr_spmm.cu, applied to both; K11 lives in
// dual_gather.cu, the code both share in dual_common.cuh). The first
// version gave every row a whole warp with lanes over the features, 4-byte
// loads and one edge's row in flight at a time; K10 read u[e, h] as H
// broadcast loads an edge and summed den on every lane, K11 kept ct_num[n]
// in shared memory and reduced each of an edge's H dot products over the
// whole warp (40 shuffles an edge at H = 8), and a hub row walked all its
// edges on one warp. Here:
// * A group of G lanes (a power of two from 4 to 32, chosen with the
//   vector width V by kernels/lanes.py from the row width, the tables'
//   addresses and x's dtype; a group never straddles a warp) owns one
//   piece of a row: K11 walks every row in pieces of at most COL_PIECE
//   edges (Graph.row_pieces), K10 only the rows longer than SCATTER_WHOLE
//   edges (Graph.scatter_pieces), since its partial rows hold H * D
//   floats (ops/graph.py has the times that set both). Lane l
//   holds the vectors l, l + G, ... (K of them, D / V / G rounded up to 1
//   or 2, or 8 single elements: one pass covers the row). x is read as
//   V-element vectors (16-byte loads where D and the address allow) and
//   widened as it is loaded.
// * The heads go in passes of HP (a power of two, at most 8, that keeps
//   HP * K * V floats of sums, or of ct_num[row], at most GNPDE_DUAL_ACC a
//   lane); every shape the models run takes one pass.
// * The piece's col (K11's dx walk: col and rev) are staged a round at a
//   time, one edge a lane, and broadcast by shuffles within the group;
//   then U edges' rows are loaded before their arithmetic (K10: x[col] and
//   u[e, :], the latter as float4 / float2 loads where H allows, one
//   address for the whole group), U (at most 4) chosen so that they take
//   at most a set number of registers.
// * K10 sums num in registers, one fused multiply-add an edge per element
//   in edge order; den is summed once per head, in edge order, after the
//   walk, by the lane whose index is the head's (staging u and shuffling
//   it to every lane took a shuffle per head and edge and 100 registers a
//   thread at Cora's H = 8: 0.0120 ms against the first version's 0.0086,
//   probes/lanes.py, PERF.md).
// * K11 is two walks (dual_gather.cu). Its du walk keeps ct_num[row]'s
//   heads in registers, forms each edge's H partial dot products on its
//   lanes and reduces them over the group by a transposed butterfly: at
//   each of log2(G) xor levels a lane keeps half the heads it holds and
//   takes its partner's half of them, so lane l ends with head (l * HP) /
//   G (H - 1 + log2(G / H) shuffles an edge in place of H * 5), and it
//   writes du's padding slots itself (0), so the wrapper allocates du
//   without a memset. Its dx walk sums dx[row] in registers in edge order
//   through the reverse-edge map of a symmetric edge multiset: the edges
//   whose column is n are the reverses rev[e'] of row n's own edges e', so
//   dx[n] reads u[rev[e']] and ct_num[col[e']]. On a directed graph the
//   wrapper passes rev = dx = null: K11 writes du only, and dx is K1
//   (csr_spmm.cu) walked over the CSC view in table mode.
// * A row of one piece is written by its group; the pieces of a longer row
//   write their partial sums (K10: num and den; K11: dx), which a second
//   kernel (dual_scatter_merge_kernel, dual_gather_merge_kernel) adds in
//   piece order.
// There are no atomics: every output element is summed in a fixed order
// (edges in a piece, then pieces in order; every butterfly the same on
// every run), so two launches agree bit for bit, which the solver's replay
// of accepted steps relies on.
//
// The gathered table x may be bfloat16 (the JAX package's
// rhs_payload_dtype: the composed RHS's x[col] payload, P4/P5 under
// pay_dt). Each gathered element is widened to float32 as it is loaded, and
// u, the cotangents, the sums and every output stay float32. On the TPU
// the stripe kernels also round u and the products u * x[col] to bfloat16;
// here only the table is rounded, as the JAX package's XLA composition
// rounds it.

#include "dual_common.cuh"

namespace {

// The registers a batch of K10's edges' x rows and u[e, h0 : h0 + HP]
// may take; probes/lanes.py builds variants
#ifndef GNPDE_DUAL_BATCH_REGS
#define GNPDE_DUAL_BATCH_REGS 24
#endif
// The blocks an SM keeps resident (the register cap)
constexpr int kScatterBlocks = 3;

// The floats of a partial row of K10, [H*D] num then [H] den, rounded up
// to 16 bytes so that every partial row's num lies on that boundary
__host__ __device__ constexpr int scatter_part_stride(int dim, int heads) {
  return (heads * (dim + 1) + 3) / 4 * 4;
}

// K10 over one piece a group: num and den of the piece's edges, to the
// row (a row of one piece) or to its partial row part[slot]. At least
// kScatterBlocks blocks an SM: the Cora stand-in's 2,708 rows, a warp a
// row, are then all resident at once.
template <typename T, int G, int V, int K, int HP>
__global__ void __launch_bounds__(kThreads, kScatterBlocks)
    dual_scatter_kernel(Pieces pc, const int* __restrict__ col,
                        const float* __restrict__ u, const T* __restrict__ x,
                        float* __restrict__ num, float* __restrict__ den,
                        float* __restrict__ part, int dim, int heads,
                        int uvec) {
  using RawT = typename Raw<T, V>::type;
  // an edge's x row and u[e, h0 : h0 + HP]
  constexpr int U =
      batch_of(GNPDE_DUAL_BATCH_REGS, K * kRawRegs<T, V> + HP);
  const int lane = threadIdx.x % G;
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;            // whole groups leave together
  const unsigned group = group_mask<G>();
  const int row = pc.row[piece];
  const int start = pc.ptr[piece], end = pc.ptr[piece + 1];
  const int slot = pc.slot[piece];
  const size_t hd = static_cast<size_t>(heads) * dim;
  float* nrow = slot < 0 ? num + row * hd
                         : part + static_cast<size_t>(slot)
                                      * scatter_part_stride(dim, heads);
  float* drow = slot < 0 ? den + static_cast<size_t>(row) * heads
                         : nrow + hd;
  const int vecs = dim / V;
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    float acc[HP][K][V];
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[h][k][i] = 0.0f;
    for (int e0 = start; e0 < end; e0 += G) {  // G >= 4 >= U: a lane an edge
      const int c = e0 + lane < end ? col[e0 + lane] : 0;
      const int n = min(G, end - e0);
      // not unrolled: unrolled, the batches took 80 registers and spilled
      // (0.4306 ms at arxiv scale against 0.3787, probes/lanes.py)
#pragma unroll 1
      for (int j = 0; j < n; j += U) {
        RawT xr[U][K];
        float w[U][HP];                        // u[e, h0 : h0 + HP]
#pragma unroll
        for (int b = 0; b < U; ++b) {
          const T* xrow =
              x + static_cast<size_t>(from_lane<G>(group, c, j + b)) * dim;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = lane + G * k;
            if (j + b < n && v < vecs) xr[b][k] = load<T, V>(xrow, v);
          }
          load_heads<HP>(u, e0 + j + b, h0, heads, uvec, j + b < n, w[b]);
        }
#pragma unroll
        for (int b = 0; b < U; ++b) {
          if (j + b >= n) break;               // the same for the group
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = lane + G * k;
            if (v < vecs) {
              float xv[V];
              widen(xr[b][k], xv);
#pragma unroll
              for (int h = 0; h < HP; ++h)
                if (h < nh)
#pragma unroll
                  for (int i = 0; i < V; ++i)
                    acc[h][k][i] = fmaf(w[b][h], xv[i], acc[h][k][i]);
            }
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
          if (v < vecs) store<V>(nrow + static_cast<size_t>(h0 + h) * dim, v,
                                 acc[h][k]);
        }
    // den: lane h sums head h0 + h over the piece's edges in order (their
    // u rows are in L1 after the walk)
    for (int h = lane; h < nh; h += G) {
      float d = 0.0f;
#pragma unroll 4
      for (int e = start; e < end; ++e)
        d += __ldg(u + static_cast<size_t>(e) * heads + h0 + h);
      drow[h0 + h] = d;
    }
  }
}

struct ScatterWalk {
  // a bfloat16 table is also read as 8-byte vectors (4 elements) at 32
  // lanes, where 16-byte ones would leave 8 heads' sums 64 registers
  static constexpr bool kHalfVectors = true;
  template <typename T, int G, int V, int K, int HP>
  static cudaError_t launch(const Pieces& pc, const DualArgs& a,
                            cudaStream_t s) {
    dual_scatter_kernel<T, G, V, K, HP>
        <<<blocks_for<G>(pc), kThreads, 0, s>>>(
            pc, static_cast<const int*>(a.col),
            static_cast<const float*>(a.u), static_cast<const T*>(a.x),
            static_cast<float*>(a.num), static_cast<float*>(a.den),
            static_cast<float*>(a.part), a.dim, a.heads, a.uvec);
    return cudaGetLastError();
  }
};

// The second pass over the rows of several pieces (merge_partials)
__global__ void __launch_bounds__(kMergeThreads)
dual_scatter_merge_kernel(
    Pieces pc, const float* __restrict__ part, int stride, int width,
    float* __restrict__ out_a, int width_a, float* __restrict__ out_b) {
  merge_partials(pc.multi_ptr, pc.multi_row, pc.n_multi, part, stride,
                 width, out_a, width_a, out_b);
}

}  // namespace

// K10 over the row pieces piece_ptr, piece_row, piece_slot [n_pieces] and
// multi_row, multi_ptr [n_multi (+ 1)] (ops/graph.py, ColPieces of rowptr:
// Graph.scatter_pieces) and the CSR columns col: num [n_rows, heads * dim]
// and
// den [n_rows, heads] from u [E, heads] and the table x [n_rows, dim].
// part [multi_ptr[n_multi], heads * (dim + 1) rounded up to a multiple of
// 4] holds the pieces' partial sums (nullable without multi-piece rows).
// lanes: G, vec: V, chosen by the wrapper (kernels/lanes.py: G in 4, 8,
// 16, 32 with 16-byte vectors, or 32 with 8-byte bfloat16 ones or V = 1;
// x on a V-element boundary, num and part on a 16-byte one); tables: the
// table x, 0 for float32, 1 for bfloat16 (u, num and den are float32).
extern "C" int gnpde_dual_scatter(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* col,
    const void* u, const void* x, void* num, void* den, void* part,
    int n_rows, int n_pieces, int n_multi, int dim, int heads, int lanes,
    int vec, int tables, void* stream) {
  if (n_rows <= 0 || dim <= 0 || heads <= 0)
    return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const Pieces pc = make_pieces(piece_ptr, piece_row, piece_slot, multi_row,
                                multi_ptr, n_pieces, n_multi);
  DualArgs a{col,     nullptr, u,    x,   nullptr, nullptr, num, den,
             nullptr, nullptr, part, dim, heads,   0,       1};
  cudaError_t err = launch_dual<ScatterWalk>(lanes, vec, tables, pc, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = merge(dual_scatter_merge_kernel, pc, part,
              scatter_part_stride(dim, heads), heads * (dim + 1), num,
              heads * dim, den, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
