// K18 fused_aggregate and K8's per-head mode fused_rhs_bwd_heads for the
// scaled-dot score: the GRAND-nl attention right-hand side's numerators and
// denominators over a per-EDGE payload x_g [n_slots, D] (row-sorted, edge e
// at row e), and their backward from per-head cotangents. They replace the
// TPU kernels of graph_neural_pde_tpu/ops/pallas/fused_rhs.py _rhs_kernel /
// _fused_call (K18) and _bwd_kernel's non-separable branch /
// _fused_bwd_mega_call with recip_p=None (the per-head mode) for that score;
// the other four families, whose scores need each edge's key, stay on
// fused_payload.cu's walk. This header holds what payload_fwd.cu (K18) and
// payload_bwd.cu (the per-head mode) share; each source gets its own copy
// (anonymous namespace) and compiles with its own nvcc.
//
// The fold. The scaled-dot score is linear in the key k_e = x_g[e] Kw + kb,
// so Kw folds into each row's query once:
//     r_nh = Kw_h q_nh / sqrt(d_k),  c_nh = <q_nh, kb_h> / sqrt(d_k),
//     s_eh = <x_g[e], r_nh> + c_nh,
// and no edge needs its key. Backward, with ds_eh = (<ct_num[n, h], x_g[e]>
// + ct_den[n, h]) du/ds:
//     a_nh = sum_e ds_eh x_g[e],  b_nh = sum_e ds_eh         (the walk)
//     dxg[e] = sum_h (u_eh ct_num[n, h] + ds_eh r_nh)         (the walk)
//     dq_nh = (Kw_h^T a_nh + b_nh kb_h) / sqrt(d_k)            (node level)
//     [dKw | dKb]_h = sum_n [a_nh | b_nh]^T q_nh / sqrt(d_k)   (over nodes)
// q = x_n Qw + qb is dense.cuh's node projection tile, launched by the
// wrappers (kernels/fused_rhs.py); dq and [dKw | dKb] are payload_bwd.cu's
// node pass, head by head (the products are block-diagonal in the heads).
// The TPU kernels project every edge's key (2 D ATT flops an edge) and, in
// the backward, form each edge's dk_e and dk_e Kw^T (as fused_payload.cu
// still does for the other families, its wrapper zeroing dxg and an
// [E, ATT] dk scratch before every call).
//
// What bounds them on the H100: the stream of x_g (and, backward, of dxg):
// with the fold each payload row is read once, contiguously and without an
// index, for 4 H D flops (K18) or 10 H D (backward), far below the card's
// ridge point. So the walks are built to keep the loads in flight:
// * A group of G lanes (8, 16 or 32, chosen with the vector width V by
//   kernels/lanes.py's payload_walk entry from D, the tables' addresses and
//   the payload's dtype) owns one piece of a row (Graph.scatter_pieces: rows
//   of up to SCATTER_WHOLE edges whole, longer ones in pieces of COL_PIECE).
//   Lane l holds the row's vectors l, l + G, ... (K of them).
// * The group forms r_n and c_n of the pass's heads in registers from q_n
//   and Kw^T (each piece folds its row again: A D / G fused multiply-adds a
//   lane). A node table [r | c] read by the walk instead writes and reads
//   N S floats more; it took longer at every measured shape but the
//   per-head mode over arxiv's bf16 payload: K18 at arxiv 0.8457 ms
//   against 0.6844, on (u)'s quarter shard 0.4939 against 0.2938 (H100,
//   PERF.md).
// * Edges go in batches of U whose payload rows are loaded before their
//   arithmetic (contiguous rows: no index, no shuffle of columns). (The
//   next batch's loads issued before this one's arithmetic took 94
//   registers a thread in place of 64 and 0.86 ms in place of 0.61 for
//   K18's walk at arxiv: probes/payload_walk.py, PERF.md.) Each
//   edge's H partial dots (backward 2 H: the score's and ct_num's) are
//   reduced over the group by the transposed butterfly (group_head_sums),
//   so lane l ends with head l HP / G; that lane forms u (and ds), adds it
//   to the row's den (b) in edge order, and 2 HP shuffles hand every lane
//   each head's u (and ds).
// * K18 sums num in registers in edge order; the backward writes each
//   edge's dxg row whole (its padding slots too: no memset) and sums a_nh in
//   registers. Heads go in passes of HP (a power of two, at most 8, whose
//   HP K V floats of each register array stay within kPayloadAcc);
//   a later pass adds its heads' terms to the dxg row the first wrote.
// * A row of one piece is written by its group; the pieces of a longer row
//   write partial rows that a merge kernel adds in piece order.
// No atomics: every output element is summed in a fixed order, so two
// launches agree bit for bit.
//
// The payload may be bfloat16 (the JAX package's bf16 payload): each element
// is widened to float32 as it is loaded; q, r, c, the cotangents, every sum
// and every output stay float32, and k_e (never formed) is the unrounded
// x_g[e] Kw + kb that the JAX package's composition takes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dual_common.cuh"

namespace {

// The floats of each register array (r, num or a, ct_num) a lane keeps per
// head pass
constexpr int kPayloadAcc = 32;
// The registers one batch of payload rows may take (8 took K18's walk at
// arxiv 0.83 ms against 0.61: PERF.md)
constexpr int kPayloadBatchRegs = 16;

// The blocks of 256 threads an SM must keep resident (the register cap)
// in the passes of 1 or 2 heads over one vector a lane (the arxiv widths),
// by the payload's dtype and walk; more heads or vectors leave the
// compiler free. Measured on an H100 (PERF.md): over a float32 payload 4
// (64 registers: K18 at arxiv 0.6806 ms against 0.9703 uncapped, 0.756 at
// 3; the per-head mode 1.5336 against 1.7260); over a bfloat16 one 3 for
// K18 (0.5871 against 0.7007; 4 spilled 140 bytes: 0.7844) and none for
// the per-head walk (the per-head mode 1.6859; 3 blocks 1.8941).
__host__ __device__ constexpr int payload_min_blocks(int hp, int k,
                                                     int elem_bytes,
                                                     bool backward) {
  return hp > 2 || k > 1   ? 1
         : elem_bytes == 4 ? 4
         : backward        ? 1
                           : 3;
}

// What a walk reads and writes, beside its pieces
struct PayloadArgs {
  const void* xg;        // [n_slots, dim] of T
  const float* q;        // [n_rows, att]: x_n Qw + qb
  const float* kwt;      // [att, dim]: Kw^T
  const float* kb;       // [att]
  const float* gmax;     // [1]
  const float* shifts;   // [n_slots, heads], nullable (K18)
  const float* ct_num;   // [n_rows, heads dim] (backward)
  const float* ct_den;   // [n_rows, heads]
  float* num;            // [n_rows, heads dim] (K18)
  float* den;            // [n_rows, heads]
  float* dxg;            // [n_slots, dim] (backward)
  float* ab;             // [n_rows, stride]: [a | b] (backward)
  float* part;           // [partial rows, stride], nullable without them
  int dim, att, heads, stride, n_slots, square_plus;
  float scale;           // 1 / sqrt(d_k)
};

// The arguments every payload kernel takes, the rest null
PayloadArgs payload_args(const void* xg, const void* q, const void* kwt,
                         const void* kb, const void* gmax,
                         int dim, int att, int heads, int square_plus) {
  PayloadArgs a = {};
  a.xg = xg;
  a.q = static_cast<const float*>(q);
  a.kwt = static_cast<const float*>(kwt);
  a.kb = static_cast<const float*>(kb);
  a.gmax = static_cast<const float*>(gmax);
  a.dim = dim;
  a.att = att;
  a.heads = heads;
  a.stride = payload_stride(dim, heads);
  a.square_plus = square_plus;
  a.scale = 1.0f / sqrtf(static_cast<float>(att / heads));
  return a;
}

template <int K, int V>
__host__ __device__ constexpr int payload_head_cap() {
  int hp = kPayloadAcc / (K * V);
  int p = 1;
  while (p * 2 <= hp && p * 2 <= kMaxHeadsPerPass) p *= 2;
  return p;
}

// u = exp(sm) or squareplus(sm), and du/dsm (fused_common.cuh's u_duds)
__device__ __forceinline__ void payload_u(float sm, int square_plus,
                                          float* u, float* duds) {
  if (square_plus) {
    const float r = sqrtf(sm * sm + 4.0f);
    *u = (sm + r) * 0.5f;
    *duds = (1.0f + sm / r) * 0.5f;
  } else {
    *u = expf(sm);
    *duds = *u;
  }
}

// V floats of a row this kernel writes (not through the read-only cache)
template <int V>
__device__ __forceinline__ void load_written(const float* r, int v,
                                             float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = r[v];
  } else if constexpr (V == 2) {
    const float2 f = reinterpret_cast<const float2*>(r)[v];
    o[0] = f.x;
    o[1] = f.y;
  } else {
    const float4* p = reinterpret_cast<const float4*>(r) + v * (V / 4);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) widen(p[i], o + 4 * i);
  }
}

// r[h] and c[h], the fold of row `row` for the pass's heads h0 + h (h < nh;
// the rest 0) over the lane's vectors, formed from q and Kw^T (only where
// the piece has edges).
template <int G, int V, int K, int HP>
__device__ __forceinline__ void fold_row(const PayloadArgs& a, int row,
                                         int h0, int nh, int lane,
                                         bool has_edges,
                                         float (&r)[HP][K][V],
                                         float (&c)[HP]) {
  const int vecs = a.dim / V;
#pragma unroll
  for (int h = 0; h < HP; ++h) {
    c[h] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) r[h][k][i] = 0.0f;
  }
  if (!has_edges) return;
  const int dk = a.att / a.heads;
  const float* qr = a.q + static_cast<size_t>(row) * a.att;
#pragma unroll
  for (int h = 0; h < HP; ++h) {
    if (h < nh) {
      const int a0 = (h0 + h) * dk;
      for (int j = 0; j < dk; ++j) {
        const float qv = __ldg(qr + a0 + j);
        c[h] = fmaf(qv, __ldg(a.kb + a0 + j), c[h]);
        const float* wr = a.kwt + static_cast<size_t>(a0 + j) * a.dim;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = lane + G * k;
          if (v < vecs) {
            float w[V];
            load_floats<V>(wr, v, w);
#pragma unroll
            for (int i = 0; i < V; ++i) r[h][k][i] = fmaf(qv, w[i], r[h][k][i]);
          }
        }
      }
      c[h] *= a.scale;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) r[h][k][i] *= a.scale;
    }
  }
}

// The payload rows [e0, e0 + U) (those before end) as the lanes hold them:
// U edges' K vectors a lane, loaded before their arithmetic
template <typename T, int G, int V, int K, int U>
__device__ __forceinline__ void load_batch(
    const T* __restrict__ xg, int e0, int end, int dim, int lane,
    typename Raw<T, V>::type (&xr)[U][K]) {
  const int vecs = dim / V;
#pragma unroll
  for (int b = 0; b < U; ++b) {
    const T* xrow = xg + static_cast<size_t>(e0 + b) * dim;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + G * k;
      if (e0 + b < end && v < vecs) xr[b][k] = load<T, V>(xrow, v);
    }
  }
}

// The value of a register array at the lane's own head hl (a select per
// head: no indexed access to registers)
template <int HP>
__device__ __forceinline__ float at_head(const float (&v)[HP], int hl) {
  float o = 0.0f;
#pragma unroll
  for (int h = 0; h < HP; ++h)
    if (h == hl) o = v[h];
  return o;
}

// The dispatch of a call to the instantiation of its payload type T, lane
// group G, vector width V, vectors a lane K and heads a pass HP: Walk::
// template launch<T, G, V, K, HP>(pc, a, s) launches the source's walk.
// HP: the heads rounded up to a power of two, at most payload_head_cap.
template <typename Walk, typename T, int G, int V, int K>
cudaError_t payload_hp(const Pieces& pc, const PayloadArgs& a,
                       cudaStream_t s) {
  constexpr int cap = payload_head_cap<K, V>();
  int hp = 1;
  while (hp < a.heads && hp < cap) hp *= 2;
#define GNPDE_PAYLOAD_HP(HP)                                              \
  if constexpr (HP <= cap) {                                              \
    if (hp == HP) return Walk::template launch<T, G, V, K, HP>(pc, a, s); \
  }
  GNPDE_PAYLOAD_HP(1)
  GNPDE_PAYLOAD_HP(2)
  GNPDE_PAYLOAD_HP(4)
  GNPDE_PAYLOAD_HP(8)
#undef GNPDE_PAYLOAD_HP
  return cudaErrorInvalidValue;
}

// K: 1 or 2 vectors of 16 (or 8) bytes a lane, 8 single elements a lane
template <typename Walk, typename T, int G, int V>
cudaError_t payload_k(const Pieces& pc, const PayloadArgs& a,
                      cudaStream_t s) {
  const int k = (a.dim / V + G - 1) / G;
  if constexpr (V == 1) {
    if (k <= 8) return payload_hp<Walk, T, G, V, 8>(pc, a, s);
  } else {
    if (k <= 1) return payload_hp<Walk, T, G, V, 1>(pc, a, s);
    if (k <= 2) return payload_hp<Walk, T, G, V, 2>(pc, a, s);
  }
  return cudaErrorInvalidValue;
}

// The (G, V) built: 16-byte vectors of T at G = 8, 16 or 32, 8-byte vectors
// of a bfloat16 payload at G = 32, single elements at G = 32 (kernels/
// lanes.py, payload_walk); tables: the payload's dtype, 0 float32, 1
// bfloat16. Every float table is read in vectors of V floats on their
// boundaries (the wrapper checks the addresses).
template <typename Walk>
cudaError_t launch_payload(int lanes, int vec, int tables, const Pieces& pc,
                           const PayloadArgs& a, cudaStream_t s) {
  if (vec <= 0 || a.dim % vec != 0 || (tables != 0 && tables != 1))
    return cudaErrorInvalidValue;
  auto gv = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    constexpr int kWide = 16 / static_cast<int>(sizeof(T));
    if (vec == kWide) {
      switch (lanes) {
        case 8: return payload_k<Walk, T, 8, kWide>(pc, a, s);
        case 16: return payload_k<Walk, T, 16, kWide>(pc, a, s);
        case 32: return payload_k<Walk, T, 32, kWide>(pc, a, s);
        default: return cudaErrorInvalidValue;
      }
    }
    if constexpr (sizeof(T) == 2) {
      if (vec == kWide / 2 && lanes == 32)
        return payload_k<Walk, T, 32, kWide / 2>(pc, a, s);
    }
    if (vec == 1 && lanes == 32) return payload_k<Walk, T, 32, 1>(pc, a, s);
    return cudaErrorInvalidValue;
  };
  return tables == 1 ? gv(__nv_bfloat16()) : gv(0.0f);
}

}  // namespace
