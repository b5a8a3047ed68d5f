// K18 fused_aggregate for the scaled-dot score, and K19 fused_score_max:
// see payload_walk.cuh for what they replace, what bounds them and how
// their walk is laid out.
//
//   num[n, h D + d] = sum_e u_eh x_g[e, d],  den[n, h] = sum_e u_eh,
//   u_eh = exp(<x_g[e], r_nh> + c_nh - gmax - shift_eh)   (or squareplus)
//
// over the edges e of row n in order; K19 the largest s_eh = <x_g[e],
// r_nh> + c_nh over every edge and head, formed by the same lanes, batches
// and butterfly as K18's, so that the shift the bench's oracle hands K18
// is the maximum of the very scores K18 exponentiates.

#include <math_constants.h>

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
  merge_partials(pc.multi_ptr, pc.multi_row, pc.n_multi, part, stride,
                 width, out_a, width_a, out_b);
}

// ---------------------------------------------------------------------- K19
//
// A NaN score wins, as in the plain version; a maximum does not depend on
// the order of its terms, and no atomics: two launches agree bit for bit.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// K19's blocks: 128 threads, so that a small graph's pieces still spread
// over the SMs (the oracle's 512 rows: 128 blocks of 4 groups of 32 lanes);
// twice K18's blocks an SM, so the same registers a thread
constexpr int kMaxThreads = 128;

// Kw^T's rows into the SM's L1 before the fold reads them: fold_row reads
// a head's d_k rows one after another, each a round trip to the L2 where
// the block is the SM's first to read it
__device__ __forceinline__ void prefetch_rows(const float* p, size_t floats) {
  const char* c = reinterpret_cast<const char*>(p);
  for (size_t off = threadIdx.x * size_t{128}; off < floats * 4;
       off += size_t{128} * kMaxThreads)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(c + off));
}

// K19 over one piece a group: the largest score of the piece's edges and
// the pass's heads (the lanes past the row's heads hold none); the warp's
// maxima, then the block's, to a.part[blockIdx.x]. Kw^T is prefetched into
// L1 and the first batch of payload rows loaded before the fold, so that
// their round trips overlap.
template <typename T, int G, int V, int K, int HP>
__global__ void __launch_bounds__(
    kMaxThreads, 2 * payload_min_blocks(HP, K, sizeof(T), false))
payload_score_max_kernel(Pieces pc, PayloadArgs a) {
  static_assert(G >= HP, "a lane holds one head after the butterfly");
  using RawT = typename Raw<T, V>::type;
  constexpr int U = batch_of(kPayloadBatchRegs, K * kRawRegs<T, V>);
  __shared__ float warp_max[kMaxThreads / 32];
  const int lane = threadIdx.x % G;
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kMaxThreads + threadIdx.x) / G;
  float m = -CUDART_INF_F;
  prefetch_rows(a.kwt, static_cast<size_t>(a.att) * a.dim);
  if (piece < pc.n_pieces) {                   // whole groups; no return: a
    const unsigned group = group_mask<G>();    // barrier follows
    const int row = pc.row[piece];
    const int start = pc.ptr[piece], end = pc.ptr[piece + 1];
    const int dim = a.dim, heads = a.heads, vecs = dim / V;
    const T* xg = static_cast<const T*>(a.xg);
    const int hl = lane * HP / G;              // the lane's head
    for (int h0 = 0; h0 < heads; h0 += HP) {
      const int nh = min(HP, heads - h0);
      RawT xr[U][K];
      load_batch<T, G, V, K, U>(xg, start, end, dim, lane, xr);
      float r[HP][K][V], c[HP];
      fold_row<G, V, K, HP>(a, row, h0, nh, lane, end > start, r, c);
      const float cl = at_head<HP>(c, hl);
#pragma unroll 1
      for (int e0 = start; e0 < end; e0 += U) {
        if (e0 != start) load_batch<T, G, V, K, U>(xg, e0, end, dim, lane, xr);
#pragma unroll
        for (int b = 0; b < U; ++b) {
          if (e0 + b >= end) break;            // the same for the group
          float s[HP];
#pragma unroll
          for (int h = 0; h < HP; ++h) s[h] = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = lane + G * k;
            float xv[V];
            if (v < vecs) {
              widen(xr[b][k], xv);
            } else {
#pragma unroll
              for (int i = 0; i < V; ++i) xv[i] = 0.0f;
            }
#pragma unroll
            for (int h = 0; h < HP; ++h)
#pragma unroll
              for (int i = 0; i < V; ++i) s[h] = fmaf(r[h][k][i], xv[i], s[h]);
          }
          group_head_sums<G, HP>(s, group, lane);
          if (hl < nh) m = max_nan(m, s[0] + cl);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_max[0];
    for (int w = 1; w < kMaxThreads / 32; ++w) b = max_nan(b, warp_max[w]);
    a.part[blockIdx.x] = b;
  }
}

template <int G>
int max_blocks(const Pieces& pc) {
  const long long threads = static_cast<long long>(pc.n_pieces) * G;
  return static_cast<int>((threads + kMaxThreads - 1) / kMaxThreads);
}

struct ScoreMaxWalk {
  template <typename T, int G, int V, int K, int HP>
  static cudaError_t launch(const Pieces& pc, const PayloadArgs& a,
                            cudaStream_t s) {
    payload_score_max_kernel<T, G, V, K, HP>
        <<<max_blocks<G>(pc), kMaxThreads, 0, s>>>(pc, a);
    return cudaGetLastError();
  }
};

// out[0] = the largest of partial[0 .. count), 0 unless it is finite (an
// edgeless graph: -inf): one block of a power of two of threads, at most
// kFinishThreads (finish_threads), each thread's partials a block apart in
// four maxima, then a tree
constexpr int kFinishThreads = 1024;

int finish_threads(int count) {
  int t = 32;
  while (t < kFinishThreads && 4 * t < count) t *= 2;
  return t;
}

__global__ void __launch_bounds__(kFinishThreads)
payload_score_max_finish_kernel(const float* __restrict__ partial,
                                int count, float* __restrict__ out) {
  __shared__ float red[kFinishThreads];
  const int n = blockDim.x;
  float m[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  int i = threadIdx.x;
  for (; i + 3 * n < count; i += 4 * n) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = max_nan(m[k], __ldg(partial + i + k * n));
  }
  for (; i < count; i += n) m[0] = max_nan(m[0], partial[i]);
  red[threadIdx.x] = max_nan(max_nan(m[0], m[1]), max_nan(m[2], m[3]));
  __syncthreads();
  for (int s = n / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = max_nan(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = isfinite(red[0]) ? red[0] : 0.0f;
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

// K19 over the row pieces as above (multi_row, multi_ptr unread) and the
// per-edge payload xg [n_slots, dim] (float32, or bfloat16: tables 1):
// out[0], the largest scaled-dot score <q[n], xg[e] Kw + kb>_h / sqrt(d_k)
// over every edge and head, 0 unless finite. q [n_rows, att], kwt [att,
// dim] = Kw^T; partial [max(1, n_pieces lanes / 128 rounded up)] is
// scratch, each block's maximum. lanes: G, vec: V (kernels/lanes.py,
// payload_walk).
extern "C" int gnpde_payload_score_max(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* xg,
    const void* q, const void* kwt, const void* kb, void* partial, void* out,
    int n_rows, int n_pieces, int dim, int att, int heads, int lanes, int vec,
    int tables, void* stream) {
  if (dim <= 0 || heads <= 0 || att % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  if (n_rows > 0 && n_pieces > 0) {
    const Pieces pc = make_pieces(piece_ptr, piece_row, piece_slot,
                                  multi_row, multi_ptr, n_pieces, 0);
    PayloadArgs a = payload_args(xg, q, kwt, kb, nullptr, dim, att, heads, 0);
    a.part = static_cast<float*>(partial);
    const cudaError_t err =
        launch_payload<ScoreMaxWalk>(lanes, vec, tables, pc, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = static_cast<int>(
        (static_cast<long long>(n_pieces) * lanes + kMaxThreads - 1) /
        kMaxThreads);
  }
  payload_score_max_finish_kernel<<<1, finish_threads(blocks), 0, s>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
