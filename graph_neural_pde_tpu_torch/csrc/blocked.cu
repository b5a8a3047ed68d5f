// K15 blocked_spmm and K16 blocked_sddmm: SpMM and SDDMM over a blocked
// edge plan (graph_neural_pde_tpu_torch/ops/plan.py): nodes tiled into
// blocks of B = block_n, edge slots bucketed by (row block, column block)
// in chunks of `chunk` slots, the chunks of one row block contiguous.
//
// K15: out[rb*B + row_local[s]] += w[s] * x[cb*B + col_local[s]] over the
//      plan's valid slots s (rb, cb: the row and column block of s's
//      chunk); out is [N_pad, D], N_pad a multiple of B.
// K16: out[s] = a[rb*B + row_local[s]] . b[cb*B + col_local[s]] for every
//      slot, padding included (there row_local = col_local = 0, so a
//      chunk's padding slots all hold a[rb*B] . b[cb*B]).
//
// Replace the TPU kernels graph_neural_pde_tpu/ops/pallas/spmm_blocked.py
// _spmm_kernel / _spmm_call (P17) and _sddmm_kernel / _sddmm_call (P18).
// On the TPU each grid step turns one chunk's gather and scatter into
// one-hot matmuls against node blocks held in VMEM (4 * B * D flops per
// slot), because a TPU has no fast indexed access. Hopper has it, so
// these kernels index directly.
//
// What bounds them on the H100: memory traffic. K15 reads each valid
// slot's weight and indices (12 bytes) and one x row per slot, mostly from
// the 50 MB L2 (after a bandwidth-reducing order such as rcm, a row block's
// columns fall in a few column blocks), and writes each output row once;
// 2 flops per slot and feature. K16 reads two rows per valid slot (D * 4
// bytes each) for 2 * D flops, and writes every slot. Both sit two orders
// of magnitude below the card's ridge point, so what decides their time is
// how many loads are in flight.
//
// K15's design: a walk over rows. The first version gave a CTA a row block
// and a tile of at most 16 features, walked the block's chunks in series
// with two barriers each, staged x's column block in shared memory and
// read each slot's indices once per feature tile: 30 CTAs on 132 SMs for
// Cora at B = 1024, 4-23x slower than a CSR walk on the same graph. Here
// the host turns the plan into a CSR over its valid slots
// (kernels/blocked.py, blocked_layout): each padded node row lists its
// slots in plan order (chunk by chunk, then by slot), each with its global
// column and its slot index for w. A group of G lanes owns a row (G the
// power of two covering the row's D / V vectors, at most 32: one lane for
// the image paths' D = 1, four for D = 3, a full warp at D = 80 and D =
// 128), reads x rows as V-float vectors (16-byte loads where D % 4 == 0
// and x lies on a 16-byte boundary, else 8 or 4), stages G slots' (column,
// weight) at a time with one load a lane and broadcasts them by shuffle
// within the group, sums all of the row's features in registers in slot
// order, and writes the row once. Nothing is shared between rows, so there
// is no barrier, no shared memory and no limit on block_n; the blocking
// still buys locality in L2. Staging x's column block in shared memory
// (a CTA's rows of one row block walking its buckets) was measured for
// D <= 16: no faster at the image paths' D = 1 and 3, several times
// slower at D = 16, where a block_n x D tile serves 16 rows; so x is read
// through the caches. No atomics: every output element is summed by one
// lane in a fixed order, so two launches are bit-identical.
//
// K16's design: K2's SDDMM (csrc/edge_dot.cu) over K15's slot CSR. The
// first version gave every slot, padding included, a group of lanes
// strided over the features with 4-byte loads, found both rows of each
// slot through its chunk's block ids, and computed each padding slot's
// dot one by one: 1.4-4x K2's time on the same graphs. Here a group of L
// lanes (kernels/lanes.py's edge_dot entry: one at D = 1 and 3, four at
// D = 80, eight at D = 128 and 162) takes a valid slot, the valid slots in
// the order of K15's slot CSR, each with its global row and column and its
// plan slot (blocked_layout's row, col, slot): neighbouring groups take
// one row's slots, so a[row] comes from L1, as K2's edges do, and b[col]
// from the L2. The lanes read both rows as vectors of V floats (16-byte
// loads where D and the addresses allow, csrc/row_vectors.cuh), lane l
// summing the vectors l, l + L, ... in order, and the group adds its
// partial sums by an xor butterfly of log2(L) levels; lane 0 writes
// out[slot]. After the slot groups, one warp a chunk computes the chunk's
// padding value a[rb B] . b[cb B] once and writes it to the chunk's
// padding slots, the suffix after its chunk_valid valid ones (ops/plan.py
// puts a bucket's edges before its padding), so the grid holds no padding
// slot (30% of the MNIST batch's, 52% of the arxiv stand-in's after rcm).
// Measured on the H100 and left out (probes/lanes.py, PERF.md): the valid
// slots in the plan's own order (a row's slots fall in the chunks of its
// several column blocks, so fewer neighbours share a[row]: 0.0296 against
// 0.0225 ms on the arxiv stand-in after rcm), every slot in plan order
// with the padding groups idle, and a group a row holding a[row] in
// registers (a row's slots then wait on each other: 0.0120 against 0.0029
// ms on Cora after rcm). No atomics: a slot's sum order is fixed by (L,
// V), so two launches are bit-identical.

#include <cuda_runtime.h>

#include "row_vectors.cuh"

namespace {

using gnpde_rows::load_plain;
using gnpde_rows::widen;

constexpr int kThreads = 256;
constexpr int kVecsPerLane = 4;     // a pass covers G * V * 4 features

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void axpy(float a, float x, float& y) {
  y = fmaf(a, x, y);
}
__device__ __forceinline__ void axpy(float a, const float2& x, float2& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
}
__device__ __forceinline__ void axpy(float a, const float4& x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.0f, 0.0f);
}
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One group of G lanes per row of the slot CSR; x and out are [n_rows,
// dim] read and written as dim / V vectors of V floats.
template <int G, int V>
__global__ void __launch_bounds__(kThreads) blocked_spmm_kernel(
    const int* __restrict__ rowptr,      // [n_rows + 1] over the slots
    const int* __restrict__ slot,        // [n_valid] plan slot (for w)
    const int* __restrict__ col,         // [n_valid] global column
    const float* __restrict__ w,         // [capacity]
    const float* __restrict__ x, float* __restrict__ out, int n_rows,
    int dim) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x % G;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / G;
  if (row >= n_rows) return;            // whole groups leave together
  // the group's lanes: a group never straddles a warp
  const unsigned group =
      G == 32 ? 0xffffffffu
              : ((1u << (G % 32)) - 1u) << (threadIdx.x % 32 / G * G);
  const int start = rowptr[row], end = rowptr[row + 1];
  const int vecs = dim / V;
  const T* xv = reinterpret_cast<const T*>(x);
  T* orow = reinterpret_cast<T*>(out) + static_cast<size_t>(row) * vecs;
  for (int v0 = 0; v0 < vecs; v0 += G * kVecsPerLane) {
    T acc[kVecsPerLane];
#pragma unroll
    for (int k = 0; k < kVecsPerLane; ++k) acc[k] = zero<T>();
    for (int e0 = start; e0 < end; e0 += G) {
      int c = 0;
      float we = 0.0f;
      if (e0 + lane < end) {
        c = col[e0 + lane];
        we = w[slot[e0 + lane]];
      }
      const int n = min(G, end - e0);
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(group, c, j, G);
        const float wj = __shfl_sync(group, we, j, G);
        const T* xr = xv + static_cast<size_t>(cj) * vecs;
#pragma unroll
        for (int k = 0; k < kVecsPerLane; ++k) {
          const int v = v0 + lane + G * k;
          if (v < vecs) axpy(wj, xr[v], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kVecsPerLane; ++k) {
      const int v = v0 + lane + G * k;
      if (v < vecs) orow[v] = acc[k];
    }
  }
}

template <int G, int V>
cudaError_t launch_spmm(const int* rowptr, const int* slot, const int* col,
                        const float* w, const float* x, float* out,
                        int n_rows, int dim, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_rows) * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  blocked_spmm_kernel<G, V><<<blocks, kThreads, 0, stream>>>(
      rowptr, slot, col, w, x, out, n_rows, dim);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_spmm_v(int lanes, const int* rowptr, const int* slot,
                          const int* col, const float* w, const float* x,
                          float* out, int n_rows, int dim,
                          cudaStream_t stream) {
  switch (lanes) {
#define GNPDE_SPMM_G(G)                                                      \
  case G:                                                                    \
    return launch_spmm<G, V>(rowptr, slot, col, w, x, out, n_rows, dim,     \
                             stream);
    GNPDE_SPMM_G(1)
    GNPDE_SPMM_G(2)
    GNPDE_SPMM_G(4)
    GNPDE_SPMM_G(8)
    GNPDE_SPMM_G(16)
    GNPDE_SPMM_G(32)
#undef GNPDE_SPMM_G
    default:
      return cudaErrorInvalidValue;
  }
}

// K16's dot of one slot's rows on a group of L lanes: lane l sums the
// vectors l, l + L, ... of a[row] . b[col] in order with fused multiply-adds
// (K2's order, csrc/edge_dot.cu); the caller's butterfly adds the lanes.
template <int L, int V>
__device__ __forceinline__ float lane_dot(const float* __restrict__ ar,
                                          const float* __restrict__ br,
                                          int vecs, int lane) {
  float acc = 0.0f;
#pragma unroll 4
  for (int v = lane; v < vecs; v += L) {
    float av[V], bv[V];
    widen(load_plain<float, V>(ar, v), av);
    widen(load_plain<float, V>(br, v), bv);
#pragma unroll
    for (int i = 0; i < V; ++i) acc = fmaf(av[i], bv[i], acc);
  }
  return acc;
}

template <int L>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The padding warps, after the slot groups: warp c computes chunk c's
// padding value a[rb B] . b[cb B] once (its 32 lanes in K2's order) and
// writes it to the chunk's padding slots, the suffix after its
// chunk_valid[c] valid ones. Warps of chunks without padding leave.
__device__ __forceinline__ void pad_chunk(
    long long c, const int* __restrict__ chunk_rows,
    const int* __restrict__ chunk_cols, const int* __restrict__ chunk_valid,
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int n_chunks, int chunk, int block_n, int dim) {
  if (c >= n_chunks) return;
  const int nv = chunk_valid[c];
  if (nv >= chunk) return;                  // the warp leaves together
  const int lane = threadIdx.x % 32;
  const float* ar = a + static_cast<size_t>(chunk_rows[c]) * block_n * dim;
  const float* br = b + static_cast<size_t>(chunk_cols[c]) * block_n * dim;
  const float pad = group_sum<32>(lane_dot<32, 1>(ar, br, dim, lane));
  float* o = out + c * chunk;
  for (int s = nv + lane; s < chunk; s += 32) o[s] = pad;
}

// K16: a group of L lanes a valid slot, in the order of K15's slot CSR,
// then the padding warps.
template <int L, int V>
__global__ void __launch_bounds__(kThreads) blocked_sddmm_kernel(
    const int* __restrict__ row, const int* __restrict__ col,
    const int* __restrict__ slot, const int* __restrict__ chunk_rows,
    const int* __restrict__ chunk_cols, const int* __restrict__ chunk_valid,
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int n_valid, int n_chunks, int chunk,
    int block_n, int dim) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long slot_threads =
      (static_cast<long long>(n_valid) * L + 31) / 32 * 32;
  if (t >= slot_threads) {                  // whole warps
    pad_chunk((t - slot_threads) / 32, chunk_rows, chunk_cols, chunk_valid,
              a, b, out, n_chunks, chunk, block_n, dim);
    return;
  }
  const int lane = threadIdx.x % L;
  const long long i = t / L;
  // a group never straddles a warp, so the butterfly sees only the lanes
  // of one slot; groups past the valid slots still shuffle
  const bool live = i < n_valid;
  float acc = 0.0f;
  int s = 0;
  if (live) {
    const int r = row[i], c = col[i];
    s = slot[i];
    acc = lane_dot<L, V>(a + static_cast<size_t>(r) * dim,
                         b + static_cast<size_t>(c) * dim, dim / V, lane);
  }
  acc = group_sum<L>(acc);
  if (live && lane == 0) out[s] = acc;
}

template <int L, int V>
cudaError_t launch_sddmm(const int* row, const int* col, const int* slot,
                         const int* chunk_rows, const int* chunk_cols,
                         const int* chunk_valid, const float* a,
                         const float* b, float* out, int n_valid,
                         int n_chunks, int chunk, int block_n, int dim,
                         cudaStream_t stream) {
  // the slot groups' warps, then a warp a chunk
  const long long threads =
      (static_cast<long long>(n_valid) * L + 31) / 32 * 32
      + 32LL * n_chunks;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  blocked_sddmm_kernel<L, V><<<blocks, kThreads, 0, stream>>>(
      row, col, slot, chunk_rows, chunk_cols, chunk_valid, a, b, out,
      n_valid, n_chunks, chunk, block_n, dim);
  return cudaGetLastError();
}

}  // namespace

// lanes: G, vec: V, chosen by the wrapper (G in 1, 2, 4, ..., 32; V in
// 1, 2, 4 dividing dim, with x and out on V * 4-byte boundaries)
extern "C" int gnpde_blocked_spmm(const void* rowptr, const void* slot,
                                  const void* col, const void* w,
                                  const void* x, void* out, int n_rows,
                                  int dim, int lanes, int vec, void* stream) {
  if (n_rows <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  if (dim % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* sl = static_cast<const int*>(slot);
  const auto* cl = static_cast<const int*>(col);
  const auto* wf = static_cast<const float*>(w);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vec) {
    case 1: err = launch_spmm_v<1>(lanes, rp, sl, cl, wf, xf, of, n_rows, dim,
                                   st); break;
    case 2: err = launch_spmm_v<2>(lanes, rp, sl, cl, wf, xf, of, n_rows, dim,
                                   st); break;
    case 4: err = launch_spmm_v<4>(lanes, rp, sl, cl, wf, xf, of, n_rows, dim,
                                   st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// row, col, slot: each valid slot's global row and column and its plan
// slot, in the order of K15's slot CSR (kernels/blocked.py,
// blocked_layout); chunk_valid: each chunk's valid slots, a prefix of the
// chunk; lanes: L, vec: V, chosen by the wrapper (kernels/lanes.py's
// edge_dot entry: L in 1, 2, 4, ..., 32; V in 1, 2, 4 dividing dim, with a
// and b on V * 4-byte boundaries)
extern "C" int gnpde_blocked_sddmm(
    const void* row, const void* col, const void* slot,
    const void* chunk_rows, const void* chunk_cols, const void* chunk_valid,
    const void* a, const void* b, void* out, int n_valid, int n_chunks,
    int chunk, int block_n, int dim, int lanes, int vec, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  if (vec <= 0 || dim % vec != 0 || chunk <= 0 || n_valid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rw = static_cast<const int*>(row);
  const auto* cl = static_cast<const int*>(col);
  const auto* sl = static_cast<const int*>(slot);
  const auto* cr = static_cast<const int*>(chunk_rows);
  const auto* cc = static_cast<const int*>(chunk_cols);
  const auto* cv = static_cast<const int*>(chunk_valid);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define GNPDE_SDDMM(L, V)                                                   \
  if (lanes == L && vec == V)                                               \
    return static_cast<int>(launch_sddmm<L, V>(rw, cl, sl, cr, cc, cv, af,  \
                                               bf, of, n_valid, n_chunks,   \
                                               chunk, block_n, dim, st));
#define GNPDE_SDDMM_V(L) \
  GNPDE_SDDMM(L, 1) GNPDE_SDDMM(L, 2) GNPDE_SDDMM(L, 4)
  GNPDE_SDDMM_V(1)
  GNPDE_SDDMM_V(2)
  GNPDE_SDDMM_V(4)
  GNPDE_SDDMM_V(8)
  GNPDE_SDDMM_V(16)
  GNPDE_SDDMM_V(32)
#undef GNPDE_SDDMM_V
#undef GNPDE_SDDMM
  return static_cast<int>(cudaErrorInvalidValue);
}
