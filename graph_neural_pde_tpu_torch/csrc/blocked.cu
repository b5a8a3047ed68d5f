// K15 blocked_spmm and K16 blocked_sddmm: SpMM and SDDMM over a blocked
// edge plan (graph_neural_pde_tpu_torch/ops/plan.py): nodes tiled into
// blocks of B = block_n, edge slots bucketed by (row block, column block)
// in chunks of `chunk` slots, the chunks of one row block contiguous.
//
// K15: out[rb*B + row_local[s]] += w[s] * x[cb*B + col_local[s]] over the
//      plan's valid slots s (rb, cb: the row and column block of s's
//      chunk); out is [N_pad, D], N_pad a multiple of B.
// K16: out[s] = a[rb*B + row_local[s]] . b[cb*B + col_local[s]] for every
//      slot, padding included (there row_local = col_local = 0).
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
// 2 flops per slot and feature. K16 reads two rows per slot (D * 4 bytes
// each) for 2 * D flops. Both sit two orders of magnitude below the card's
// ridge point, so what decides their time is how many loads are in flight.
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
// K16's design: a group of L lanes per slot (L the largest power of two
// <= D, at most 32), lanes strided over the features, and the group
// reduces its partial sums with a fixed xor-shuffle butterfly. D = 1 and
// D = 3 give one and two lanes per slot, so a warp covers 32 or 16 slots
// instead of idling 31 lanes.

#include <cuda_runtime.h>

namespace {

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

template <int L>
__global__ void blocked_sddmm_kernel(
    const int* __restrict__ chunk_rows, const int* __restrict__ chunk_cols,
    const int* __restrict__ row_local, const int* __restrict__ col_local,
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int capacity, int chunk, int block_n,
    int dim) {
  const int lane = threadIdx.x % L;
  const long long s =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  // a group of L lanes never straddles a warp, so the shuffles below see
  // only lanes of the same slot; groups past the end still shuffle
  const bool live = s < capacity;
  float acc = 0.0f;
  if (live) {
    const int c = static_cast<int>(s / chunk);
    const float* ar = a + (static_cast<size_t>(chunk_rows[c]) * block_n
                           + row_local[s]) * dim;
    const float* br = b + (static_cast<size_t>(chunk_cols[c]) * block_n
                           + col_local[s]) * dim;
    for (int d = lane; d < dim; d += L) acc += ar[d] * br[d];
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane == 0) out[s] = acc;
}

template <int L>
cudaError_t launch_sddmm(const int* chunk_rows, const int* chunk_cols,
                         const int* row_local, const int* col_local,
                         const float* a, const float* b, float* out,
                         int capacity, int chunk, int block_n, int dim,
                         cudaStream_t stream) {
  const long long threads = static_cast<long long>(capacity) * L;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  blocked_sddmm_kernel<L><<<blocks, kThreads, 0, stream>>>(
      chunk_rows, chunk_cols, row_local, col_local, a, b, out, capacity,
      chunk, block_n, dim);
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

// lanes: L, chosen by the wrapper (1, 2, 4, 8, 16 or 32)
extern "C" int gnpde_blocked_sddmm(
    const void* chunk_rows, const void* chunk_cols, const void* row_local,
    const void* col_local, const void* a, const void* b, void* out,
    int capacity, int chunk, int block_n, int dim, int lanes, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  const auto* cr = static_cast<const int*>(chunk_rows);
  const auto* cc = static_cast<const int*>(chunk_cols);
  const auto* rl = static_cast<const int*>(row_local);
  const auto* cl = static_cast<const int*>(col_local);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes) {
    case 1: err = launch_sddmm<1>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 2: err = launch_sddmm<2>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 4: err = launch_sddmm<4>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 8: err = launch_sddmm<8>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 16: err = launch_sddmm<16>(cr, cc, rl, cl, af, bf, of, capacity,
                                    chunk, block_n, dim, st); break;
    case 32: err = launch_sddmm<32>(cr, cc, rl, cl, af, bf, of, capacity,
                                    chunk, block_n, dim, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
