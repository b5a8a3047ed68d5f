// K1 csr_spmm: out[n] = sum_{e in [rowptr[n], rowptr[n+1])} w[e] * x[col[e]]
//
// Replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _scatter_w_kernel / _stripe_scatter_w_call (the weighted stripe scatter
// of the laplacian RHS, fed there by a separate XLA x[col] gather). On the
// TPU the weight rides inside a one-hot MXU matmul over row stripes; that
// form exists because a TPU has no fast indexed access. Hopper does, so
// this is a plain CSR segment reduction with the x[col] gather fused in:
// the [E, D] gathered payload never exists in device memory.
//
// What bounds it on the H100: memory traffic, not arithmetic. Each edge
// costs 2 flops per feature and reads D elements of x[col[e]] (a random
// row, mostly served by the 50 MB L2 at the sizes the port runs) plus 8
// bytes of index and weight; each row writes D * 4 bytes once. The
// arithmetic intensity is ~0.5 flop/byte, two orders of magnitude below
// the card's ridge point, so what decides the time is how many loads are
// in flight and how many lanes do useful work.
//
// Design: a group of G lanes owns an output row (G a power of two from 1
// to 32, chosen with the vector width V by kernels/lanes.py from the row
// width, the table's address and its dtype; a group never straddles a
// warp). The first version gave every row a whole warp with lanes over the
// features, 4-byte loads and one edge's row in flight at a time: at the
// image paths' D = 1 one lane of 32 worked, at K11's dx width of 10 ten
// did, and rows wider than 128 features walked every edge once per 128.
// Here the group reads x rows as vectors of V elements (16-byte loads
// where D and the table's address allow, else 8, 4 or 2 bytes), each lane
// summing K of them in registers (K = D / V / G, at most 4: one pass over
// the row's edges at every width the port runs). It stages the row's
// (col, w) pairs with one load a lane (several a lane when G is below the
// batch) and broadcasts them by shuffle within the group; then, U edges at
// a time, it loads their x rows raw (U * K vectors in at most 16
// registers, U at most 4) and only then widens them and adds their
// products in edge order, so that up to U rows a lane are in flight where
// the first version waited on each. It writes the row once. Narrow rows
// (at most 16 bytes: D = 1, 3) take one lane, whose batch is U edges of
// its own row. This is K15's row walk (csrc/blocked.cu) over the graph's
// own CSR, with the edge batch added.
//
// There are no atomics: every output element is summed by one lane, in
// edge order, with one fused multiply-add an edge, whatever G and V are,
// so the result is bit-for-bit reproducible from run to run (the solver's
// replay of accepted steps relies on it) and equal to the first version's.
// The same kernel serves the forward matvec, the backward dx = A^T ct
// (on a symmetric edge multiset a forward matvec with the weights permuted
// to the reverse edges, w[rev]; else a walk over the CSC view) and the
// table mode, whose x is any table of rows that col indexes.
//
// The table x may be bfloat16 (the JAX package's rhs_payload_dtype, the
// bf16 x[col] payload of ops/spmm.py's stripe engine): a vector is then 8,
// 4, 2 or 1 bfloat16s, widened to float32 before the product; weights,
// sums and output stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_vectors.cuh"

namespace {

using gnpde_rows::kRawRegs;
using gnpde_rows::load;
using gnpde_rows::Raw;
using gnpde_rows::store;
using gnpde_rows::widen;

// The edges whose x rows a lane loads before it adds their products, at
// most, and the registers those loads may take; probes/lanes.py builds
// variants of this source with other values to measure them.
#ifndef GNPDE_CSR_BATCH
#define GNPDE_CSR_BATCH 4
#endif
#ifndef GNPDE_CSR_BATCH_REGS
#define GNPDE_CSR_BATCH_REGS 16
#endif

constexpr int kThreads = 256;
constexpr int kMaxVecsPerLane = 4;  // a pass covers G * V * 4 features
constexpr int kBatch = GNPDE_CSR_BATCH;
constexpr int kBatchRegs = GNPDE_CSR_BATCH_REGS;

// One group of G lanes per row; each lane sums K vectors of V features a
// pass (vectors v0 + lane + G k). A round stages P = G * R (col, w) pairs,
// R a lane; the group then loads the x rows of U edges (vectors raw, U
// chosen so that U * K vectors take at most kBatchRegs registers, at most
// kBatch edges) before it adds their products, in edge order.
template <typename T, int G, int V, int K>
__global__ void __launch_bounds__(kThreads) csr_spmm_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const float* __restrict__ w, const T* __restrict__ x,
    float* __restrict__ out, int n_rows, int dim) {
  using RawT = typename Raw<T, V>::type;
  constexpr int kU = kBatchRegs / (K * kRawRegs<T, V>);
  constexpr int U = kU < 1 ? 1 : (kU > kBatch ? kBatch : kU);
  constexpr int R = G >= U ? 1 : U / G;
  constexpr int P = G * R;
  const int lane = threadIdx.x % G;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / G;
  if (row >= n_rows) return;            // whole groups leave together
  const unsigned group =
      G == 32 ? 0xffffffffu
              : ((1u << (G % 32)) - 1u) << (threadIdx.x % 32 / G * G);
  const int start = rowptr[row], end = rowptr[row + 1];
  const int vecs = dim / V;
  float* orow = out + static_cast<size_t>(row) * dim;
  for (int v0 = 0; v0 < vecs; v0 += G * K) {
    float acc[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
    for (int e0 = start; e0 < end; e0 += P) {
      int c[R];
      float we[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = e0 + r * G + lane;
        c[r] = e < end ? col[e] : 0;
        we[r] = e < end ? w[e] : 0.0f;
      }
      const int n = min(P, end - e0);
#pragma unroll
      for (int j = 0; j < P; j += U) {
        if (j >= n) break;
        int cu[U];
        float wu[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = j + u;
          cu[u] = G == 1 ? c[p] : __shfl_sync(group, c[p / G], p % G, G);
          wu[u] = G == 1 ? we[p] : __shfl_sync(group, we[p / G], p % G, G);
        }
        RawT xr[U][K];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T* xrow = x + static_cast<size_t>(cu[u]) * dim;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = v0 + lane + G * k;
            if (j + u < n && v < vecs) xr[u][k] = load<T, V>(xrow, v);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = v0 + lane + G * k;
            if (j + u < n && v < vecs) {
              float xv[V];
              widen(xr[u][k], xv);
#pragma unroll
              for (int i = 0; i < V; ++i)
                acc[k][i] = fmaf(wu[u], xv[i], acc[k][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = v0 + lane + G * k;
      if (v < vecs) store<V>(orow, v, acc[k]);
    }
  }
}

template <typename T, int G, int V, int K>
cudaError_t launch(const void* rowptr, const void* col, const void* w,
                   const void* x, void* out, int n_rows, int dim,
                   cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_rows) * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  csr_spmm_kernel<T, G, V, K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const float*>(w), static_cast<const T*>(x),
      static_cast<float*>(out), n_rows, dim);
  return cudaGetLastError();
}

// K: the vectors a lane sums a pass, the row's D / V vectors over the
// group's G lanes, at most 4 (more passes above)
template <typename T, int G, int V>
cudaError_t launch_k(const void* rowptr, const void* col, const void* w,
                     const void* x, void* out, int n_rows, int dim,
                     cudaStream_t stream) {
  switch (min((dim / V + G - 1) / G, kMaxVecsPerLane)) {
    case 1:
      return launch<T, G, V, 1>(rowptr, col, w, x, out, n_rows, dim, stream);
    case 2:
      return launch<T, G, V, 2>(rowptr, col, w, x, out, n_rows, dim, stream);
    case 3:
      return launch<T, G, V, 3>(rowptr, col, w, x, out, n_rows, dim, stream);
    default:
      return launch<T, G, V, kMaxVecsPerLane>(rowptr, col, w, x, out, n_rows,
                                              dim, stream);
  }
}

template <typename T, int V>
cudaError_t launch_v(int lanes, const void* rowptr, const void* col,
                     const void* w, const void* x, void* out, int n_rows,
                     int dim, cudaStream_t stream) {
  switch (lanes) {
#define GNPDE_CSR_G(G)                                                      \
  case G:                                                                   \
    return launch_k<T, G, V>(rowptr, col, w, x, out, n_rows, dim, stream);
    GNPDE_CSR_G(1)
    GNPDE_CSR_G(2)
    GNPDE_CSR_G(4)
    GNPDE_CSR_G(8)
    GNPDE_CSR_G(16)
    GNPDE_CSR_G(32)
#undef GNPDE_CSR_G
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// lanes: G, vec: V, chosen by the wrapper (kernels/lanes.py: G in 1, 2, 4,
// ..., 32; V dividing dim, 1, 2 or 4 floats or 1, 2, 4 or 8 bfloat16s,
// with x on a V-element boundary); dtype: the table x, 0 for float32, 1
// for bfloat16 (w and out are float32)
extern "C" int gnpde_csr_spmm(const void* rowptr, const void* col,
                              const void* w, const void* x, void* out,
                              int n_rows, int dim, int lanes, int vec,
                              int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || vec <= 0 || dim % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 1: err = launch_v<float, 1>(lanes, rowptr, col, w, x, out, n_rows,
                                       dim, s); break;
      case 2: err = launch_v<float, 2>(lanes, rowptr, col, w, x, out, n_rows,
                                       dim, s); break;
      case 4: err = launch_v<float, 4>(lanes, rowptr, col, w, x, out, n_rows,
                                       dim, s); break;
      default: break;
    }
  } else {
    switch (vec) {
      case 1: err = launch_v<__nv_bfloat16, 1>(lanes, rowptr, col, w, x, out,
                                               n_rows, dim, s); break;
      case 2: err = launch_v<__nv_bfloat16, 2>(lanes, rowptr, col, w, x, out,
                                               n_rows, dim, s); break;
      case 4: err = launch_v<__nv_bfloat16, 4>(lanes, rowptr, col, w, x, out,
                                               n_rows, dim, s); break;
      case 8: err = launch_v<__nv_bfloat16, 8>(lanes, rowptr, col, w, x, out,
                                               n_rows, dim, s); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}
