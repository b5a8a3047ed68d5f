// K2 edge_dot (SDDMM): out[e] = sum_d a[row[e], d] * b[col[e], d] for the
// valid edges e < n_valid, out[e] = 0 for the padding slots after them.
//
// Replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _gather_kernel / _stripe_gather_call together with the elementwise dot
// that graph_neural_pde_tpu/ops/spmm.py:129-133 applies to its output: on
// the TPU the row-side gather ct[row] is a one-hot MXU matmul that writes
// an [E, D] tensor, which XLA then multiplies by a second [E, D] gather
// x[col] and reduces. Here both gathers and the reduction are one pass,
// so neither [E, D] tensor ever exists. It computes dw, the weight
// gradient of the laplacian matvec (dw[e] = ct[row[e]] . x[col[e]]).
//
// What bounds it on the H100: memory traffic. Each edge reads two rows of
// D elements and writes 4 bytes, for 2 * D flops. Edges are row-sorted,
// so neighbouring groups read the same a[row] and that side is served by
// L1/L2; the b[col] side is a random row read.
//
// Design: a group of L lanes owns an edge (L a power of two from 1 to 32,
// chosen with the vector width V by kernels/lanes.py from the row width,
// the tables' addresses and b's dtype), so a warp covers 32 / L edges.
// The first version gave every edge a whole warp with 4-byte loads and a
// 5-level butterfly at any width: at the image paths' D = 1, 31 of 32
// lanes idled and each edge still paid the five shuffles. Here the lanes
// read a[row] and b[col] as vectors of V elements (16-byte loads of a
// where D and the addresses allow), lane l taking the vectors l, l + L,
// ..., each lane sums its products in that order with fused multiply-adds,
// and the group reduces its partial sums with a fixed xor-shuffle
// butterfly of log2(L) levels (none at L = 1, where a lane owns an edge).
// Groups past the valid edges write the padding slots' zeros, so the
// caller allocates the output without zeroing it. No atomics: the sum
// order of an edge is fixed by (L, V), so two launches are bit-identical.
//
// b may be a bfloat16 table (the bf16 x[col] payload of the JAX package's
// ops/spmm.py, whose dw dots the float32 ct[row] with the bf16 x[col]):
// its vectors are then half the bytes and are widened to float32 before
// the products; a, the sums and out stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_vectors.cuh"

namespace {

using gnpde_rows::load_plain;
using gnpde_rows::widen;

constexpr int kThreads = 256;

template <typename T, int L, int V>
__global__ void __launch_bounds__(kThreads) edge_dot_kernel(
    const int* __restrict__ row, const int* __restrict__ col,
    const float* __restrict__ a, const T* __restrict__ b,
    float* __restrict__ out, int n_valid, int n_slots, int dim) {
  const int lane = threadIdx.x % L;
  const long long e =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  // a group never straddles a warp, so the butterfly below sees only the
  // lanes of one edge; groups past the end still shuffle
  float acc = 0.0f;
  if (e < n_valid) {
    const float* ar = a + static_cast<size_t>(row[e]) * dim;
    const T* br = b + static_cast<size_t>(col[e]) * dim;
    const int vecs = dim / V;
#pragma unroll 4
    for (int v = lane; v < vecs; v += L) {
      float av[V], bv[V];
      widen(load_plain<float, V>(ar, v), av);
      widen(load_plain<T, V>(br, v), bv);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = fmaf(av[i], bv[i], acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (e < n_slots && lane == 0) out[e] = acc;   // 0 on the padding slots
}

template <typename T, int L, int V>
cudaError_t launch(const void* row, const void* col, const void* a,
                   const void* b, void* out, int n_valid, int n_slots,
                   int dim, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_slots) * L;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  edge_dot_kernel<T, L, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(row), static_cast<const int*>(col),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), n_valid, n_slots, dim);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_v(int lanes, const void* row, const void* col,
                     const void* a, const void* b, void* out, int n_valid,
                     int n_slots, int dim, cudaStream_t stream) {
  switch (lanes) {
#define GNPDE_DOT_L(L)                                                      \
  case L:                                                                   \
    return launch<T, L, V>(row, col, a, b, out, n_valid, n_slots, dim,     \
                           stream);
    GNPDE_DOT_L(1)
    GNPDE_DOT_L(2)
    GNPDE_DOT_L(4)
    GNPDE_DOT_L(8)
    GNPDE_DOT_L(16)
    GNPDE_DOT_L(32)
#undef GNPDE_DOT_L
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int lanes, int vec, const void* row, const void* col,
                     const void* a, const void* b, void* out, int n_valid,
                     int n_slots, int dim, cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_v<T, 1>(lanes, row, col, a, b, out, n_valid,
                                  n_slots, dim, stream);
    case 2: return launch_v<T, 2>(lanes, row, col, a, b, out, n_valid,
                                  n_slots, dim, stream);
    case 4: return launch_v<T, 4>(lanes, row, col, a, b, out, n_valid,
                                  n_slots, dim, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// n_valid: the valid (row-sorted prefix) edges; n_slots: every slot of
// out, the padding ones written 0. lanes: L, vec: V, chosen by the wrapper
// (kernels/lanes.py: L in 1, 2, 4, ..., 32; V in 1, 2, 4 dividing dim,
// with a and b on V-element boundaries); dtype: the table b, 0 for
// float32, 1 for bfloat16 (a and out are float32)
extern "C" int gnpde_edge_dot(const void* row, const void* col,
                              const void* a, const void* b, void* out,
                              int n_valid, int n_slots, int dim, int lanes,
                              int vec, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || vec <= 0 || dim % vec != 0
      || n_valid < 0 || n_valid > n_slots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch_t<float>(lanes, vec, row, col, a, b, out, n_valid,
                                   n_slots, dim, s)
                 : launch_t<__nv_bfloat16>(lanes, vec, row, col, a, b, out,
                                           n_valid, n_slots, dim, s));
}
