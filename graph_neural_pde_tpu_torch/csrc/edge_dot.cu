// K2 edge_dot (SDDMM): out[e] = sum_d a[row[e], d] * b[col[e], d]
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
// D * 4 bytes and writes 4 bytes, for 2 * D flops. Edges are row-sorted,
// so consecutive warps read the same a[row] and that side is served by
// L1/L2; the b[col] side is a random row read.
//
// Design: one warp per edge, lanes across the feature dimension, so both
// row reads are coalesced 128-byte transactions per 32 features. Each
// lane accumulates its strided partial product in a register and the warp
// reduces with a fixed xor-shuffle butterfly. No atomics: the summation
// order is fixed, so the result is reproducible from run to run. The
// caller passes only the valid (row-sorted prefix) edges; slots beyond
// them are left to the caller, which zeroes them.
//
// b may be a bfloat16 table (the bf16 x[col] payload of the JAX package's
// ops/spmm.py, whose dw dots the float32 ct[row] with the bf16 x[col]):
// its rows are then half the bytes and are converted to float32 before
// the products; a, the sums and out stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

// A lane's partial sum of a[d] b[d] over its features: float32 d = lane +
// 32 j; a bfloat16 b in __nv_bfloat162 pairs (2 (lane + 32 j) and the next
// feature) when the width is even, so 32 lanes read 64 features of b in
// one 128-byte transaction.
__device__ __forceinline__ float lane_dot(const float* ar, const float* br,
                                          int dim, int lane) {
  float acc = 0.0f;
  for (int d = lane; d < dim; d += kWarp) acc += ar[d] * br[d];
  return acc;
}

__device__ __forceinline__ float lane_dot(const float* ar,
                                          const __nv_bfloat16* br, int dim,
                                          int lane) {
  float acc = 0.0f;
  if ((dim % 2) == 0) {
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(br);
    for (int j = lane; j < dim / 2; j += kWarp) {
      const float2 v = __bfloat1622float2(b2[j]);
      acc += ar[2 * j] * v.x;
      acc += ar[2 * j + 1] * v.y;
    }
  } else {
    for (int d = lane; d < dim; d += kWarp)
      acc += ar[d] * __bfloat162float(br[d]);
  }
  return acc;
}

template <typename T>
__global__ void edge_dot_kernel(const int* __restrict__ row,
                                const int* __restrict__ col,
                                const float* __restrict__ a,
                                const T* __restrict__ b,
                                float* __restrict__ out,
                                int n_edges, int dim) {
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (e >= n_edges) return;                      // whole warp leaves together
  const float* ar = a + static_cast<size_t>(row[e]) * dim;
  const T* br = b + static_cast<size_t>(col[e]) * dim;
  float acc = lane_dot(ar, br, dim, lane);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[e] = acc;
}

template <typename T>
void launch(const void* row, const void* col, const void* a, const void* b,
            void* out, int n_edges, int dim, cudaStream_t stream) {
  const int blocks = (n_edges + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_dot_kernel<T><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      static_cast<const int*>(row), static_cast<const int*>(col),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), n_edges, dim);
}

}  // namespace

// dtype: the table b, 0 for float32, 1 for bfloat16 (a and out are float32)
extern "C" int gnpde_edge_dot(const void* row, const void* col,
                              const void* a, const void* b, void* out,
                              int n_edges, int dim, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(row, col, a, b, out, n_edges, dim, s);
    else
      launch<__nv_bfloat16>(row, col, a, b, out, n_edges, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}
