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

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void edge_dot_kernel(const int* __restrict__ row,
                                const int* __restrict__ col,
                                const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ out,
                                int n_edges, int dim) {
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (e >= n_edges) return;                      // whole warp leaves together
  const float* ar = a + static_cast<size_t>(row[e]) * dim;
  const float* br = b + static_cast<size_t>(col[e]) * dim;
  float acc = 0.0f;
  for (int d = lane; d < dim; d += kWarp) acc += ar[d] * br[d];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[e] = acc;
}

}  // namespace

extern "C" int gnpde_edge_dot(const void* row, const void* col,
                              const void* a, const void* b, void* out,
                              int n_edges, int dim, void* stream) {
  if (n_edges > 0) {
    const int blocks = (n_edges + kWarpsPerBlock - 1) / kWarpsPerBlock;
    edge_dot_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row), static_cast<const int*>(col),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n_edges, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
