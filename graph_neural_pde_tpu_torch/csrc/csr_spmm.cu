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
// costs 2 flops per feature and reads D * 4 bytes of x[col[e]] (a random
// row, mostly served by the 50 MB L2 at the sizes the slice runs) plus
// 8 bytes of index and weight; each row writes D * 4 bytes once. The
// arithmetic intensity is ~0.5 flop/byte, two orders of magnitude below
// the card's ridge point.
//
// Design: one warp per output row, lanes across the feature dimension,
// so every gathered x row is read by one coalesced 128-byte transaction
// per 32 features. The warp stages 32 (col, w) pairs at a time with one
// load per lane and broadcasts them by shuffle, instead of 32 redundant
// loads per pair. Each lane keeps up to four partial sums in registers
// (128 features per pass; wider rows take more passes). There are no
// atomics: every output element is summed by one lane in edge order, so
// the result is bit-for-bit reproducible from run to run, which the
// solver's replay of accepted steps relies on. The same kernel serves the
// forward matvec and the backward dx = A^T ct, which on a symmetric edge
// multiset is a forward matvec with the weights permuted to the reverse
// edges (w[rev]).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kAccPerLane = 4;                   // 4 * 32 = 128 features/pass
constexpr int kWarpsPerBlock = 8;

__global__ void csr_spmm_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ col,
                                const float* __restrict__ w,
                                const float* __restrict__ x,
                                float* __restrict__ out,
                                int n_rows, int dim) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;                     // whole warp leaves together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int d0 = 0; d0 < dim; d0 += kWarp * kAccPerLane) {
    float acc[kAccPerLane];
#pragma unroll
    for (int k = 0; k < kAccPerLane; ++k) acc[k] = 0.0f;
    for (int e0 = start; e0 < end; e0 += kWarp) {
      const int e = e0 + lane;
      int c = 0;
      float we = 0.0f;
      if (e < end) {
        c = col[e];
        we = w[e];
      }
      const int n = min(kWarp, end - e0);
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, j);
        const float wj = __shfl_sync(0xffffffffu, we, j);
        const float* xr = x + static_cast<size_t>(cj) * dim;
#pragma unroll
        for (int k = 0; k < kAccPerLane; ++k) {
          const int d = d0 + lane + kWarp * k;
          if (d < dim) acc[k] += wj * xr[d];
        }
      }
    }
    float* orow = out + static_cast<size_t>(row) * dim;
#pragma unroll
    for (int k = 0; k < kAccPerLane; ++k) {
      const int d = d0 + lane + kWarp * k;
      if (d < dim) orow[d] = acc[k];
    }
  }
}

}  // namespace

extern "C" int gnpde_csr_spmm(const void* rowptr, const void* col,
                              const void* w, const void* x, void* out,
                              int n_rows, int dim, void* stream) {
  if (n_rows > 0 && dim > 0) {
    const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    csr_spmm_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(col),
        static_cast<const float*>(w), static_cast<const float*>(x),
        static_cast<float*>(out), n_rows, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
