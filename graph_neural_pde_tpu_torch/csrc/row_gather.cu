// K20 row_gather: out[e] = table[row[e]] over the valid prefix
// [0, rowptr[n_rows]) of a row-sorted edge list.
//
// Replaces the TPU kernels graph_neural_pde_tpu/ops/pallas/stripe.py
// make_traced_scatter_add._gather_call (the VJP of the per-shard stripe
// scatter, P6) and the bare row gather of _gather_kernel (P2's body) that
// it runs: on the TPU each chunk of edges is a one-hot matrix multiplied
// into its node block, because a TPU has no fast indexed access. Here the
// CSR row pointer is the plan: the edges of row n are the contiguous range
// [rowptr[n], rowptr[n+1]), so the gather needs no index per edge at all.
//
// What bounds it on the H100: memory traffic. Each row's table entry is
// read once (D * 4 bytes) and written once per edge (E * D * 4 bytes in
// all); there is no arithmetic.
//
// Design: one warp per row, lanes across the feature dimension. The warp
// loads the row's entry once, coalesced, into registers (four floats a
// lane, 128 features a pass; wider rows take more passes) and writes it to
// each of the row's edges with coalesced 128-byte stores. There are no
// atomics and no reads of per-edge data. Slots past the valid prefix are
// zeroed by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 4;                      // 4 * 32 = 128 features/pass
constexpr int kWarpsPerBlock = 8;

__global__ void row_gather_kernel(const int* __restrict__ rowptr,
                                  const float* __restrict__ table,
                                  float* __restrict__ out,
                                  int n_rows, int dim) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;                     // whole warp leaves together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (start == end) return;
  const float* trow = table + static_cast<size_t>(row) * dim;
  for (int d0 = 0; d0 < dim; d0 += kWarp * kPerLane) {
    float v[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int d = d0 + lane + kWarp * k;
      v[k] = d < dim ? trow[d] : 0.0f;
    }
    for (int e = start; e < end; ++e) {
      float* orow = out + static_cast<size_t>(e) * dim;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int d = d0 + lane + kWarp * k;
        if (d < dim) orow[d] = v[k];
      }
    }
  }
}

}  // namespace

extern "C" int gnpde_row_gather(const void* rowptr, const void* table,
                                void* out, int n_rows, int dim,
                                void* stream) {
  if (n_rows > 0 && dim > 0) {
    const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    row_gather_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const float*>(table),
        static_cast<float*>(out), n_rows, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
