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
//
// The output may be bfloat16 (the VJP of the bf16 payload's stripe scatter,
// make_traced_scatter_add(vals_dtype=bf16)): the float32 table entry is
// rounded to nearest even as it is stored, each edge's row half the bytes.
// On the TPU the same value comes out of a one-hot product of the table's
// rows rounded to bfloat16, which is exact, then cast to bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 4;                      // 4 * 32 = 128 features/pass
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void store(float* o, float v) { *o = v; }

__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

template <typename TO>
__global__ void row_gather_kernel(const int* __restrict__ rowptr,
                                  const float* __restrict__ table,
                                  TO* __restrict__ out,
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
      TO* orow = out + static_cast<size_t>(e) * dim;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int d = d0 + lane + kWarp * k;
        if (d < dim) store(orow + d, v[k]);
      }
    }
  }
}

template <typename TO>
void launch(const void* rowptr, const void* table, void* out, int n_rows,
            int dim, cudaStream_t stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_gather_kernel<TO><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const float*>(table),
      static_cast<TO*>(out), n_rows, dim);
}

}  // namespace

// dtype: the output, 0 for float32, 1 for bfloat16 (the table is float32)
extern "C" int gnpde_row_gather(const void* rowptr, const void* table,
                                void* out, int n_rows, int dim, int dtype,
                                void* stream) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0 && dim > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(rowptr, table, out, n_rows, dim, s);
    else
      launch<__nv_bfloat16>(rowptr, table, out, n_rows, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}
