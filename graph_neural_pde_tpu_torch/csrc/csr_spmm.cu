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
//
// The table x may be bfloat16 (the JAX package's rhs_payload_dtype, the
// bf16 x[col] payload of ops/spmm.py's stripe engine): each gathered row
// is then half the bytes, read in __nv_bfloat162 pairs, and converted to
// float32 before the product; weights, sums and output stay float32. One
// template serves both tables, and each output element is still summed by
// one lane in edge order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kAccPerLane = 4;                   // 4 * 32 = 128 features/pass
constexpr int kWarpsPerBlock = 8;

// The features a lane owns in a pass of 128 starting at d0, two at a time
// (accumulators k and k + 1), and their values in row xr (0 past dim).
// float32: d0 + lane + 32 k, one 4-byte word a lane per 32 features.
// bfloat16: the pair d0 + 2 (lane + 32 k / 2) and the next feature, read
// as one __nv_bfloat162 when the row width is even (rows start on 4-byte
// boundaries then), so a warp's 32 loads still span 64 consecutive
// features in one 128-byte transaction.
__device__ __forceinline__ int feature(const float*, int d0, int lane,
                                       int k) {
  return d0 + lane + kWarp * k;
}

__device__ __forceinline__ int feature(const __nv_bfloat16*, int d0,
                                       int lane, int k) {
  return d0 + 2 * (lane + kWarp * (k / 2)) + (k % 2);
}

__device__ __forceinline__ float2 load_pair(const float* xr, int d0,
                                            int lane, int k, int dim) {
  const int da = feature(xr, d0, lane, k), db = feature(xr, d0, lane, k + 1);
  return make_float2(da < dim ? xr[da] : 0.0f, db < dim ? xr[db] : 0.0f);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* xr, int d0,
                                            int lane, int k, int dim) {
  const int d = feature(xr, d0, lane, k);
  if ((dim % 2) == 0 && d + 1 < dim)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + d));
  return make_float2(d < dim ? __bfloat162float(xr[d]) : 0.0f,
                     d + 1 < dim ? __bfloat162float(xr[d + 1]) : 0.0f);
}

template <typename T>
__global__ void csr_spmm_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ col,
                                const float* __restrict__ w,
                                const T* __restrict__ x,
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
        const T* xr = x + static_cast<size_t>(cj) * dim;
#pragma unroll
        for (int k = 0; k < kAccPerLane; k += 2) {
          const float2 v = load_pair(xr, d0, lane, k, dim);
          acc[k] += wj * v.x;
          acc[k + 1] += wj * v.y;
        }
      }
    }
    float* orow = out + static_cast<size_t>(row) * dim;
#pragma unroll
    for (int k = 0; k < kAccPerLane; ++k) {
      const int d = feature(x, d0, lane, k);
      if (d < dim) orow[d] = acc[k];
    }
  }
}

template <typename T>
void launch(const void* rowptr, const void* col, const void* w,
            const void* x, void* out, int n_rows, int dim,
            cudaStream_t stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_spmm_kernel<T><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const float*>(w), static_cast<const T*>(x),
      static_cast<float*>(out), n_rows, dim);
}

}  // namespace

// dtype: the table x, 0 for float32, 1 for bfloat16 (w and out are float32)
extern "C" int gnpde_csr_spmm(const void* rowptr, const void* col,
                              const void* w, const void* x, void* out,
                              int n_rows, int dim, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0 && dim > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(rowptr, col, w, x, out, n_rows, dim, s);
    else
      launch<__nv_bfloat16>(rowptr, col, w, x, out, n_rows, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}
