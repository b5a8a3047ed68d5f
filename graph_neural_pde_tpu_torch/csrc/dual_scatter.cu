// K10 dual_scatter and K11 dual_gather: the aggregation of the composed
// attention right-hand side (squareplus, reweighted or GAT attention over a
// row-sorted graph) and its gradient.
//
//   K10  num[n, h*D + d] = sum_{e in row n} u[e, h] * x[col[e], d]
//        den[n, h]       = sum_{e in row n} u[e, h]
//   K11  du[e, h] = ct_num[row[e], h, :] . x[col[e], :] + ct_den[row[e], h]
//        dx[c, :] = sum_{e: col[e] = c} sum_h u[e, h] * ct_num[row[e], h, :]
//
// K10 replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _scatter2_kernel / _stripe_scatter2_call, K11 its gradient
// _gather2_kernel / _stripe_gather2_call together with the products XLA
// forms around them. On the TPU the per-edge outer product
// vals = u (x) x[col] is first written out as an [E, H*D] array and then
// summed per row by a one-hot matmul, and the gradient gathers ct_num[row]
// back to [E, H*D] before XLA contracts it; both forms exist because a TPU
// has no fast indexed access. Here the x[col] gather and the outer product
// are fused into the row walk, and the gradient's dot products and sums
// into its own, so no [E, H*D] array ever exists in device memory.
//
// What bounds them on the H100: memory traffic. K10 does 2*H flops per
// gathered float of x[col[e]] and writes H*D floats per row; K11 gathers
// x[col[e]] (D floats) and ct_num[col[e]] (H*D floats) per edge for 4*H*D
// flops. The gathered rows are random and mostly served by the L2 at the
// sizes the models run; the arithmetic intensity stays far below the card's
// ridge point.
//
// Design: one warp per row, lanes across the feature dimension, so every
// gathered row is read in coalesced 128-byte transactions. K10 keeps its
// sums in registers, eight heads by 128 features per pass (wider shapes
// take more passes over the row's edges), and stages 32 column indices at
// a time with one load per lane. K11 holds the row's ct_num[n] (H*D
// floats) in shared memory, reduces each edge's H dot products across the
// warp by a fixed xor-shuffle butterfly, and reaches dx through the
// reverse-edge map of a symmetric edge multiset: the edges whose column is
// n are the reverse edges rev[e'] of row n's own edges e', so dx[n] is a
// walk over row n that reads u[rev[e']] and ct_num[col[e']]. On a directed
// graph the wrapper passes rev = dx = null: K11 writes du only, and dx is
// K1 (csr_spmm.cu) walked over the CSC view in table mode, ct_num read as
// an [N * H, D] table. There are no atomics: every output element is
// summed by one lane in edge order, so two launches agree bit for bit,
// which the solver's replay of accepted steps relies on.
//
// The gathered table x may be bfloat16 (the JAX package's
// rhs_payload_dtype: the composed RHS's x[col] payload, P4/P5 under
// pay_dt). Both kernels are templates on the table's type; each gathered
// element is widened to float32 as it is loaded, and u, the cotangents, the
// sums and every output stay float32. On the TPU the stripe kernels also
// round u and the products u * x[col] to bfloat16; here only the table is
// rounded, as the JAX package's XLA composition rounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScatterWarps = 8;                 // warps per block, K10
constexpr int kGatherWarps = 4;                  // warps per block, K11
constexpr int kHeadsPerPass = 8;
constexpr int kAccPerLane = 4;                   // 4 * 32 = 128 features/pass
constexpr int kMaxAccPerLane = 8;                // K11: dim <= 256

__device__ __forceinline__ float widen(const float* t, size_t i) {
  return t[i];
}

__device__ __forceinline__ float widen(const __nv_bfloat16* t, size_t i) {
  return __bfloat162float(t[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename TX>
__global__ void dual_scatter_kernel(const int* __restrict__ rowptr,
                                    const int* __restrict__ col,
                                    const float* __restrict__ u,
                                    const TX* __restrict__ x,
                                    float* __restrict__ num,
                                    float* __restrict__ den,
                                    int n_rows, int dim, int heads) {
  const int row = blockIdx.x * kScatterWarps + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;                     // whole warp leaves together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  float* nrow = num + static_cast<size_t>(row) * heads * dim;
  float* drow = den + static_cast<size_t>(row) * heads;
  for (int h0 = 0; h0 < heads; h0 += kHeadsPerPass) {
    const int nh = min(kHeadsPerPass, heads - h0);
    for (int d0 = 0; d0 < dim; d0 += kWarp * kAccPerLane) {
      float acc[kHeadsPerPass][kAccPerLane];
      float dsum[kHeadsPerPass];
#pragma unroll
      for (int h = 0; h < kHeadsPerPass; ++h) {
        dsum[h] = 0.0f;
#pragma unroll
        for (int k = 0; k < kAccPerLane; ++k) acc[h][k] = 0.0f;
      }
      for (int e0 = start; e0 < end; e0 += kWarp) {
        const int e = e0 + lane;
        const int c = e < end ? col[e] : 0;
        const int n = min(kWarp, end - e0);
        for (int j = 0; j < n; ++j) {
          const int cj = __shfl_sync(kFull, c, j);
          const float* ue = u + static_cast<size_t>(e0 + j) * heads + h0;
          const TX* xr = x + static_cast<size_t>(cj) * dim;
          float xv[kAccPerLane];
#pragma unroll
          for (int k = 0; k < kAccPerLane; ++k) {
            const int d = d0 + lane + kWarp * k;
            xv[k] = d < dim ? widen(xr, d) : 0.0f;
          }
#pragma unroll
          for (int h = 0; h < kHeadsPerPass; ++h) {
            if (h < nh) {
              const float uh = ue[h];            // one address: a broadcast
              dsum[h] += uh;
#pragma unroll
              for (int k = 0; k < kAccPerLane; ++k) acc[h][k] += uh * xv[k];
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kHeadsPerPass; ++h) {
        if (h < nh) {
#pragma unroll
          for (int k = 0; k < kAccPerLane; ++k) {
            const int d = d0 + lane + kWarp * k;
            if (d < dim) nrow[static_cast<size_t>(h0 + h) * dim + d] = acc[h][k];
          }
          // every lane holds the same sum; the first feature pass writes it
          if (d0 == 0 && lane == h) drow[h0 + h] = dsum[h];
        }
      }
    }
  }
}

template <typename TX>
__global__ void dual_gather_kernel(const int* __restrict__ rowptr,
                                   const int* __restrict__ col,
                                   const int* __restrict__ rev,
                                   const float* __restrict__ u,
                                   const TX* __restrict__ x,
                                   const float* __restrict__ ct_num,
                                   const float* __restrict__ ct_den,
                                   float* __restrict__ du,
                                   float* __restrict__ dx,
                                   int n_rows, int dim, int heads) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kGatherWarps + warp;
  if (row >= n_rows) return;                     // whole warp leaves together
  const int hd = heads * dim;
  float* ctn = smem + static_cast<size_t>(warp) * hd;   // ct_num[row]
  const float* crow = ct_num + static_cast<size_t>(row) * hd;
  for (int i = lane; i < hd; i += kWarp) ctn[i] = crow[i];
  __syncwarp();
  const float cden =
      lane < heads ? ct_den[static_cast<size_t>(row) * heads + lane] : 0.0f;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  float dxa[kMaxAccPerLane];
#pragma unroll
  for (int k = 0; k < kMaxAccPerLane; ++k) dxa[k] = 0.0f;
  for (int e0 = start; e0 < end; e0 += kWarp) {
    const int e = e0 + lane;
    int c = 0, r = 0;
    if (e < end) {
      c = col[e];
      if (dx != nullptr) r = rev[e];
    }
    const int n = min(kWarp, end - e0);
    for (int j = 0; j < n; ++j) {
      const int cj = __shfl_sync(kFull, c, j);
      const int rj = __shfl_sync(kFull, r, j);
      const TX* xr = x + static_cast<size_t>(cj) * dim;
      float xv[kMaxAccPerLane];
#pragma unroll
      for (int k = 0; k < kMaxAccPerLane; ++k) {
        const int d = lane + kWarp * k;
        xv[k] = d < dim ? widen(xr, d) : 0.0f;
      }
      float mine = 0.0f;                         // lane h keeps du[e, h]
      for (int h = 0; h < heads; ++h) {
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxAccPerLane; ++k) {
          const int d = lane + kWarp * k;
          if (d < dim) p += ctn[h * dim + d] * xv[k];
        }
        p = warp_sum(p);
        if (lane == h) mine = p;
      }
      if (lane < heads)
        du[static_cast<size_t>(e0 + j) * heads + lane] = mine + cden;
      if (dx == nullptr) continue;               // the same for every lane
      const float* ur = u + static_cast<size_t>(rj) * heads;
      const float* cn = ct_num + static_cast<size_t>(cj) * hd;
      for (int h = 0; h < heads; ++h) {
        const float uh = ur[h];                  // one address: a broadcast
#pragma unroll
        for (int k = 0; k < kMaxAccPerLane; ++k) {
          const int d = lane + kWarp * k;
          if (d < dim) dxa[k] += uh * cn[h * dim + d];
        }
      }
    }
  }
  if (dx == nullptr) return;
  float* orow = dx + static_cast<size_t>(row) * dim;
#pragma unroll
  for (int k = 0; k < kMaxAccPerLane; ++k) {
    const int d = lane + kWarp * k;
    if (d < dim) orow[d] = dxa[k];
  }
}

template <typename TX>
void launch_scatter(const void* rowptr, const void* col, const void* u,
                    const void* x, void* num, void* den, int n_rows, int dim,
                    int heads, cudaStream_t stream) {
  const int blocks = (n_rows + kScatterWarps - 1) / kScatterWarps;
  dual_scatter_kernel<TX><<<blocks, kScatterWarps * kWarp, 0, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const float*>(u), static_cast<const TX*>(x),
      static_cast<float*>(num), static_cast<float*>(den), n_rows, dim,
      heads);
}

template <typename TX>
int launch_gather(const void* rowptr, const void* col, const void* rev,
                  const void* u, const void* x, const void* ct_num,
                  const void* ct_den, void* du, void* dx, int n_rows, int dim,
                  int heads, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * kGatherWarps * heads * dim;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dual_gather_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rows + kGatherWarps - 1) / kGatherWarps;
  dual_gather_kernel<TX><<<blocks, kGatherWarps * kWarp, bytes, stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const int*>(rev), static_cast<const float*>(u),
      static_cast<const TX*>(x), static_cast<const float*>(ct_num),
      static_cast<const float*>(ct_den), static_cast<float*>(du),
      static_cast<float*>(dx), n_rows, dim, heads);
  return 0;
}

}  // namespace

// tables: the gathered table x, 0 for float32, 1 for bfloat16 (u, num and
// den are float32)
extern "C" int gnpde_dual_scatter(const void* rowptr, const void* col,
                                  const void* u, const void* x, void* num,
                                  void* den, int n_rows, int dim, int heads,
                                  int tables, void* stream) {
  if (tables != 0 && tables != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0 && dim > 0 && heads > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (tables == 0)
      launch_scatter<float>(rowptr, col, u, x, num, den, n_rows, dim, heads,
                            s);
    else
      launch_scatter<__nv_bfloat16>(rowptr, col, u, x, num, den, n_rows,
                                    dim, heads, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wrapper bounds dim by 256 and heads by 32 and checks that four rows
// of ct_num fit a block's shared memory. rev and dx are null together (a
// directed graph: du only). tables as gnpde_dual_scatter (x only; u, the
// cotangents, du and dx are float32).
extern "C" int gnpde_dual_gather(const void* rowptr, const void* col,
                                 const void* rev, const void* u,
                                 const void* x, const void* ct_num,
                                 const void* ct_den, void* du, void* dx,
                                 int n_rows, int dim, int heads, int tables,
                                 void* stream) {
  if (tables != 0 && tables != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0 && dim > 0 && heads > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const int err =
        tables == 0
            ? launch_gather<float>(rowptr, col, rev, u, x, ct_num, ct_den, du,
                                   dx, n_rows, dim, heads, s)
            : launch_gather<__nv_bfloat16>(rowptr, col, rev, u, x, ct_num,
                                           ct_den, du, dx, n_rows, dim,
                                           heads, s);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
