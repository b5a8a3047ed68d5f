// K3 segment_norm and K4 segment_norm_bwd: per-segment normalisation of
// per-edge, per-head values s[E, H] over the row-sorted valid prefix that
// rowptr delimits, and its gradient.
//
//   softmax:   out[e] = exp(s[e] - m) / (den + 1e-16),  m = max_seg s,
//              den = sum_seg exp(s - m)
//   normalise: out[e] = s[e] / (den + 1e-16),           den = sum_seg s
//
// den[N, H] is written too. The segments are rows: the edges
// [rowptr[n], rowptr[n+1]). With a perm (the reverse-edge bijection rev of
// a symmetric edge multiset) they are columns: for each e of row n's range
// the member is slot perm[e], whose col is n, so node n's column segment is
// read and written through perm and summed in row n's order.
//
// Replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _scatter_kernel / _stripe_scatter_call (P3, the unweighted stripe segment
// sum) where it forms, with the row gather _stripe_gather_call (P2), the
// row softmax and squareplus of stripe_segment_softmax /
// stripe_segment_squareplus and the norm_idx=0 frozen attention
// (models/attention.py:217-246): there the denominator is a one-hot MXU
// scatter, gathered back per edge by a second one-hot matmul, after a
// first-edge or global shift with an exact fallback. On Hopper one warp
// walks a segment directly: an exact per-segment max, then exp, the sum
// and the divide, so no shift trick and no fallback exist.
//
// What bounds it on the H100: memory traffic and latency, not arithmetic.
// Each member is read two or three times per head (max, sum, write pass;
// the later reads are L1/L2 hits) and written once: ~12 bytes per element
// for a few flops. The heads are few (1-8 on the tuned configs), so lanes
// run over a segment's edges, not its heads: a head-wide layout would leave
// most lanes idle at H = 1. With a perm the reads are random, like the
// x[col] gathers of the SpMM.
//
// Design: one warp per segment, lanes strided over its edges, a loop over
// heads; each lane reduces its edges in order and the warp combines the
// lanes with a fixed xor-shuffle butterfly. No atomics: the order of every
// sum is fixed, so the output is bit-for-bit reproducible from run to run.
// The wrapper zero-fills out (and ds) so padding slots read 0.
//
// K4 is the gradient of K3 given its output, one pass per segment:
//   softmax:   ds = out * (g - sum_seg g * out)
//   normalise: ds = (g - sum_seg g * out) / (den + 1e-16)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kEps = 1e-16f;
constexpr int kSoftmax = 0;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// the slot of the segment member at position e of the row-sorted order
__device__ __forceinline__ size_t member(const int* perm, int e) {
  return static_cast<size_t>(perm ? perm[e] : e);
}

__global__ void segment_norm_kernel(const int* __restrict__ rowptr,
                                    const int* __restrict__ perm,
                                    const float* __restrict__ s,
                                    float* __restrict__ out,
                                    float* __restrict__ den,
                                    int n_rows, int heads, int mode) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;                     // whole warp leaves together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int h = 0; h < heads; ++h) {
    float m = 0.0f;
    if (mode == kSoftmax) {
      float mx = -INFINITY;
      for (int e = start + lane; e < end; e += kWarp)
        mx = fmaxf(mx, s[member(perm, e) * heads + h]);
      m = warp_max(mx);                          // -inf only for an empty row
    }
    float acc = 0.0f;
    for (int e = start + lane; e < end; e += kWarp) {
      const float v = s[member(perm, e) * heads + h];
      acc += mode == kSoftmax ? expf(v - m) : v;
    }
    const float total = warp_sum(acc);
    if (lane == 0) den[static_cast<size_t>(row) * heads + h] = total;
    const float denom = total + kEps;
    for (int e = start + lane; e < end; e += kWarp) {
      const size_t i = member(perm, e) * heads + h;
      const float u = mode == kSoftmax ? expf(s[i] - m) : s[i];
      out[i] = u / denom;
    }
  }
}

__global__ void segment_norm_bwd_kernel(const int* __restrict__ rowptr,
                                        const int* __restrict__ perm,
                                        const float* __restrict__ out,
                                        const float* __restrict__ g,
                                        const float* __restrict__ den,
                                        float* __restrict__ ds,
                                        int n_rows, int heads, int mode) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int h = 0; h < heads; ++h) {
    float acc = 0.0f;
    for (int e = start + lane; e < end; e += kWarp) {
      const size_t i = member(perm, e) * heads + h;
      acc += g[i] * out[i];
    }
    const float dot = warp_sum(acc);
    const float denom = den[static_cast<size_t>(row) * heads + h] + kEps;
    for (int e = start + lane; e < end; e += kWarp) {
      const size_t i = member(perm, e) * heads + h;
      ds[i] = mode == kSoftmax ? out[i] * (g[i] - dot) : (g[i] - dot) / denom;
    }
  }
}

int blocks_for(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" int gnpde_segment_norm(const void* rowptr, const void* perm,
                                  const void* s, void* out, void* den,
                                  int n_rows, int heads, int mode,
                                  void* stream) {
  if (n_rows > 0 && heads > 0) {
    segment_norm_kernel<<<blocks_for(n_rows), kWarpsPerBlock * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(perm),
        static_cast<const float*>(s), static_cast<float*>(out),
        static_cast<float*>(den), n_rows, heads, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gnpde_segment_norm_bwd(const void* rowptr, const void* perm,
                                      const void* out, const void* g,
                                      const void* den, void* ds, int n_rows,
                                      int heads, int mode, void* stream) {
  if (n_rows > 0 && heads > 0) {
    segment_norm_bwd_kernel<<<blocks_for(n_rows), kWarpsPerBlock * kWarp, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(perm),
        static_cast<const float*>(out), static_cast<const float*>(g),
        static_cast<const float*>(den), static_cast<float*>(ds), n_rows,
        heads, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
