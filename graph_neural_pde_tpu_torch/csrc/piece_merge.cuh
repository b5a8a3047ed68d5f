// The second pass of every walk over row pieces that keeps a partial row a
// piece (ops/graph.py, ColPieces): a row of several pieces gets its partial
// rows added in piece order. Shared by K10 and K11 (dual_common.cuh), K18
// and K8's per-head mode over the scaled-dot fold (payload_walk.cuh) and
// K18 for the key families (fused_payload.cu), which differ only in the
// width of the partial rows and where their two parts go. Each source
// that includes this header gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMergeThreads = 256;

// S: the floats of a payload walk's partial row ([num | den] forward, [a |
// b] backward) and of the backward's rows of [a | b], H D + H rounded up to
// 16 bytes
__host__ __device__ constexpr int payload_stride(int dim, int heads) {
  return (heads * (dim + 1) + 3) / 4 * 4;
}

// Row multi_row[m]'s partial rows [multi_ptr[m], multi_ptr[m + 1]) (width
// floats each, stride apart: the first width_a to out_a's row of width_a,
// the rest to out_b's) added in piece order, a thread an element. Each
// source wraps it in a kernel of its own name (the profiler counts its
// time to the source's kernel, not its launches).
__device__ __forceinline__ void merge_partials(
    const int* __restrict__ multi_ptr, const int* __restrict__ multi_row,
    int n_multi, const float* __restrict__ part, int stride, int width,
    float* __restrict__ out_a, int width_a, float* __restrict__ out_b) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  const long long m = t / width;
  const int i = static_cast<int>(t % width);
  if (m >= n_multi) return;
  float s = 0.0f;
  for (int p = multi_ptr[m]; p < multi_ptr[m + 1]; ++p)
    s += part[static_cast<size_t>(p) * stride + i];
  const size_t row = multi_row[m];
  if (i < width_a)
    out_a[row * width_a + i] = s;
  else
    out_b[row * (width - width_a) + (i - width_a)] = s;
}

// The source's merge kernel over pc's rows of several pieces (none: no
// launch); P is the source's pieces type
template <typename P>
cudaError_t merge(void (*kernel)(P, const float*, int, int, float*, int,
                                 float*),
                  const P& pc, const void* part, int stride, int width,
                  void* out_a, int width_a, void* out_b, cudaStream_t s) {
  if (pc.n_multi == 0) return cudaSuccess;
  const long long threads = static_cast<long long>(pc.n_multi) * width;
  const int blocks =
      static_cast<int>((threads + kMergeThreads - 1) / kMergeThreads);
  kernel<<<blocks, kMergeThreads, 0, s>>>(
      pc, static_cast<const float*>(part), stride, width,
      static_cast<float*>(out_a), width_a, static_cast<float*>(out_b));
  return cudaGetLastError();
}

}  // namespace
