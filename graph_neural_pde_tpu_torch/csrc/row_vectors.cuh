// Rows of a node table read as vectors: the loads and stores K1 csr_spmm
// (csr_spmm.cu), K2 edge_dot (edge_dot.cu), K10 dual_scatter and K11
// dual_gather (dual_scatter.cu) share. A vector is V
// elements of a float32 or bfloat16 row, loaded in one instruction of V *
// sizeof(T) bytes (the row and the table lie on that boundary; the
// wrappers pick V with kernels/lanes.py) and widened to float32 where it
// is used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gnpde_rows {

// A vector of V elements of T as it is loaded (one load of V * sizeof(T)
// bytes), and the 4-byte registers it takes.
template <typename T, int V> struct Raw;
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <typename T, int V>
constexpr int kRawRegs = (V * static_cast<int>(sizeof(T)) + 3) / 4;

// Vector v of a row (the row and the table lie on its boundary), through
// the read-only data cache (ld.global.nc): K1's loads, which it batches
// over edges itself.
template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load(const T* r, int v) {
  return __ldg(reinterpret_cast<const typename Raw<T, V>::type*>(r) + v);
}

// ... as a plain load of a const __restrict__ table, which the compiler
// still reads through the read-only path and schedules freely: K2's loads
// (with __ldg, K2 took 6 more registers and up to 21% longer on the grid,
// while K1 at D = 162 took 22% longer without it; probes/lanes.py,
// PERF.md).
template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load_plain(const T* r,
                                                              int v) {
  return reinterpret_cast<const typename Raw<T, V>::type*>(r)[v];
}

// ... widened to float32.
__device__ __forceinline__ void widen(float f, float* o) { o[0] = f; }
__device__ __forceinline__ void widen(float2 f, float* o) {
  o[0] = f.x;
  o[1] = f.y;
}
__device__ __forceinline__ void widen(float4 f, float* o) {
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}
__device__ __forceinline__ void widen(unsigned short b, float* o) {
  o[0] = __uint_as_float(static_cast<unsigned int>(b) << 16);
}
__device__ __forceinline__ void widen(unsigned int b, float* o) {
  o[0] = __uint_as_float(b << 16);
  o[1] = __uint_as_float(b & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint2 b, float* o) {
  widen(b.x, o);
  widen(b.y, o + 2);
}
__device__ __forceinline__ void widen(uint4 b, float* o) {
  widen(b.x, o);
  widen(b.y, o + 2);
  widen(b.z, o + 4);
  widen(b.w, o + 6);
}

// V float32 sums to row o at vector index v (o lies on a V-float
// boundary, or on a 16-byte one for V = 8).
template <int V>
__device__ __forceinline__ void store(float* o, int v, const float (&a)[V]) {
  if constexpr (V == 1) {
    o[v] = a[0];
  } else if constexpr (V == 2) {
    reinterpret_cast<float2*>(o)[v] = make_float2(a[0], a[1]);
  } else {
    float4* q = reinterpret_cast<float4*>(o) + v * (V / 4);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      q[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
  }
}

// V float32s of row r at vector index v, as store lays them (V / 4
// 16-byte loads for V = 8), through the read-only data cache.
template <int V>
__device__ __forceinline__ void load_floats(const float* r, int v,
                                            float (&a)[V]) {
  if constexpr (V <= 4) {
    widen(load<float, V>(r, v), a);
  } else {
    const float4* q = reinterpret_cast<const float4*>(r) + v * (V / 4);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) widen(__ldg(q + i), a + 4 * i);
  }
}

}  // namespace gnpde_rows
