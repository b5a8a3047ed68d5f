// Device code shared by K10 dual_scatter (dual_scatter.cu) and K11
// dual_gather (dual_gather.cu): the row pieces, the loads of u's heads,
// the transposed butterfly that sums a group's heads and the dispatch of
// a call to the instantiation of its lane group, vector width, vectors a
// lane and heads a pass (the design is in dual_scatter.cu's note); the
// merge of the pieces' partial rows is piece_merge.cuh's. Each source that includes this
// header gets its own copy (anonymous namespace), so the sources still
// compile independently, one nvcc each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "piece_merge.cuh"
#include "row_vectors.cuh"

namespace {

using gnpde_rows::kRawRegs;
using gnpde_rows::load;
using gnpde_rows::load_floats;
using gnpde_rows::Raw;
using gnpde_rows::store;
using gnpde_rows::widen;

// The floats of sums (K10) or of ct_num[row] (K11) a lane keeps per head
// pass; probes/lanes.py builds variants of the sources with other values
#ifndef GNPDE_DUAL_ACC
#define GNPDE_DUAL_ACC 64
#endif
// The edges whose rows a lane loads before their arithmetic, at most
constexpr int kMaxBatch = 4;

constexpr int kThreads = 256;
constexpr int kMaxHeadsPerPass = 8;

// The rows cut into pieces (ops/graph.py, ColPieces of rowptr)
struct Pieces {
  const int *ptr, *row, *slot, *multi_row, *multi_ptr;
  int n_pieces, n_multi;
};

Pieces make_pieces(const void* piece_ptr, const void* piece_row,
                   const void* piece_slot, const void* multi_row,
                   const void* multi_ptr, int n_pieces, int n_multi) {
  return {static_cast<const int*>(piece_ptr),
          static_cast<const int*>(piece_row),
          static_cast<const int*>(piece_slot),
          static_cast<const int*>(multi_row),
          static_cast<const int*>(multi_ptr), n_pieces, n_multi};
}

// What a launch reads and writes, beside its pieces
struct DualArgs {
  const void *col, *rev, *u, *x, *ct_num, *ct_den;
  void *num, *den, *du, *dx, *part;
  int dim, heads, n_slots, uvec;
};

// The heads of a pass that K * V floats a head leave room for: a power of
// two, at most kMaxHeadsPerPass
template <int K, int V>
__host__ __device__ constexpr int head_cap() {
  int hp = GNPDE_DUAL_ACC / (K * V);
  int p = 1;
  while (p * 2 <= hp && p * 2 <= kMaxHeadsPerPass) p *= 2;
  return p;
}

// The edges of a batch whose loads take `regs` registers an edge, in
// `budget` registers: 1 to kMaxBatch
__host__ __device__ constexpr int batch_of(int budget, int regs) {
  return budget / regs < 1 ? 1
                           : (budget / regs > kMaxBatch ? kMaxBatch
                                                        : budget / regs);
}

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << (G % 32)) - 1u) << (threadIdx.x % 32 / G * G);
}

template <int G, typename S>
__device__ __forceinline__ S from_lane(unsigned group, S v, int src) {
  return G == 1 ? v : __shfl_sync(group, v, src, G);
}

// u[e, h0 + h] for h < HP, 0 past the row's heads or for an edge that is
// not there (valid false); uvec: u's rows as float4 (4) or float2 (2)
// loads, or floats (1)
template <int HP>
__device__ __forceinline__ void load_heads(const float* __restrict__ u,
                                           int e, int h0, int heads, int uvec,
                                           bool valid, float (&o)[HP]) {
#pragma unroll
  for (int h = 0; h < HP; ++h) o[h] = 0.0f;
  if (!valid) return;
  const float* p = u + static_cast<size_t>(e) * heads + h0;
  if (HP >= 4 && uvec == 4) {
#pragma unroll
    for (int c = 0; c < HP / 4; ++c)
      if (h0 + 4 * c < heads) widen(__ldg(reinterpret_cast<const float4*>(p)
                                          + c), o + 4 * c);
  } else if (HP >= 2 && uvec >= 2) {
#pragma unroll
    for (int c = 0; c < HP / 2; ++c)
      if (h0 + 2 * c < heads) widen(__ldg(reinterpret_cast<const float2*>(p)
                                          + c), o + 2 * c);
  } else {
#pragma unroll
    for (int h = 0; h < HP; ++h)
      if (h0 + h < heads) o[h] = __ldg(p + h);
  }
}

// The sums over a group's G lanes of the HP values v of each lane, by a
// transposed xor butterfly: at level o (G/2, ..., 1) a lane with bit o set
// keeps the upper half of the values it still holds and adds its
// partner's upper half, the other lane the lower halves; once one value is
// left, the levels add it whole. Lane l ends with J = max(1, HP / G) sums
// in v[0, J): head (l * HP) / G + j, every lane that shares a head with the
// same bits. A fixed order: two launches agree bit for bit.
template <int G, int HP>
__device__ __forceinline__ void group_head_sums(float (&v)[HP],
                                                unsigned group, int lane) {
#pragma unroll
  for (int level = 0; (G >> (level + 1)) > 0; ++level) {
    const int o = G >> (level + 1);
    const int m = HP >> level;                  // values still held
    if (m >= 2) {
      const bool upper = lane & o;
#pragma unroll
      for (int j = 0; j < HP / 2; ++j) {
        if (j < m / 2) {
          const float send = upper ? v[j] : v[j + m / 2];
          const float keep = upper ? v[j + m / 2] : v[j];
          v[j] = keep + __shfl_xor_sync(group, send, o, G);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(group, v[0], o, G);
    }
  }
}

// The head of sum j that lane l holds after group_head_sums, and whether
// the lane writes it (one lane of those that hold it)
template <int G, int HP>
__device__ __forceinline__ int head_of(int lane, int j) {
  return lane * HP / G + j;
}

template <int G, int HP>
__device__ __forceinline__ bool writes_head(int lane) {
  if constexpr (G <= HP) {
    return true;
  } else {
    return lane % (G / HP) == 0;
  }
}

template <int G>
int blocks_for(const Pieces& pc) {
  const long long threads = static_cast<long long>(pc.n_pieces) * G;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

// HP: the heads rounded up to a power of two, at most head_cap. Walk::
// template launch<T, G, V, K, HP>(pc, a, s) launches the source's walk.
template <typename Walk, typename T, int G, int V, int K>
cudaError_t launch_hp(const Pieces& pc, const DualArgs& a, cudaStream_t s) {
  constexpr int cap = head_cap<K, V>();
  int hp = 1;
  while (hp < a.heads && hp < cap) hp *= 2;
#define GNPDE_DUAL_HP(HP)                                                  \
  if constexpr (HP <= cap) {                                              \
    if (hp == HP) return Walk::template launch<T, G, V, K, HP>(pc, a, s); \
  }
  GNPDE_DUAL_HP(1)
  GNPDE_DUAL_HP(2)
  GNPDE_DUAL_HP(4)
  GNPDE_DUAL_HP(8)
#undef GNPDE_DUAL_HP
  return cudaErrorInvalidValue;
}

// The (G, V, K) built: the widest vector of T (16 bytes) at G = 4, 8, 16
// or 32 with K = 1 or 2 vectors a lane (kernels/lanes.py covers every row
// of up to 64 such vectors in one pass so), single elements at G = 32 with
// K = 8 (rows of up to 256 elements), and where Walk::kHalfVectors, 8-byte
// vectors of a 2-byte T at G = 32
template <typename Walk, typename T, int G, int V>
cudaError_t launch_k(const Pieces& pc, const DualArgs& a, cudaStream_t s) {
  const int k = (a.dim / V + G - 1) / G;
  if constexpr (V == 1) {
    if (k <= 8) return launch_hp<Walk, T, G, V, 8>(pc, a, s);
  } else {
    if (k <= 1) return launch_hp<Walk, T, G, V, 1>(pc, a, s);
    if (k <= 2) return launch_hp<Walk, T, G, V, 2>(pc, a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename Walk, typename T>
cudaError_t launch_gv(int lanes, int vec, const Pieces& pc,
                      const DualArgs& a, cudaStream_t s) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) {
    switch (lanes) {
      case 4: return launch_k<Walk, T, 4, kWide>(pc, a, s);
      case 8: return launch_k<Walk, T, 8, kWide>(pc, a, s);
      case 16: return launch_k<Walk, T, 16, kWide>(pc, a, s);
      case 32: return launch_k<Walk, T, 32, kWide>(pc, a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if constexpr (Walk::kHalfVectors && sizeof(T) == 2) {
    if (vec == kWide / 2 && lanes == 32)
      return launch_k<Walk, T, 32, kWide / 2>(pc, a, s);
  }
  if (vec == 1 && lanes == 32) return launch_k<Walk, T, 32, 1>(pc, a, s);
  return cudaErrorInvalidValue;
}

// tables: x's dtype, 0 float32, 1 bfloat16 (kBf16: a walk that reads no
// x, built for float32 rows only, takes 0); refuses any (lanes, vec) pair
// not built
template <typename Walk, bool kBf16 = true>
cudaError_t launch_dual(int lanes, int vec, int tables, const Pieces& pc,
                        DualArgs a, cudaStream_t s) {
  if ((tables != 0 && !(kBf16 && tables == 1)) || vec <= 0
      || a.dim % vec != 0)
    return cudaErrorInvalidValue;
  const auto addr = reinterpret_cast<uintptr_t>(a.u);
  a.uvec = a.heads % 4 == 0 && addr % 16 == 0   ? 4
           : a.heads % 2 == 0 && addr % 8 == 0 ? 2
                                               : 1;
  if constexpr (kBf16) {
    if (tables == 1)
      return launch_gv<Walk, __nv_bfloat16>(lanes, vec, pc, a, s);
  }
  return launch_gv<Walk, float>(lanes, vec, pc, a, s);
}

}  // namespace
