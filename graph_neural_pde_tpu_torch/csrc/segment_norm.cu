// K3 segment_norm and K4 segment_norm_bwd: per-segment normalisation of
// per-edge, per-head values s[E, H] over a row-sorted edge list, and its
// gradient.
//
//   softmax:   out[e] = exp(s[e] - m) / (den + 1e-16),  m = max_seg s,
//              den = sum_seg exp(s - m)
//   normalise: out[e] = s[e] / (den + 1e-16),           den = sum_seg s
//
// den[N, H] is written too. Segment n is the positions
// [segptr[n], segptr[n+1]); its members are the slots at those positions,
// or with a perm the slots perm[i]. Rows are segptr = rowptr without a
// perm. Columns are either segptr = rowptr with perm = rev, the reverse-edge
// bijection of a symmetric edge multiset (for each e of row n's range the
// member rev[e] has col n, so node n's column segment is read and written
// through rev in row n's order), or, on any graph, the CSC view: segptr =
// colptr and perm = col_perm, the slots in column order (the JAX package's
// column plan). In all three the members of the segments are the valid
// slots [0, segptr[N]), each once.
//
// Replaces the TPU kernel graph_neural_pde_tpu/ops/pallas/stripe.py
// _scatter_kernel / _stripe_scatter_call (P3, the unweighted stripe segment
// sum) where it forms, with the row gather _stripe_gather_call (P2), the
// row softmax and squareplus of stripe_segment_softmax /
// stripe_segment_squareplus and the norm_idx=0 frozen attention
// (models/attention.py:217-246): there the denominator is a one-hot MXU
// scatter, gathered back per edge by a second one-hot matmul, after a
// first-edge or global shift with an exact fallback. Here a group of lanes
// walks a segment directly: an exact per-segment max, then exp, the sum
// and the divide, so no shift trick and no fallback exist.
//
// What bounds it on the H100: memory traffic, not arithmetic: each member
// is an index (with a perm), H scores read and H outputs written, for a
// few flops. With a perm the reads are random, like the x[col] gathers of
// the SpMM.
//
// Design. The first version gave each segment a warp with its lanes over
// the members and the heads in an outer loop: each head walked the segment
// three times (max, sum, write), reloading the member's index and a 4-byte
// score at a stride of 4 * H bytes each time (a member's 32-byte sector
// fetched 24 times at H = 8), ran exp twice an element, left most lanes
// idle on segments of ~10 members, and the wrapper zero-filled out first.
// Here:
// * A group of G lanes (4, 8, 16 or 32; kernels/lanes.py's
//   segment_design picks it from the mean segment length and the heads)
//   owns a piece of at most P members of one segment (the graph's segment
//   pieces, ops/graph.py's column_pieces: P = 32, or 64 where the mean
//   segment is longer than 32): lane l holds the members l, l + G, ...
//   (R = P / G of them, at most kMaxMembers).
// * A lane loads each member's index once and its H scores once, as
//   16-, 8- or 4-byte vectors (V floats, where H and the addresses allow),
//   and keeps them in registers, heads in passes of HP (H rounded up to a
//   power of two, at most 8), across the max, the exps and the write: exp
//   runs once an element, and each member's H outputs go out as vectors.
// * The group's per-head max and sum: a transposed xor butterfly at
//   offsets below G (at each level a lane keeps half the heads it holds
//   and takes its partner's half of them, dual_common.cuh's
//   group_head_sums with the operation a parameter), then each head's
//   result read from the lane that holds it: HP - 1 + log2(G / HP) + HP
//   shuffles a reduction in place of HP * log2(G).
// * A segment of one piece is finished by its group. The pieces of a
//   longer segment write their (max, sum) per head (K4: their sum of
//   g * out) to a partial row; a second kernel (segment_norm_merge_kernel,
//   segment_norm_bwd_merge_kernel), a group a piece of those segments,
//   merges its segment's partial rows in piece order (softmax: the maximum
//   of the pieces' maxima m, then each piece's sum scaled by exp(m_p - m),
//   a piece of only -inf scores adding 0), re-reads the piece's members
//   (from the L2) and writes them; the group of the segment's first piece
//   writes den.
// * The slots past segptr[N] (padding) are written 0 by the first kernel,
//   so the wrappers allocate out and ds without a memset.
// No atomics: the order of every sum is fixed (members in lane order, the
// butterfly, pieces in order), so two launches agree bit for bit.
//
// K4 is the gradient of K3 given its output, on the same walk:
//   softmax:   ds = out * (g - sum_seg g * out)
//   normalise: ds = (g - sum_seg g * out) / (den + 1e-16)
// A lane loads out and g of its members as vectors once; den is read once
// a segment, as a vector of its heads.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

// The partial rows a merge group loads before their arithmetic
constexpr int kMergeBatch = 4;
constexpr int kThreads = 256;
constexpr int kMaxHeadsPerPass = 8;
// The members a lane holds, at most
constexpr int kMaxMembers = 8;
constexpr float kEps = 1e-16f;
constexpr int kSoftmax = 0;

// The segments cut into pieces of at most piece members (ops/graph.py,
// ColPieces of segptr)
struct Pieces {
  const int *ptr, *seg, *slot, *multi_piece;
  int n_pieces, n_slots, piece;
};

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << (G % 32)) - 1u) << (threadIdx.x % 32 / G * G);
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};
struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

// The reduction (Op) over a group's G lanes of the HP values v of each
// lane, every lane ending with all HP results. First a transposed xor
// butterfly: at level o (G/2, ..., 1) a lane with bit o set keeps the
// upper half of the values it still holds and combines them with its
// partner's upper half, the other lane the lower halves; once one value is
// left, the levels combine it whole. Lane l then holds J = max(1, HP / G)
// results, of heads l * HP / G + j (every lane that shares a head the same
// value). Then each head's result is read from the first lane that holds
// it. A fixed order: two launches agree bit for bit.
template <int G, int HP, typename Op>
__device__ __forceinline__ void group_reduce(float (&v)[HP], unsigned group,
                                             int lane, Op op) {
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
          v[j] = op(keep, __shfl_xor_sync(group, send, o, G));
        }
      }
    } else {
      v[0] = op(v[0], __shfl_xor_sync(group, v[0], o, G));
    }
  }
  if constexpr (HP > 1) {
    constexpr int J = HP / G > 1 ? HP / G : 1;
    float held[J];
#pragma unroll
    for (int j = 0; j < J; ++j) held[j] = v[j];
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      // head h's first holder: lane h / J (G <= HP) or h * G / HP
      const int src = G <= HP ? h / J : h * (G / HP);
      v[h] = __shfl_sync(group, held[h % J], src, G);
    }
  }
}

// p[0, nh) into o (the rest of o keeps its fill), as vec-float loads
// through the read-only cache (p and nh on a vec-float boundary)
template <int HP>
__device__ __forceinline__ void load_heads(const float* __restrict__ p,
                                           int nh, int vec, float (&o)[HP]) {
  if (HP >= 4 && vec == 4) {
#pragma unroll
    for (int c = 0; c < HP / 4; ++c)
      if (4 * c < nh) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p) + c);
        o[4 * c] = f.x;
        o[4 * c + 1] = f.y;
        o[4 * c + 2] = f.z;
        o[4 * c + 3] = f.w;
      }
  } else if (HP >= 2 && vec == 2) {
#pragma unroll
    for (int c = 0; c < HP / 2; ++c)
      if (2 * c < nh) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(p) + c);
        o[2 * c] = f.x;
        o[2 * c + 1] = f.y;
      }
  } else {
#pragma unroll
    for (int h = 0; h < HP; ++h)
      if (h < nh) o[h] = __ldg(p + h);
  }
}

// o[0, nh) to p[0, nh), as vec-float stores
template <int HP>
__device__ __forceinline__ void store_heads(float* __restrict__ p, int nh,
                                            int vec, const float (&o)[HP]) {
  if (HP >= 4 && vec == 4) {
#pragma unroll
    for (int c = 0; c < HP / 4; ++c)
      if (4 * c < nh)
        reinterpret_cast<float4*>(p)[c] = make_float4(
            o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
  } else if (HP >= 2 && vec == 2) {
#pragma unroll
    for (int c = 0; c < HP / 2; ++c)
      if (2 * c < nh)
        reinterpret_cast<float2*>(p)[c] = make_float2(o[2 * c], o[2 * c + 1]);
  } else {
#pragma unroll
    for (int h = 0; h < HP; ++h)
      if (h < nh) p[h] = o[h];
  }
}

template <int HP>
__device__ __forceinline__ void fill(float (&o)[HP], float f) {
#pragma unroll
  for (int h = 0; h < HP; ++h) o[h] = f;
}

// Partial rows i0 + b (b < B) of the rows stride floats apart from p, the
// ones past count left at f: one batch of loads before its arithmetic
template <int B, int HP>
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          size_t stride, int i0, int count,
                                          int nh, int vec, float f,
                                          float (&o)[B][HP]) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    fill(o[b], f);
    if (i0 + b < count) load_heads(p + (i0 + b) * stride, nh, vec, o[b]);
  }
}

// The elements of the padding slots [segptr[n_segs], capacity), a grid
// stride apart, set to 0
__device__ __forceinline__ void zero_padding(const int* __restrict__ segptr,
                                             int n_segs, int capacity,
                                             int heads, float* __restrict__ o) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long end = static_cast<long long>(capacity) * heads;
  for (long long i = static_cast<long long>(segptr[n_segs]) * heads
                     + static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < end; i += stride)
    o[i] = 0.0f;
}

// Where a group's R members start in the [E, H] tables (their slot times
// H), and which of them exist: positions start + lane + G * r below end
template <int G, int R>
__device__ __forceinline__ void member_rows(const int* __restrict__ perm,
                                            int start, int end, int lane,
                                            int heads, size_t (&at)[R],
                                            bool (&ok)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pos = start + lane + G * r;
    ok[r] = pos < end;
    at[r] = ok[r] ? static_cast<size_t>(perm ? __ldg(perm + pos) : pos)
                        * heads
                  : 0;
  }
}

// The piece a merge group writes (a piece of a multi-piece segment, its
// partial row q) and its segment's partial rows [first, first + count):
// the segment's pieces start pc.piece members apart, their rows in order
struct MultiPiece {
  int start, end, seg, first, count, index;
};

__device__ __forceinline__ MultiPiece multi_piece(const Pieces& pc,
                                                  const int* __restrict__ segptr,
                                                  int q) {
  const int p = pc.multi_piece[q];
  const int seg = pc.seg[p];
  const int s0 = segptr[seg], s1 = segptr[seg + 1];
  const int start = pc.ptr[p];
  const int index = (start - s0) / pc.piece;
  return {start, pc.ptr[p + 1], seg, q - index,
          (s1 - s0 + pc.piece - 1) / pc.piece, index};
}

// K3 over one piece a group: the whole segment where it is one piece (out,
// den), else the piece's (max, sum) per head to its partial row
// part[slot] ([H] maxima, then [H] sums)
template <int G, int R, int HP>
__global__ void __launch_bounds__(kThreads)
    segment_norm_kernel(Pieces pc, const int* __restrict__ segptr,
                        const int* __restrict__ perm,
                        const float* __restrict__ s, float* __restrict__ out,
                        float* __restrict__ den, float* __restrict__ part,
                        int n_segs, int capacity, int heads, int mode,
                        int vec) {
  zero_padding(segptr, n_segs, capacity, heads, out);
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;            // whole groups leave together
  const int lane = threadIdx.x % G;
  const unsigned group = group_mask<G>();
  const int seg = pc.seg[piece], slot = pc.slot[piece];
  const bool softmax = mode == kSoftmax;
  size_t at[R];
  bool ok[R];
  member_rows<G, R>(perm, pc.ptr[piece], pc.ptr[piece + 1], lane, heads, at,
                    ok);
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    float v[R][HP];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fill(v[r], softmax ? -INFINITY : 0.0f);
      if (ok[r]) load_heads(s + at[r] + h0, nh, vec, v[r]);
    }
    float m[HP], shift[HP], sum[HP];
    if (softmax) {
      fill(m, -INFINITY);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int h = 0; h < HP; ++h) m[h] = fmaxf(m[h], v[r][h]);
      group_reduce<G, HP>(m, group, lane, Max());
      // a segment (or piece) whose every score is -inf (all its edges
      // masked out, or none): shift by 0, so that each exp is 0 and not NaN
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        shift[h] = m[h] == -INFINITY ? 0.0f : m[h];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][h] = expf(v[r][h] - shift[h]);
      }
    }
    fill(sum, 0.0f);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < HP; ++h) sum[h] += v[r][h];
    group_reduce<G, HP>(sum, group, lane, Sum());
    if (slot >= 0) {
      if (lane == 0) {
        float* row = part + static_cast<size_t>(slot) * 2 * heads + h0;
        if (softmax) store_heads(row, nh, vec, m);
        store_heads(row + heads, nh, vec, sum);
      }
      continue;
    }
    if (lane == 0)
      store_heads(den + static_cast<size_t>(seg) * heads + h0, nh, vec, sum);
#pragma unroll
    for (int h = 0; h < HP; ++h) sum[h] += kEps;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!ok[r]) continue;
      float o[HP];
#pragma unroll
      for (int h = 0; h < HP; ++h) o[h] = v[r][h] / sum[h];
      store_heads(out + at[r] + h0, nh, vec, o);
    }
  }
}

// The second pass of K3: a group a piece of a multi-piece segment. Every
// group of the segment merges its partial rows in the same order, so all
// hold the same (shift, den); the first piece's group writes den.
template <int G, int R, int HP>
__global__ void __launch_bounds__(kThreads)
    segment_norm_merge_kernel(Pieces pc, const int* __restrict__ segptr,
                              const int* __restrict__ perm,
                              const float* __restrict__ s,
                              float* __restrict__ out,
                              float* __restrict__ den,
                              const float* __restrict__ part, int heads,
                              int mode, int vec) {
  const long long q =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (q >= pc.n_slots) return;
  const int lane = threadIdx.x % G;
  const MultiPiece mp = multi_piece(pc, segptr, static_cast<int>(q));
  const bool softmax = mode == kSoftmax;
  size_t at[R];
  bool ok[R];
  member_rows<G, R>(perm, mp.start, mp.end, lane, heads, at, ok);
  const size_t stride = static_cast<size_t>(2) * heads;
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    // the piece's members first: their loads overlap the merge's
    float v[R][HP];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fill(v[r], 0.0f);
      if (ok[r]) load_heads(s + at[r] + h0, nh, vec, v[r]);
    }
    const float* rows = part + static_cast<size_t>(mp.first) * stride + h0;
    float shift[HP], total[HP], a[kMergeBatch][HP], b[kMergeBatch][HP];
    fill(shift, 0.0f);
    fill(total, 0.0f);
    if (softmax) {
      fill(shift, -INFINITY);
      for (int i0 = 0; i0 < mp.count; i0 += kMergeBatch) {
        load_rows(rows, stride, i0, mp.count, nh, vec, -INFINITY, a);
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i)
#pragma unroll
          for (int h = 0; h < HP; ++h) shift[h] = fmaxf(shift[h], a[i][h]);
      }
#pragma unroll
      for (int h = 0; h < HP; ++h)
        if (shift[h] == -INFINITY) shift[h] = 0.0f;
    }
    // the pieces' sums in piece order
    for (int i0 = 0; i0 < mp.count; i0 += kMergeBatch) {
      load_rows(rows + heads, stride, i0, mp.count, nh, vec, 0.0f, b);
      if (softmax)
        load_rows(rows, stride, i0, mp.count, nh, vec, -INFINITY, a);
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        if (i0 + i >= mp.count) break;
        // a piece of only -inf scores has the sum 0: it adds 0 (its
        // exp(-inf - shift) must not meet an infinite scale)
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          if (!softmax)
            total[h] += b[i][h];
          else if (a[i][h] != -INFINITY)
            total[h] += b[i][h] * expf(a[i][h] - shift[h]);
        }
      }
    }
    if (mp.index == 0 && lane == 0)
      store_heads(den + static_cast<size_t>(mp.seg) * heads + h0, nh, vec,
                  total);
#pragma unroll
    for (int h = 0; h < HP; ++h) total[h] += kEps;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!ok[r]) continue;
#pragma unroll
      for (int h = 0; h < HP; ++h)
        v[r][h] = (softmax ? expf(v[r][h] - shift[h]) : v[r][h]) / total[h];
      store_heads(out + at[r] + h0, nh, vec, v[r]);
    }
  }
}

// ds of a member's heads from its out (o) and g, the segment's dot and,
// normalising, its den + eps (dn)
template <int HP>
__device__ __forceinline__ void bwd_heads(const float (&o)[HP],
                                          const float (&g)[HP],
                                          const float (&dot)[HP],
                                          const float (&dn)[HP], bool softmax,
                                          float (&ds)[HP]) {
#pragma unroll
  for (int h = 0; h < HP; ++h)
    ds[h] = softmax ? o[h] * (g[h] - dot[h]) : (g[h] - dot[h]) / dn[h];
}

// K4 over one piece a group: ds of the whole segment where it is one
// piece, else the piece's sums of g * out per head to part[slot] ([H])
template <int G, int R, int HP>
__global__ void __launch_bounds__(kThreads)
    segment_norm_bwd_kernel(Pieces pc, const int* __restrict__ segptr,
                            const int* __restrict__ perm,
                            const float* __restrict__ out,
                            const float* __restrict__ g,
                            const float* __restrict__ den,
                            float* __restrict__ ds, float* __restrict__ part,
                            int n_segs, int capacity, int heads, int mode,
                            int vec) {
  zero_padding(segptr, n_segs, capacity, heads, ds);
  const long long piece =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (piece >= pc.n_pieces) return;
  const int lane = threadIdx.x % G;
  const unsigned group = group_mask<G>();
  const int seg = pc.seg[piece], slot = pc.slot[piece];
  const bool softmax = mode == kSoftmax;
  size_t at[R];
  bool ok[R];
  member_rows<G, R>(perm, pc.ptr[piece], pc.ptr[piece + 1], lane, heads, at,
                    ok);
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    float o[R][HP], gg[R][HP], dot[HP], dn[HP];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fill(o[r], 0.0f);
      fill(gg[r], 0.0f);
      if (ok[r]) {
        load_heads(out + at[r] + h0, nh, vec, o[r]);
        load_heads(g + at[r] + h0, nh, vec, gg[r]);
      }
    }
    fill(dot, 0.0f);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < HP; ++h) dot[h] += gg[r][h] * o[r][h];
    group_reduce<G, HP>(dot, group, lane, Sum());
    if (slot >= 0) {
      if (lane == 0)
        store_heads(part + static_cast<size_t>(slot) * heads + h0, nh, vec,
                    dot);
      continue;
    }
    fill(dn, 1.0f);
    if (!softmax) {
      load_heads(den + static_cast<size_t>(seg) * heads + h0, nh, vec, dn);
#pragma unroll
      for (int h = 0; h < HP; ++h) dn[h] += kEps;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!ok[r]) continue;
      float d[HP];
      bwd_heads(o[r], gg[r], dot, dn, softmax, d);
      store_heads(ds + at[r] + h0, nh, vec, d);
    }
  }
}

// The second pass of K4: a group a piece of a multi-piece segment, its
// segment's partial sums added in piece order
template <int G, int R, int HP>
__global__ void __launch_bounds__(kThreads)
    segment_norm_bwd_merge_kernel(Pieces pc, const int* __restrict__ segptr,
                                  const int* __restrict__ perm,
                                  const float* __restrict__ out,
                                  const float* __restrict__ g,
                                  const float* __restrict__ den,
                                  float* __restrict__ ds,
                                  const float* __restrict__ part, int heads,
                                  int mode, int vec) {
  const long long q =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (q >= pc.n_slots) return;
  const int lane = threadIdx.x % G;
  const MultiPiece mp = multi_piece(pc, segptr, static_cast<int>(q));
  const bool softmax = mode == kSoftmax;
  size_t at[R];
  bool ok[R];
  member_rows<G, R>(perm, mp.start, mp.end, lane, heads, at, ok);
  for (int h0 = 0; h0 < heads; h0 += HP) {
    const int nh = min(HP, heads - h0);
    // the piece's members first: their loads overlap the merge's
    float o[R][HP], gg[R][HP];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fill(o[r], 0.0f);
      fill(gg[r], 0.0f);
      if (ok[r]) {
        load_heads(out + at[r] + h0, nh, vec, o[r]);
        load_heads(g + at[r] + h0, nh, vec, gg[r]);
      }
    }
    float dot[HP], dn[HP], a[kMergeBatch][HP];
    fill(dot, 0.0f);
    // the pieces' sums in piece order
    for (int i0 = 0; i0 < mp.count; i0 += kMergeBatch) {
      load_rows(part + static_cast<size_t>(mp.first) * heads + h0,
                static_cast<size_t>(heads), i0, mp.count, nh, vec, 0.0f, a);
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        if (i0 + i >= mp.count) break;
#pragma unroll
        for (int h = 0; h < HP; ++h) dot[h] += a[i][h];
      }
    }
    fill(dn, 1.0f);
    if (!softmax) {
      load_heads(den + static_cast<size_t>(mp.seg) * heads + h0, nh, vec, dn);
#pragma unroll
      for (int h = 0; h < HP; ++h) dn[h] += kEps;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!ok[r]) continue;
      float d[HP];
      bwd_heads(o[r], gg[r], dot, dn, softmax, d);
      store_heads(ds + at[r] + h0, nh, vec, d);
    }
  }
}

// What a launch reads and writes, beside its pieces: K3 reads a and writes
// x (out) and y (den); K4 reads a (out), b (g) and y (den) and writes x
// (ds)
struct SegArgs {
  const int *segptr, *perm;
  const float *a, *b;
  float *x, *y, *part;
  int n_segs, capacity, heads, mode, vec;
};

template <int G>
int blocks_for(long long groups) {
  const long long threads = groups * G;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <int G, int R, int HP>
cudaError_t launch_norm(const Pieces& pc, const SegArgs& a, bool bwd,
                        cudaStream_t st) {
  // at least one block: it writes the padding
  const int blocks = blocks_for<G>(pc.n_pieces > 0 ? pc.n_pieces : 1);
  if (bwd)
    segment_norm_bwd_kernel<G, R, HP><<<blocks, kThreads, 0, st>>>(
        pc, a.segptr, a.perm, a.a, a.b, a.y, a.x, a.part, a.n_segs,
        a.capacity, a.heads, a.mode, a.vec);
  else
    segment_norm_kernel<G, R, HP><<<blocks, kThreads, 0, st>>>(
        pc, a.segptr, a.perm, a.a, a.x, a.y, a.part, a.n_segs, a.capacity,
        a.heads, a.mode, a.vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pc.n_slots == 0) return err;
  if (bwd)
    segment_norm_bwd_merge_kernel<G, R, HP>
        <<<blocks_for<G>(pc.n_slots), kThreads, 0, st>>>(
            pc, a.segptr, a.perm, a.a, a.b, a.y, a.x, a.part, a.heads,
            a.mode, a.vec);
  else
    segment_norm_merge_kernel<G, R, HP>
        <<<blocks_for<G>(pc.n_slots), kThreads, 0, st>>>(
            pc, a.segptr, a.perm, a.a, a.x, a.y, a.part, a.heads, a.mode,
            a.vec);
  return cudaGetLastError();
}

template <int G, int R>
cudaError_t launch_hp(const Pieces& pc, const SegArgs& a, bool bwd,
                      cudaStream_t st) {
  int hp = 1;
  while (hp < a.heads && hp < kMaxHeadsPerPass) hp *= 2;
  switch (hp) {
    case 1: return launch_norm<G, R, 1>(pc, a, bwd, st);
    case 2: return launch_norm<G, R, 2>(pc, a, bwd, st);
    case 4: return launch_norm<G, R, 4>(pc, a, bwd, st);
    default: return launch_norm<G, R, 8>(pc, a, bwd, st);
  }
}

// The (G, P, V) built: G = 4, 8, 16 or 32 lanes over pieces of P = 32
// members, or G = 8, 16 or 32 over pieces of 64 (R = P / G at most
// kMaxMembers); V = 1, 2 or 4 floats dividing H and at most the heads of a
// pass, every table on a V-float boundary; part must exist where segments
// have several pieces
cudaError_t launch(int lanes, const Pieces& pc, const SegArgs& a, bool bwd,
                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  int hp = 1;
  while (hp < a.heads && hp < kMaxHeadsPerPass) hp *= 2;
  const void* tables[] = {a.a, a.b, a.x, a.y, a.part};
  bool aligned = true;
  for (const void* t : tables)
    aligned = aligned && reinterpret_cast<uintptr_t>(t) % (4 * a.vec) == 0;
  if (a.heads <= 0 || (a.vec != 1 && a.vec != 2 && a.vec != 4)
      || a.heads % a.vec != 0 || a.vec > hp || !aligned
      || (pc.n_slots > 0 && a.part == nullptr))
    return cudaErrorInvalidValue;
#define GNPDE_SEG_GP(G, P)                                     \
  if (lanes == G && pc.piece == P)                             \
    return launch_hp<G, P / G>(pc, a, bwd, st);
  GNPDE_SEG_GP(4, 32)
  GNPDE_SEG_GP(8, 32)
  GNPDE_SEG_GP(16, 32)
  GNPDE_SEG_GP(32, 32)
  GNPDE_SEG_GP(8, 64)
  GNPDE_SEG_GP(16, 64)
  GNPDE_SEG_GP(32, 64)
#undef GNPDE_SEG_GP
  return cudaErrorInvalidValue;
}

Pieces make_pieces(const void* piece_ptr, const void* piece_seg,
                   const void* piece_slot, const void* multi_piece,
                   int n_pieces, int n_slots, int piece) {
  return {static_cast<const int*>(piece_ptr),
          static_cast<const int*>(piece_seg),
          static_cast<const int*>(piece_slot),
          static_cast<const int*>(multi_piece), n_pieces, n_slots, piece};
}

}  // namespace

// K3 over the segments' pieces of at most piece members piece_ptr,
// piece_seg, piece_slot [n_pieces] and multi_piece [n_slots] (ops/graph.py,
// ColPieces of segptr: Graph.row_segments or Graph.col_segments): out [capacity,
// heads] and den [n_segs, heads] from s [capacity, heads]; part
// [n_slots, 2 * heads] holds the multi-piece segments' partial rows
// (nullable without them). perm is nullable (the rows). lanes: G, vec: V,
// chosen by the wrapper (kernels/lanes.py's segment_design); mode 0
// softmax, 1 normalise.
extern "C" int gnpde_segment_norm(
    const void* piece_ptr, const void* piece_seg, const void* piece_slot,
    const void* multi_piece, const void* segptr, const void* perm,
    const void* s, void* out, void* den, void* part, int n_segs,
    int n_pieces, int n_slots, int piece, int capacity, int heads, int mode,
    int lanes, int vec, void* stream) {
  const Pieces pc = make_pieces(piece_ptr, piece_seg, piece_slot,
                                multi_piece, n_pieces, n_slots, piece);
  const SegArgs a{static_cast<const int*>(segptr),
                  static_cast<const int*>(perm),
                  static_cast<const float*>(s),
                  nullptr,
                  static_cast<float*>(out),
                  static_cast<float*>(den),
                  static_cast<float*>(part),
                  n_segs,
                  capacity,
                  heads,
                  mode,
                  vec};
  return static_cast<int>(launch(lanes, pc, a, false, stream));
}

// K4 over the same pieces: ds [capacity, heads] from out, g [capacity,
// heads] and den [n_segs, heads]; part [n_slots, heads] (nullable without
// multi-piece segments).
extern "C" int gnpde_segment_norm_bwd(
    const void* piece_ptr, const void* piece_seg, const void* piece_slot,
    const void* multi_piece, const void* segptr, const void* perm,
    const void* out, const void* g, const void* den, void* ds, void* part,
    int n_segs, int n_pieces, int n_slots, int piece, int capacity,
    int heads, int mode, int lanes, int vec, void* stream) {
  const Pieces pc = make_pieces(piece_ptr, piece_seg, piece_slot,
                                multi_piece, n_pieces, n_slots, piece);
  const SegArgs a{static_cast<const int*>(segptr),
                  static_cast<const int*>(perm),
                  static_cast<const float*>(out),
                  static_cast<const float*>(g),
                  static_cast<float*>(ds),
                  const_cast<float*>(static_cast<const float*>(den)),
                  static_cast<float*>(part),
                  n_segs,
                  capacity,
                  heads,
                  mode,
                  vec};
  return static_cast<int>(launch(lanes, pc, a, true, stream));
}
