// K18 fused_aggregate and K8's per-head mode fused_rhs_bwd_heads for the
// four score families whose scores need each edge's key (cosine_sim,
// pearson, exp_kernel, exp_kernel_beltrami): the GRAND-nl attention
// right-hand side's numerators and denominators over a per-EDGE payload
// x_g [n_slots, D] (row-sorted, edge e at row e) instead of x[col], and its
// backward from per-head cotangents. Replace the TPU kernels of
// graph_neural_pde_tpu/ops/pallas/fused_rhs.py: _rhs_kernel / _fused_call
// (K18) and _bwd_kernel's non-separable branch / _fused_bwd_mega_call with
// recip_p=None (the backward of fused_rhs_aggregate). Kept apart from
// fused_rhs.cu (K6-K9, K17), whose walks over node tables they share only
// fused_common.cuh with, so that the two compile side by side. For the
// scaled-dot score K18 and the per-head mode run payload_fwd.cu /
// payload_bwd.cu instead (Kw folded into each row's query: no edge's key),
// and so does K19 fused_score_max.
//
// Both take the payload's bfloat16 mode too (the JAX package's _fused_call
// / _fused_bwd_mega_call over a bfloat16 x_g): the payload rows of type TX
// are widened to float32 where they are read, and k_e is projected from
// the widened row with the float32 Kw and kb and is not rounded, as every
// route of the JAX package computes it there. Every cotangent, sum and
// output stays float32; the per-head mode's dKw is reduced over the
// bfloat16 payload.
//
// K18 (payload_keys_kernel). What bounds it on the H100: at arxiv scale
// (2.47 M edges, D = 128, BLEND's ATT = 2 x 32) the payload is 1.26 GB
// (0.38 ms at 3.35 TB/s), and projecting every edge's key takes 2 E D ATT
// = 40 GFLOP, 121 GFLOP of TF32 products as 3xTF32: on the SIMT float32
// pipes (67 TFLOP/s) the projection alone would take 0.6 ms, so it runs
// on the tensor cores. The design:
// * The blocks, one wave of them, each take a window of consecutive row
//   pieces (Graph.scatter_pieces: rows of up to SCATTER_WHOLE edges whole,
//   longer ones in pieces of COL_PIECE): block b the pieces that start in
//   edges [b W, (b + 1) W), W the edges over the blocks (a warp's search
//   over the pieces' starts), so that its edges are contiguous, about W.
// * Once a block, Kw is split into its high and low TF32 parts (dense.cuh's
//   tf32_split) and kept in shared memory in the order of the m16n8k8
//   B fragments: one 16-byte load gives a lane both parts of its fragment.
// * The window's payload rows are staged in shared memory by cp.async, a
//   tile of up to CAP rows (kernels/fused_rhs.py's key_design) after
//   another, the next tile's (and its edges' row numbers) arriving in a
//   second buffer while one is used; q's rows of a tile are prefetched
//   into L1 before its keys are formed. The tile's keys K = X Kw + kb are
//   3xTF32 products
//   on the tensor cores (a bfloat16 row is a TF32 value already: two
//   products), two k8 steps a partial sum added to the sum started from
//   kb, as dense.cuh's node projections do; the keys go to shared memory.
// * A thread an (edge, head) pair scores it from the key tile and q_n
//   (the node projections' table) with head_score, the families'
//   arithmetic unchanged, and forms u.
// * A thread a column h D + d of num (and, at d = 0, den's column h)
//   walks the tile's edges in order, adding u_eh x_g[e, d] (and u_eh) from
//   the staged rows, and writes each piece's sums when the piece ends: to
//   the row, or, for a row of several pieces, to the piece's partial row,
//   which a merge kernel adds in piece order. A piece that runs past the
//   tile carries its sums to the next.
// So x_g is read from device memory once, every sum runs in edge order,
// and nothing is zeroed first: two launches agree bit for bit.
//
// K8's per-head mode (fused_rhs_bwd_heads_kernel): a warp owns a row and
// takes its edges kGroup at a time:
//   * it loads the group's payload rows with kGroup loads in flight a lane
//     (a row's edges are contiguous, so each load is coalesced) into shared
//     memory, transposed ([D, kGroup]);
//   * it projects the group's keys at once (group_project), so that each
//     element of Kw read from shared memory serves kGroup products;
//   * lane l scores the pair (edge l / H, head l % H) of the group, so all
//     kGroup H scores run side by side;
//   * it forms each edge's dk and then the group's dk Kw^T as one more
//     group product.
// The block (kPayloadWarps warps) stages Qw and Kw in shared memory first,
// each row padded by one float, so that a column can be read without bank
// conflicts too; q_n = x_n Qw + qb is projected by the warp that owns row
// n. Every sum runs in a fixed order: no atomics.

#include "fused_common.cuh"
#include "piece_merge.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kPayloadWarps = 8;
static_assert(kGroup == 8, "load_group packs a group as two float4");

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// out[i * out_stride + o] = b[o] + sum_k xs[k * G + i] w[k * w_k + o * w_o]
// for i < count, o < n_out: xs holds G rows of n_in floats transposed
// (16-byte aligned), w is a matrix in shared memory read through its two
// strides, lanes span o with J accumulators a lane and row. b may be null.
template <int G, int J>
__device__ __forceinline__ void group_project_j(
    const float* xs, const float* w, int w_k, int w_o,
    const float* __restrict__ b, int n_in, int n_out, int lane, int count,
    float* out, int out_stride) {
  float acc[G][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = lane + kWarp * j;
    const float bias = (b != nullptr && o < n_out) ? __ldg(b + o) : 0.0f;
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i][j] = bias;
  }
  for (int k = 0; k < n_in; ++k) {
    float xv[G];
    if constexpr (G % 4 == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xs + k * G);
#pragma unroll
      for (int i = 0; i < G / 4; ++i) {
        const float4 v = x4[i];
        xv[4 * i] = v.x;
        xv[4 * i + 1] = v.y;
        xv[4 * i + 2] = v.z;
        xv[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) xv[i] = xs[k * G + i];
    }
    const float* wr = w + k * w_k + lane * w_o;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float wv = lane + kWarp * j < n_out ? wr[kWarp * j * w_o] : 0.0f;
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i >= count) break;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int o = lane + kWarp * j;
      if (o < n_out) out[i * out_stride + o] = acc[i][j];
    }
  }
  __syncwarp();
}

template <int G>
__device__ __forceinline__ void group_project(const float* xs, const float* w,
                                              int w_k, int w_o, const float* b,
                                              int n_in, int n_out, int lane,
                                              int count, float* out,
                                              int out_stride) {
#define GNPDE_GROUP_PROJECT(J)                                              \
  group_project_j<G, J>(xs, w, w_k, w_o, b, n_in, n_out, lane, count, out, \
                        out_stride)
  switch ((n_out + kWarp - 1) / kWarp) {
    case 1: GNPDE_GROUP_PROJECT(1); break;
    case 2: GNPDE_GROUP_PROJECT(2); break;
    case 3: GNPDE_GROUP_PROJECT(3); break;
    case 4: GNPDE_GROUP_PROJECT(4); break;
    case 5: GNPDE_GROUP_PROJECT(5); break;
    case 6: GNPDE_GROUP_PROJECT(6); break;
    case 7: GNPDE_GROUP_PROJECT(7); break;
    default: GNPDE_GROUP_PROJECT(8); break;
  }
#undef GNPDE_GROUP_PROJECT
}

// ws[d (att + 1) + a] = w[d, a] (and ws2 from w2, when given): the block's
// copy of [dim, att] weights, each row padded by one float
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              const float* __restrict__ w2,
                                              float* ws, float* ws2, int dim,
                                              int att) {
  for (int i = threadIdx.x; i < dim * att; i += blockDim.x) {
    const int at = (i / att) * (att + 1) + i % att;
    ws[at] = w[i];
    if (w2 != nullptr) ws2[at] = w2[i];
  }
  __syncthreads();
}

// one payload element through the read-only path, widened to float32
__device__ __forceinline__ float load_widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_widen(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// payload rows [e0, e0 + count) of type TX into xs [dim, kGroup], widened
// to float32 and transposed, the columns past count 0
template <typename TX>
__device__ __forceinline__ void load_group(const TX* __restrict__ xg,
                                           int e0, int count, int dim,
                                           int lane, float* xs) {
  for (int d = lane; d < dim; d += kWarp) {
    float v[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      v[i] = i < count
                 ? load_widen(xg + static_cast<size_t>(e0 + i) * dim + d)
                 : 0.0f;
    float4* dst = reinterpret_cast<float4*>(xs + d * kGroup);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncwarp();
}

// Floats of shared memory: the block's weights, and each warp's slice (a
// multiple of 4 floats, so that every warp's xs stays 16-byte aligned).
// kernels/fused_rhs.py checks the same sums against the device's limit.
__host__ __device__ __forceinline__ int padded_weight_floats(int d, int a) {
  return round4(d * (a + 1));
}
__host__ __device__ __forceinline__ int bwd_heads_warp_floats(int d, int a,
                                                              int h) {
  return round4(kGroup * d + a * kGroup + 2 * a + kGroup * (a + 1) +
                h * (d + 1) + kGroup * kCoef * h + 2 * kGroup * h);
}

// ---------------------------------------------------------------------- K18
//
// num[n, h D + d] = sum_e u_eh x_g[e, d] and den[n, h] = sum_e u_eh over
// the edges e of row n, u_eh = exp(s_eh - gmax - shift_eh) (or
// squareplus), s_eh the score of q_n and k_e = x_g[e] Kw + kb; each sum in
// the row's edge order (see the note at the top for the design).

constexpr int kKeyThreads = 256;
constexpr int kKeyWarps = kKeyThreads / kWarp;
constexpr int kKeyGroup = 2;                  // n8 tiles a warp's item

// What the walk reads and writes. The pieces are fused_common.cuh's
// (`col` the piece's row, `multi_col` the rows of several pieces).
struct KeyArgs {
  Pieces pc;
  Proj p;
  const int* row;          // [n_slots]: each edge's row
  const void* xg;          // [n_slots, dim] of T
  const float* q;          // [n_rows, att]: x_n Qw + qb
  const float* kw;         // [dim, att]
  const float* kb;         // [att]
  const float* shifts;     // [n_slots, heads], nullable
  float* num;              // [n_rows, heads dim]
  float* den;              // [n_rows, heads]
  float* part;             // [partial rows, stride]: [num | den] a piece
  int cap, window, stride, vec;
};

// The block's shared memory, in bytes: the split Kw in fragment order, two
// buffers of CAP staged payload rows of xs elements (16 bytes past a
// multiple of 128, so that a warp's A-fragment loads fall in 32 banks) and
// of their edges' rows (the next tile's arrive while one is used), CAP
// keys of a8 + 1 floats, CAP edges' u, the carried sums of [num | den]
// (stride floats) and the window's two piece bounds.
// kernels/fused_rhs.py's key_shared sums the same.
struct KeyLayout {
  int d8, a8, xs, ks, w, x, rows, k, u, carry, total;
};

__host__ __device__ __forceinline__ KeyLayout key_layout(int dim, int att,
                                                         int heads, int cap,
                                                         int elem) {
  KeyLayout l;
  l.d8 = (dim + 7) / 8 * 8;
  l.a8 = (att + 7) / 8 * 8;
  const int align = 128 / elem;
  l.xs = (dim + align - 1) / align * align + 16 / elem;
  l.ks = l.a8 + 1;
  l.w = 8 * l.d8 * l.a8;
  l.x = l.w;                                  // two buffers each
  l.rows = l.x + 2 * cap * l.xs * elem;
  l.k = l.rows + 2 * 4 * cap;
  l.u = l.k + 4 * cap * l.ks;
  l.carry = l.u + 4 * cap * heads;
  l.total = l.carry + 4 * payload_stride(dim, heads) + 16;
  return l;
}

// Kw's high and low TF32 parts for B fragment (k8 step ks, n8 tile nt) of
// lane (g, t) at wf[(ks n_tiles + nt) 32 + lane] = (hi of Kw[8 ks + t, 8 nt
// + g], hi of Kw[8 ks + t + 4, ..], lo of the same two); zero past D, ATT
__device__ __forceinline__ void split_weights(const float* __restrict__ kw,
                                              int dim, int att,
                                              const KeyLayout& l,
                                              uint4* wf) {
  const int n_tiles = l.a8 / 8, frags = (l.d8 / 8) * n_tiles * 32;
  for (int i = threadIdx.x; i < frags; i += kKeyThreads) {
    const int lane = i % 32, f = i / 32;
    const int ks = f / n_tiles, nt = f % n_tiles;
    const int c = 8 * nt + lane / 4, k = 8 * ks + lane % 4;
    const float w0 = k < dim && c < att ? kw[static_cast<size_t>(k) * att + c]
                                        : 0.0f;
    const float w1 = k + 4 < dim && c < att
                         ? kw[static_cast<size_t>(k + 4) * att + c]
                         : 0.0f;
    uint32_t h0, s0, h1, s1;
    tf32_split(w0, &h0, &s0);
    tf32_split(w1, &h1, &s1);
    wf[i] = make_uint4(h0, h1, s0, s1);
  }
}

// The first piece of [0, n) whose start is at least `target` (n: none),
// by the 32 lanes of a warp: each round samples 32 starts of the range
// left, so a few rounds of loads in series find it
__device__ __forceinline__ int first_piece_from(const int* __restrict__ ptr,
                                                int n, int target,
                                                int lane) {
  int lo = 0, hi = n;               // the starts before lo are < target,
  while (hi - lo > 32) {            // those from hi on are not
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const bool below = i < hi && __ldg(ptr + i) < target;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) return lo;
    const int next = lo + c * step;
    lo = lo + (c - 1) * step + 1;
    hi = min(hi, next);
  }
  const bool below = lo + lane < hi && __ldg(ptr + lo + lane) < target;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// the payload rows [s0, s0 + cnt) into xs (rows of l.xs elements; columns
// past dim were zeroed once) and their edges' rows into rows: 16-byte
// cp.async copies where `vec` (else plain loads), one group committed and
// not waited for
template <typename T>
__device__ __forceinline__ void stage_rows(const KeyArgs& a,
                                           const KeyLayout& l, T* xs,
                                           int* rows, int s0, int cnt) {
  const T* xg = static_cast<const T*>(a.xg);
  const int dim = a.p.dim;
  for (int i = threadIdx.x; i < cnt; i += kKeyThreads)
    cp_async4(rows + i, a.row + s0 + i);
  if (a.vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = dim / kPer;
    for (int i = threadIdx.x; i < cnt * chunks; i += kKeyThreads) {
      const int r = i / chunks, c = (i % chunks) * kPer;
      cp_async16(xs + r * l.xs + c,
                 xg + static_cast<size_t>(s0 + r) * dim + c);
    }
  } else {
    for (int i = threadIdx.x; i < cnt * dim; i += kKeyThreads) {
      const int r = i / dim, c = i % dim;
      xs[r * l.xs + c] = xg[static_cast<size_t>(s0 + r) * dim + c];
    }
  }
  cp_async_commit();
}

// q's rows of the tile's edges into the SM's L1 (the scores read them
// after the keys' products): a row where it differs from the edge before
__device__ __forceinline__ void prefetch_q(const KeyArgs& a,
                                           const int* rows, int cnt) {
  const int bytes = 4 * a.p.att;
  for (int i = threadIdx.x; i < cnt; i += kKeyThreads) {
    if (i > 0 && rows[i] == rows[i - 1]) continue;
    const char* p = reinterpret_cast<const char*>(
        a.q + static_cast<size_t>(rows[i]) * a.p.att);
    for (int off = 0; off < bytes; off += 128)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(p + off));
  }
}

// the keys of the tile's cnt rows: items of one m16 tile by kKeyGroup n8
// tiles on the warps, two k8 steps a partial sum (each mma.sync rounds its
// sum toward zero: dense.cuh's project_mma) in two chains, big x big and
// the small terms, added to the sum started from kb
template <typename T>
__device__ __forceinline__ void project_keys(const KeyArgs& a,
                                             const KeyLayout& l, const T* xs,
                                             const uint4* wf, float* kt,
                                             int cnt) {
  constexpr bool kExact = sizeof(T) == 2;     // bfloat16 rows: TF32 values
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = l.a8 / 8, steps = l.d8 / 8;
  const int groups = (n_tiles + kKeyGroup - 1) / kKeyGroup;
  const int items = (cnt + 15) / 16 * groups;
  for (int item = warp; item < items; item += kKeyWarps) {
    const int m0 = item / groups * 16, n0 = item % groups * kKeyGroup;
    float acc[kKeyGroup][4];
#pragma unroll
    for (int j = 0; j < kKeyGroup; ++j) {
      const int c = 8 * (n0 + j) + 2 * t;
      const float b0 = c < a.p.att ? __ldg(a.kb + c) : 0.0f;
      const float b1 = c + 1 < a.p.att ? __ldg(a.kb + c + 1) : 0.0f;
      acc[j][0] = acc[j][2] = b0;
      acc[j][1] = acc[j][3] = b1;
    }
    const T* x0 = xs + (m0 + g) * l.xs + t;
    const T* x1 = x0 + 8 * l.xs;
    for (int k0 = 0; k0 < steps; k0 += 2) {
      float big[kKeyGroup][4], small[kKeyGroup][4];
#pragma unroll
      for (int j = 0; j < kKeyGroup; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = k0 + kk;
        if (ks >= steps) break;
        const float xv[4] = {widen(x0[8 * ks]), widen(x1[8 * ks]),
                             widen(x0[8 * ks + 4]), widen(x1[8 * ks + 4])};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kExact) {
            ab[i] = __float_as_uint(xv[i]);
            as[i] = 0u;
          } else {
            tf32_split(xv[i], &ab[i], &as[i]);
          }
        }
#pragma unroll
        for (int j = 0; j < kKeyGroup; ++j) {
          if (n0 + j >= n_tiles) break;
          const uint4 w = wf[(ks * n_tiles + n0 + j) * 32 + lane];
          const uint32_t bb[2] = {w.x, w.y}, bs[2] = {w.z, w.w};
          if (!kExact) mma_tf32(small[j], as, bb);
          mma_tf32(small[j], ab, bs);
          mma_tf32(big[j], ab, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < kKeyGroup; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += big[j][e] + small[j][e];
    }
#pragma unroll
    for (int j = 0; j < kKeyGroup; ++j) {
      if (n0 + j >= n_tiles) break;
      float* o = kt + (m0 + g) * l.ks + 8 * (n0 + j) + 2 * t;
      o[0] = acc[j][0];
      o[1] = acc[j][1];
      o[8 * l.ks] = acc[j][2];
      o[8 * l.ks + 1] = acc[j][3];
    }
  }
}

// column c of piece q's [num | den] sums to its row, or to its partial row
__device__ __forceinline__ void flush_piece(const KeyArgs& a, int q, int c,
                                            float v) {
  const int slot = __ldg(a.pc.slot + q);
  const int hd = a.p.heads * a.p.dim;
  if (slot >= 0) {
    a.part[static_cast<size_t>(slot) * a.stride + c] = v;
  } else {
    const size_t row = __ldg(a.pc.col + q);
    if (c < hd)
      a.num[row * hd + c] = v;
    else
      a.den[row * a.p.heads + (c - hd)] = v;
  }
}

// The walk of the block's window of row pieces (the note at the top) over
// a payload of type T: each tile of staged payload rows [s0, s0 + cnt) at
// x gets its keys from form_keys(x, s0, cnt), which writes them to the
// key tile (l.k) before the block's next barrier
template <typename T, typename FormKeys>
__device__ __forceinline__ void walk_window(const KeyArgs& a,
                                            const KeyLayout& l,
                                            unsigned char* smem,
                                            FormKeys form_keys) {
  const int D = a.p.dim, A = a.p.att, H = a.p.heads;
  const int d_k = head_width(a.p), hd = H * D;
  T* xs = reinterpret_cast<T*>(smem + l.x);
  int* rows = reinterpret_cast<int*>(smem + l.rows);
  const float* kt = reinterpret_cast<const float*>(smem + l.k);
  float* ut = reinterpret_cast<float*>(smem + l.u);
  float* carry = reinterpret_cast<float*>(smem + l.carry);
  int* bounds = reinterpret_cast<int*>(smem + l.carry +
                                       4 * payload_stride(D, H));
  for (int i = threadIdx.x; i < 2 * a.cap * l.xs; i += kKeyThreads)
    xs[i] = dense_zero<T>();                  // the columns past D stay 0
  const float gmax = __ldg(a.p.gmax);
  const ScoreParams sc = score_params(a.p);
  const int* ptr = a.pc.ptr;
  const int n_pieces = a.pc.n_pieces;
  // the block's window: the pieces that start in edges [b W, (b + 1) W)
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const int p0 = first_piece_from(ptr, n_pieces, b * a.window, lane);
    const int p1 = b + 1 == gridDim.x
                       ? n_pieces
                       : first_piece_from(ptr, n_pieces, (b + 1) * a.window,
                                          lane);
    if (lane == 0) {
      bounds[0] = p0;
      bounds[1] = p1;
    }
  }
  __syncthreads();                            // also: the weights, zeros
  const int p0 = bounds[0], p1 = bounds[1];
  if (p0 >= p1) return;                       // the same for the block
  const int e_end = __ldg(ptr + p1);
  int s0 = __ldg(ptr + p0), first = p0;       // the tile's first open piece
  bool carried = false;                       // it began in an earlier tile
  int buf = 0;                                // the tile's row buffer
  const int tile = a.cap * l.xs;
  stage_rows<T>(a, l, xs, rows, s0, min(a.cap, e_end - s0));
  do {
    const int cnt = min(a.cap, e_end - s0);
    const int s_end = s0 + cnt;
    const bool last = s_end >= e_end;
    const T* x = xs + buf * tile;
    const int* erow = rows + buf * a.cap;
    // the next tile's rows arrive in the other buffers meanwhile
    if (!last)
      stage_rows<T>(a, l, xs + (buf ^ 1) * tile, rows + (buf ^ 1) * a.cap,
                    s_end, min(a.cap, e_end - s_end));
    else
      cp_async_commit();
    cp_async_wait<1>();                       // this tile's rows
    if (cnt > 0) {
      __syncthreads();
      prefetch_q(a, erow, cnt);
      form_keys(x, s0, cnt);
      __syncthreads();
      for (int i = threadIdx.x; i < cnt * H; i += kKeyThreads) {
        const int e = i / H, h = i % H;
        const int row = erow[e];
        const HeadScore hs =
            head_score(a.q + static_cast<size_t>(row) * A, kt + e * l.ks, h,
                       d_k, H, a.p.score, sc);
        float sm = hs.s - gmax;
        if (a.shifts)
          sm -= __ldg(a.shifts + static_cast<size_t>(s0 + e) * H + h);
        float u, duds;
        u_duds(sm, a.p.square_plus, &u, &duds);
        ut[i] = u;
      }
      __syncthreads();
    }
    // a thread a column h D + d of num (and, where d = 0, den's column of
    // head h beside it) walks the tile's edges in order, piece by piece: a
    // piece that ends in the tile is written, one that runs past it
    // carries its sums to the next tile
    for (int c = threadIdx.x; c < hd; c += kKeyThreads) {
      const int h = c / D, d = c % D;
      float acc = carried ? carry[c] : 0.0f;
      float dacc = carried ? carry[hd + h] : 0.0f;
      int q = first, e = 0;
      for (;;) {
        const int q_end = __ldg(ptr + q + 1);
        const int stop = min(q_end, s_end) - s0;
#pragma unroll 4
        for (; e < stop; ++e) {
          const float u = ut[e * H + h];
          acc = fmaf(u, widen(x[e * l.xs + d]), acc);
          dacc += u;
        }
        if (q_end > s_end) {                  // on into the next tile
          carry[c] = acc;
          if (d == 0) carry[hd + h] = dacc;
          break;
        }
        flush_piece(a, q, c, acc);
        if (d == 0) flush_piece(a, q, hd + h, dacc);
        acc = dacc = 0.0f;
        if (++q >= p1) break;                 // the window's last piece
      }
    }
    if (!last) {
      while (__ldg(ptr + first + 1) <= s_end) ++first;
      carried = __ldg(ptr + first) < s_end;
    }
    s0 = s_end;
    buf ^= 1;
    __syncthreads();                          // the tiles are reused
  } while (s0 < e_end);
  cp_async_wait<0>();
}

// K18 for the key families over windows of row pieces (the note at the
// top): Kw's TF32 parts split into shared memory once, then the window's
// walk with each tile's keys projected on the tensor cores; T the
// payload's type
template <typename T>
__global__ void __launch_bounds__(kKeyThreads, 2)
payload_keys_kernel(KeyArgs a) {
  extern __shared__ __align__(16) unsigned char key_smem[];
  const KeyLayout l =
      key_layout(a.p.dim, a.p.att, a.p.heads, a.cap, sizeof(T));
  const uint4* wf = reinterpret_cast<const uint4*>(key_smem);
  float* kt = reinterpret_cast<float*>(key_smem + l.k);
  split_weights(a.kw, a.p.dim, a.p.att, l, reinterpret_cast<uint4*>(key_smem));
  walk_window<T>(a, l, key_smem, [&](const T* x, int, int cnt) {
    project_keys<T>(a, l, x, wf, kt, cnt);
  });
}

// The second pass over the rows of several pieces (merge_partials)
__global__ void __launch_bounds__(kMergeThreads)
payload_keys_merge_kernel(
    Pieces pc, const float* __restrict__ part, int stride, int width,
    float* __restrict__ out_a, int width_a, float* __restrict__ out_b) {
  merge_partials(pc.multi_ptr, pc.multi_col, pc.n_multi, part, stride,
                 width, out_a, width_a, out_b);
}

// One wave of resident blocks (by the block's shared memory and
// registers), at most one a tile of edges; block b walks the pieces that
// start in edges [b W, (b + 1) W), W the edges over the blocks
template <typename T>
cudaError_t launch_keys(const KeyArgs& a, int n_edges, cudaStream_t s) {
  const int D = a.p.dim, H = a.p.heads;
  const KeyLayout l = key_layout(D, a.p.att, H, a.cap, sizeof(T));
  auto kernel = payload_keys_kernel<T>;
  cudaError_t err = allow_shared(kernel, l.total);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kKeyThreads, l.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(per_sm * dense_sms(), max(1, (n_edges + a.cap - 1) /
                                                        a.cap));
  KeyArgs b = a;
  b.window = max(1, (n_edges + grid - 1) / grid);
  kernel<<<grid, kKeyThreads, l.total, s>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(payload_keys_merge_kernel, a.pc, a.part, a.stride,
               H * (D + 1), a.num, H * D, a.den, s);
}

// ------------------------------------------------------- K8, per-head mode
//
// The backward of K18 from the per-head cotangents ct_num [N, H D] and
// ct_den [N, H]: for each edge e of row n,
//     du_eh  = <ct_num[n, h], x_g[e]> + ct_den[n, h],  ds_eh = du_eh du/ds,
//     dq[n] += ds . ds/dq,  dk_e = ds . ds/dk,
//     dxg[e] = sum_h u_eh ct_num[n, h] + dk_e Kw^T,
// each row's sums of ds and of the score scalars' terms into row_sums, and
// each edge's dk_e into dke_out, from which outer_reduce_kernel forms dKw =
// sum_e x_g[e]^T dk_e and dKb as K8 does. Per group: the keys and the dots
// <ct_num[n, h], x_g[e]> as two group products, the (edge, head) pairs'
// scores and derivatives in parallel lanes, dq and dk edge by edge, and
// dk Kw^T as a third group product. The node rows x_n of type TR, the
// payload of type TX.
template <typename TR, typename TX>
__global__ void __launch_bounds__(kPayloadWarps * kWarp, 2)
fused_rhs_bwd_heads_kernel(
    Graph g, Proj p, const TR* __restrict__ xn, const TX* __restrict__ xg,
    const float* __restrict__ qw, const float* __restrict__ qb,
    const float* __restrict__ kw, const float* __restrict__ kb,
    const float* __restrict__ ct_num, const float* __restrict__ ct_den,
    float* __restrict__ dq,
    float* __restrict__ dxg, float* __restrict__ dke_out,
    float* __restrict__ row_sums) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, A = p.att, H = p.heads, d_k = head_width(p);
  const int wsk = A + 1, ks = A + 1, cs = D + 1;    // padded row strides
  const int cf = kCoef * H;                         // coef floats an edge
  float* qw_s = smem;
  float* kw_s = qw_s + padded_weight_floats(D, A);
  stage_weights(qw, kw, qw_s, kw_s, D, A);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kPayloadWarps + warp;
  if (n >= g.n_rows) return;                    // after the block's barrier
  float* xs = kw_s + padded_weight_floats(D, A) +
              static_cast<size_t>(warp) * bwd_heads_warp_floats(D, A, H);
  float* dkt = xs + kGroup * D;                 // the group's dk, [A, kGroup]
  float* q = dkt + A * kGroup;
  float* dqa = q + A;                           // dq[n] accumulator
  float* ke = dqa + A;                          // [kGroup, A + 1]
  float* ctn = ke + kGroup * ks;                // ct_num[n], [H, D + 1]
  float* coef = ctn + H * cs;                   // [kGroup, H, kCoef]
  float* uu = coef + kGroup * cf;               // [kGroup, H]
  float* dots = uu + kGroup * H;                // [kGroup, H]
  load_row(xn, n, D, lane, xs);
  for (int h = 0; h < H; ++h)
    load_row(ct_num + static_cast<size_t>(n) * H * D, h, D, lane,
             ctn + h * cs);
  for (int a = lane; a < A; a += kWarp) dqa[a] = 0.0f;
  __syncwarp();
  group_project<1>(xs, qw_s, wsk, 1, qb, D, A, lane, 1, q, A);
  const float gmax = *p.gmax;
  const ScoreParams sc = score_params(p);
  const int start = g.rowptr[n], end = g.rowptr[n + 1];
  RowSums sums = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // this lane's pairs
  for (int e0 = start; e0 < end; e0 += kGroup) {
    const int count = min(kGroup, end - e0);
    load_group(xg, e0, count, D, lane, xs);
    group_project<kGroup>(xs, kw_s, wsk, 1, kb, D, A, lane, count, ke, ks);
    group_project<kGroup>(xs, ctn, 1, cs, nullptr, D, H, lane, count, dots,
                          H);
    for (int l = lane; l < count * H; l += kWarp) {
      const int i = l / H, h = l % H;
      const HeadScore hs = head_score(q, ke + i * ks, h, d_k, H, p.score, sc);
      uu[l] = head_backward(hs, hs.s - gmax, p.square_plus, dots[l], 1.0f,
                            ct_den[static_cast<size_t>(n) * H + h], sc,
                            p.score, H, coef + i * cf + 5 * h, &sums);
    }
    __syncwarp();
    for (int i = 0; i < count; ++i) {
      const float* kei = ke + i * ks;
      const float* ci = coef + i * cf;
      float* out = dke_out + static_cast<size_t>(e0 + i) * A;
      for (int a = lane; a < A; a += kWarp) {
        const float* c = ci + 5 * (a / d_k);    // a head or its position half
        const float qq = q[a] - c[3], kk = kei[a] - c[4];
        dqa[a] += c[0] * kk - c[1] * qq;
        const float dk = c[0] * qq - c[2] * kk;
        dkt[a * kGroup + i] = dk;
        out[a] = dk;
      }
    }
    __syncwarp();
    // xs[i D + d] = (dk_i Kw^T)[d]: Kw's column d read along its padded row
    group_project<kGroup>(dkt, kw_s, 1, wsk, nullptr, A, D, lane, count, xs,
                          D);
    for (int i = 0; i < count; ++i) {
      float* xo = dxg + static_cast<size_t>(e0 + i) * D;
      for (int d = lane; d < D; d += kWarp) {
        float v = xs[i * D + d];
        for (int h = 0; h < H; ++h) v = fmaf(uu[i * H + h], ctn[h * cs + d], v);
        xo[d] = v;
      }
    }
    __syncwarp();                               // xs, dkt, coef, uu reused
  }
  for (int a = lane; a < A; a += kWarp)
    dq[static_cast<size_t>(n) * A + a] = dqa[a];
  const float t[kRowSums] = {warp_sum(sums.ds), warp_sum(sums.e0),
                             warp_sum(sums.e1), warp_sum(sums.e2),
                             warp_sum(sums.e3)};
  if (lane == 0) {
    float* r = row_sums + static_cast<size_t>(n) * kRowSums;
    for (int i = 0; i < kRowSums; ++i) r[i] = t[i];
  }
}

int payload_blocks(int n_rows) {
  return (n_rows + kPayloadWarps - 1) / kPayloadWarps;
}

// K8's per-head operands beside the graph, the rows and the weights (see
// gnpde_fused_rhs_bwd_heads)
struct Heads {
  const void *ct_num, *ct_den;
  void *dq, *dxg, *dke, *row_sums, *partials;
  int n_slots, reduce_blocks;
};

// K8's per-head walk over the node rows x of type TR and the payload xg of
// type TX, then the first pass of dKw / dKb over the payload's rows
template <typename TR, typename TX>
cudaError_t launch_bwd_heads(Graph g, Proj p, const void* x, const void* xg,
                             const void* qw, const void* qb, const void* kw,
                             const void* kb, const Heads& b, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (2 * padded_weight_floats(p.dim, p.att) +
                       kPayloadWarps *
                           bwd_heads_warp_floats(p.dim, p.att, p.heads));
  cudaError_t err = allow_shared(fused_rhs_bwd_heads_kernel<TR, TX>, bytes);
  if (err != cudaSuccess) return err;
  fused_rhs_bwd_heads_kernel<TR, TX><<<payload_blocks(g.n_rows),
                                       kPayloadWarps * kWarp, bytes, s>>>(
      g, p, static_cast<const TR*>(x), static_cast<const TX*>(xg),
      static_cast<const float*>(qw), static_cast<const float*>(qb),
      static_cast<const float*>(kw), static_cast<const float*>(kb),
      static_cast<const float*>(b.ct_num), static_cast<const float*>(b.ct_den),
      static_cast<float*>(b.dq), static_cast<float*>(b.dxg),
      static_cast<float*>(b.dke), static_cast<float*>(b.row_sums));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_outer_reduce(static_cast<const TX*>(xg), nullptr,
                      static_cast<const float*>(b.dke),
                      static_cast<float*>(b.partials), b.n_slots,
                      b.reduce_blocks, p.dim, p.att, s);
  return cudaGetLastError();
}

}  // namespace

// K18 for the key families over the row pieces piece_ptr, piece_row,
// piece_slot [n_pieces] and multi_row, multi_ptr [n_multi (+ 1)]
// (ops/graph.py, Graph.scatter_pieces) and the per-edge payload xg
// [n_slots, dim] (float32, or bfloat16: tables 1), row [n_slots] each
// edge's row: num [n_rows, heads dim], den [n_rows, heads]. q [n_rows,
// att] = x_n Qw + qb; kw [dim, att], kb [att]; var, ls, shifts [n_slots,
// heads] nullable; part [multi_ptr[n_multi], S] (S = heads (dim + 1)
// rounded up to a multiple of 4; nullable without multi-piece rows).
// n_edges: the edges the pieces cover (ptr[n_pieces]); cap: payload rows a
// tile (kernels/fused_rhs.py, key_design); vec: dim * the element size a
// multiple of 16 and xg on a 16-byte boundary (cp.async).
extern "C" int gnpde_payload_keys(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* row,
    const void* xg, const void* q, const void* kw, const void* kb,
    const void* gmax, const void* var, const void* ls, const void* shifts,
    void* num, void* den, void* part, int n_rows, int n_pieces,
    int n_multi, int dim, int att, int heads, int flags, int n_edges,
    int cap, int vec, int tables, void* stream) {
  if (n_rows <= 0 || n_pieces <= 0) return static_cast<int>(cudaGetLastError());
  if (dim <= 0 || heads <= 0 || cap <= 0 || cap % 16 != 0 || n_edges < 0 ||
      (tables != 0 && tables != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  KeyArgs a;
  a.pc = {static_cast<const int*>(piece_ptr),
          static_cast<const int*>(piece_row),
          static_cast<const int*>(piece_slot),
          static_cast<const int*>(multi_row),
          static_cast<const int*>(multi_ptr), n_pieces, n_multi};
  a.p = make_proj(gmax, var, ls, dim, att, heads, flags);
  a.row = static_cast<const int*>(row);
  a.xg = xg;
  a.q = static_cast<const float*>(q);
  a.kw = static_cast<const float*>(kw);
  a.kb = static_cast<const float*>(kb);
  a.shifts = static_cast<const float*>(shifts);
  a.num = static_cast<float*>(num);
  a.den = static_cast<float*>(den);
  a.part = static_cast<float*>(part);
  a.cap = cap;
  a.window = 1;                               // set by launch_keys
  a.stride = payload_stride(dim, heads);
  a.vec = vec;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tables == 0
                              ? launch_keys<float>(a, n_edges, s)
                              : launch_keys<__nv_bfloat16>(a, n_edges, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K8's per-head mode over the per-edge payload xg [n_slots, dim], with
// `tables` as K6-K9 take it for the node rows x and the payload: kTablesF32
// both float32, kTablesF32Bf16 x float32 and xg bfloat16, kTablesBf16 both
// bfloat16 (the weights, gmax, every cotangent and every output are
// float32). ct_num [n_rows, heads dim], ct_den [n_rows, heads]. dxg
// [n_slots, dim] and dke [n_slots, att] are zero on entry (padding slots stay 0), row_sums
// [n_rows, 5] is scratch the wrapper reduces, partials [reduce_blocks,
// dim + 1, att] are written whole (dense.cuh's outer_reduce_kernel), and
// dKw is reduced over the payload.
// Nullable: var, ls.
extern "C" int gnpde_fused_rhs_bwd_heads(
    const void* rowptr, const void* xg, const void* x, const void* qw,
    const void* qb, const void* kw, const void* kb, const void* gmax,
    const void* var, const void* ls, const void* ct_num, const void* ct_den,
    void* dq, void* dxg, void* dke, void* row_sums, void* partials,
    int n_rows, int dim, int att, int heads, int flags, int n_slots,
    int reduce_blocks, int tables, void* stream) {
  if (!valid_tables(tables)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Graph g = make_graph(rowptr, nullptr, n_rows);
    const Proj p = make_proj(gmax, var, ls, dim, att, heads, flags);
    const Heads b = {ct_num, ct_den, dq, dxg, dke, row_sums, partials,
                     n_slots, reduce_blocks};
    cudaError_t err;
    if (tables == kTablesF32)
      err = launch_bwd_heads<float, float>(g, p, x, xg, qw, qb, kw, kb, b, s);
    else if (tables == kTablesF32Bf16)
      err = launch_bwd_heads<float, __nv_bfloat16>(g, p, x, xg, qw, qb, kw,
                                                   kb, b, s);
    else
      err = launch_bwd_heads<__nv_bfloat16, __nv_bfloat16>(g, p, x, xg, qw,
                                                           qb, kw, kb, b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
