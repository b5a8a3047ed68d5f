// The dense products around the fused attention kernels (K6-K9, K12-K14,
// K17 and K8's per-head mode): the node projections that fill the q and k
// tables the row walks gather from, and the first pass of the dKw / dKb
// reduction [x | 1]^T dk. The TPU kernels compute both inside their bodies
// (graph_neural_pde_tpu/ops/pallas/fused_rhs.py: q_blk and k_e at 235 and
// 250 in P7, 1403, 1408 and 1463 in P13, 2210 and 2217 in P15; the
// dkw_ref[:] += products at 872 in P11, 1431 in P13, 2377 in P16); here
// each is a launch of its own that the fused entry points run first
// (projections) or last (dKw), and that dense.cu's entry points run alone.
// Each source that includes this header (through fused_common.cuh) gets its
// own copy (anonymous namespace).
//
// What bounds them on the H100: at arxiv scale (169,343 nodes, D = 128,
// ATT = 32) both tables from one read of x move 130 MB and take 2.77
// GFLOP, about 0.04 ms either way; the reduction moves 108 MB for 1.40
// GFLOP. On the card's float32 FMA pipes (67 TFLOP/s) a register-tiled
// SIMT product of these shapes took 0.11-0.13 ms for both tables and
// 0.077 ms for the reduction, no faster than torch.addmm / torch.mm. So
// the float32 products run on the tensor cores as 3xTF32 (each operand
// split into two TF32 values, three mma.sync products: float32 accuracy
// at tensor-core rates); operands are staged in shared memory by 16-byte
// copies (cp.async), GNPDE_*_STAGES deep.
//
// node_project_kernel: over a float32 x of many nodes, a block keeps 64
// columns of the tables side by side ([Qw | Kw] when both project x, so
// that one launch writes both) for all of D in shared memory and walks
// node tiles of 128, 4 x 2 warps of m16 x n8 tiles, the sums started from
// the bias; the column groups of a tile run side by side, so x comes from
// device memory once. Over a few thousand nodes those tiles would leave
// SMs idle, and over a bfloat16 x (the bf16 state; the bfloat16 column
// table's k) the bfloat16 k table sums in float64 (proj_store): there the
// SIMT tile runs, lane (lr, lc) of a warp holding TM nodes x 4 outputs of
// one table's column group, a block one task, the tasks of a node tile
// neighbours in the launch order.
//
// outer_reduce_kernel: split-K over the rows. Each block owns a
// contiguous range of rows (slots or edges; gathered through idx where
// given) and one 128 x NA tile of the [D, ATT] output (NA = 32, or 64
// past ATT = 32), about two blocks an SM in all; the tile is x^T dk on
// the tensor cores, and NA threads of the first row tile also sum dk's
// columns (dKb, the ones row). Rows are staged 32 at a time; each stage's
// sums (12 tensor-core products of 8 terms each, a chain that rounds
// toward zero) are added to the block's total in float32, a chain of rows
// / 32. The block writes every element of its [D + 1, ATT]
// partial tile, and the caller adds the partials in a fixed order, so two
// launches agree bit for bit and no scratch is zeroed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The TABLES code of K6-K9, K12-K14 and K17: 0 float32 (x is also the
// column table), 1 a float32 row side x beside a bfloat16 column table
// xcol, 2 both bfloat16 (the bf16 ODE state: xcol is x).
enum Tables { kTablesF32 = 0, kTablesF32Bf16 = 1, kTablesBf16 = 2 };

bool valid_tables(int tables) {
  return tables == kTablesF32 || tables == kTablesF32Bf16 ||
         tables == kTablesBf16;
}

constexpr int kDenseThreads = 256;               // eight warps a block
constexpr int kDenseWarps = kDenseThreads / 32;

template <typename T> __device__ __forceinline__ T dense_zero();
template <> __device__ __forceinline__ float dense_zero<float>() {
  return 0.0f;
}
template <> __device__ __forceinline__ __nv_bfloat16
dense_zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// four consecutive elements of a staged row, widened (16- or 8-byte load)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// ------------------------------------------------------------------------
// Node projections: out[n] = x[n] W + b for every node.

// How a table entry is summed and stored. float32: x W + b summed in
// float32 from the bias. The bfloat16 k table: the JAX package's two
// roundings of k_e = x[col] @ Kw.astype(bf16) + kb.astype(bf16) in
// bfloat16 (the product rounded, then its sum with the bias), from W and b
// that the wrapper has rounded to bfloat16 already. Its product is summed
// in float64, where the products of bfloat16 values add up exactly at
// these widths, so the rounding to bfloat16 does not depend on the order
// of the sum: the plain version (a float64 matmul) rounds the same sums
// the same way. A float32 sum's own rounding would decide a last bf16 bit
// now and then, and a k off by one bf16 step moves every score it enters.
__device__ __forceinline__ float proj_fma(float x, float w, float acc) {
  return fmaf(x, w, acc);
}
__device__ __forceinline__ double proj_fma(float x, float w, double acc) {
  return fma(static_cast<double>(x), static_cast<double>(w), acc);
}
__device__ __forceinline__ void proj_start(float bias, float* acc) {
  *acc = bias;
}
__device__ __forceinline__ void proj_start(float, double* acc) {
  *acc = 0.0;
}
__device__ __forceinline__ void proj_store(float* out, float acc, float) {
  *out = acc;
}
__device__ __forceinline__ void proj_store(__nv_bfloat16* out, double acc,
                                           float bias) {
  *out = __float2bfloat16_rn(round_bf16(__double2float_rn(acc)) + bias);
}

// The stages of each pipeline (the copies of STAGES - 1 stages in flight
// while one is summed; probes/dense.py builds other depths with -D).
#ifndef GNPDE_PROJ_STAGES
#define GNPDE_PROJ_STAGES 3
#endif
#ifndef GNPDE_REDUCE_STAGES
#define GNPDE_REDUCE_STAGES 3
#endif

constexpr int kProjStages = GNPDE_PROJ_STAGES;
constexpr int kProjDepth = 32;     // columns of x (rows of W) a stage holds
// nodes a lane over a bfloat16 x (its k table sums in float64: twice the
// registers)
constexpr int kBf16TM = 4;
// a float32 x of few nodes (SIMT): the lanes over a column group at most,
// and a stage's depth
constexpr int kSmallLC = 16;
constexpr int kSmallDepth = 128;
constexpr int kProjOut = 4;        // outputs a lane

// a staged row of x: KD elements (the depth of a stage) and 16 bytes of
// padding, so that the rows a warp reads at once start in different banks
template <typename TX, int KD> __host__ __device__ constexpr int proj_row() {
  return KD + 16 / static_cast<int>(sizeof(TX));
}

struct ProjTable {           // one table of a launch
  const float* w;            // [dim, att]
  const float* b;            // [att]
  void* out;                 // [n_rows, att], float32 or bfloat16
  int bf16;                  // the bfloat16 k table (see proj_store)
};

// A launch (see tables_design in kernels/dense.py): `tasks` = tables x
// `groups` column groups of 4 lc columns; block b projects node tile
// b / tasks for task b % tasks.
struct ProjLaunch {
  const void* x;             // [n_rows, dim] of TX
  ProjTable t0, t1;
  int n_rows, dim, att;
  int lc;                    // lanes over a column group: 8, 16 or 32
  int groups, tasks;
  int cols;                  // a float32 x: the columns side by side,
  int n_tiles, step;         // its node tiles and the blocks of a group
  int vec;                   // 16-byte copies: dim and att whole 16-byte
                             // words, every operand 16-byte aligned
};

// What a block reads of a launch, by value (registers, not the kernel's
// parameter struct).
struct ProjTile {
  const void* x;
  const float* w;
  int n_rows, dim, att, lc, vec;
  int n0, bm, c0;            // the tile's first node, its nodes, its first
};                           // column

// Issue the copies of stage `k0` (x columns [k0, k0 + KD) of the tile's
// rows, the same rows of W's column group); zero what lies outside.
template <typename TX, int KD>
__device__ __forceinline__ void proj_stage(const ProjTile& t, TX* xs,
                                           float* ws, int k0) {
  const TX* x = static_cast<const TX*>(t.x);
  constexpr int kE = 16 / static_cast<int>(sizeof(TX));
  constexpr int kRow = proj_row<TX, KD>();
  const int cw = 4 * t.lc;
  if (t.vec) {
    constexpr int kPieces = KD / kE;
    for (int i = threadIdx.x; i < t.bm * kPieces; i += kDenseThreads) {
      const int r = i / kPieces, q = i % kPieces;
      const int n = t.n0 + r, k = k0 + q * kE;
      TX* dst = xs + r * kRow + q * kE;
      if (n < t.n_rows && k < t.dim)
        cp_async16(dst, x + static_cast<size_t>(n) * t.dim + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    const int wp = cw / 4;
    for (int i = threadIdx.x; i < KD * wp; i += kDenseThreads) {
      const int kr = i / wp, q = i % wp;
      const int k = k0 + kr, c = t.c0 + 4 * q;
      float* dst = ws + kr * cw + 4 * q;
      if (k < t.dim && c < t.att)
        cp_async16(dst, t.w + static_cast<size_t>(k) * t.att + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < t.bm * KD; i += kDenseThreads) {
      const int r = i / KD, kk = i % KD;
      const int n = t.n0 + r, k = k0 + kk;
      xs[r * kRow + kk] = (n < t.n_rows && k < t.dim)
                              ? x[static_cast<size_t>(n) * t.dim + k]
                              : dense_zero<TX>();
    }
    for (int i = threadIdx.x; i < KD * cw; i += kDenseThreads) {
      const int kr = i / cw, cc = i % cw;
      const int k = k0 + kr, c = t.c0 + cc;
      ws[kr * cw + cc] = (k < t.dim && c < t.att)
                             ? t.w[static_cast<size_t>(k) * t.att + c]
                             : 0.0f;
    }
  }
}

// One node tile of one column group, accumulated in Acc (float for a
// float32 table, double for the bfloat16 k table) and stored as TO.
template <typename TX, int TM, int KD, typename Acc, typename TO>
__device__ __forceinline__ void project_tile(const ProjTile& t,
                                             const float* __restrict__ b,
                                             TO* __restrict__ out,
                                             unsigned char* smem) {
  constexpr int kRow = proj_row<TX, KD>();
  const int lc_n = t.lc, lr_n = 32 / lc_n, cw = 4 * lc_n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lc = lane % lc_n, lr = lane / lc_n;
  const int row0 = warp * lr_n * TM + lr;     // the lane's first node
  const size_t x_bytes = sizeof(TX) * t.bm * kRow;
  const size_t stage = x_bytes + sizeof(float) * KD * cw;

  Acc acc[TM][kProjOut];
#pragma unroll
  for (int j = 0; j < kProjOut; ++j) {
    const int c = t.c0 + 4 * lc + j;
    const float bias = c < t.att ? __ldg(b + c) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) proj_start(bias, &acc[i][j]);
  }
  const int stages = (t.dim + KD - 1) / KD;
#pragma unroll
  for (int s = 0; s < kProjStages - 1; ++s) {
    if (s < stages)
      proj_stage<TX, KD>(t, reinterpret_cast<TX*>(smem + s * stage),
                     reinterpret_cast<float*>(smem + s * stage + x_bytes),
                     s * KD);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int ahead = s + kProjStages - 1;
    if (ahead < stages) {
      unsigned char* buf = smem + (ahead % kProjStages) * stage;
      proj_stage<TX, KD>(t, reinterpret_cast<TX*>(buf),
                     reinterpret_cast<float*>(buf + x_bytes),
                     ahead * KD);
    }
    cp_async_commit();
    cp_async_wait<kProjStages - 1>();
    __syncthreads();
    const unsigned char* buf = smem + (s % kProjStages) * stage;
    const TX* xr = reinterpret_cast<const TX*>(buf) + row0 * kRow;
    const float* wr = reinterpret_cast<const float*>(buf + x_bytes) + 4 * lc;
    const int kc = min(KD, t.dim - s * KD);
    for (int k = 0; k < kc; k += 4) {
      float wv[4][kProjOut];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load4(wr + (k + kk) * cw, wv[kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float xv[4];
        load4(xr + i * lr_n * kRow + k, xv);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < kProjOut; ++j)
            acc[i][j] = proj_fma(xv[kk], wv[kk][j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  const int c = t.c0 + 4 * lc;
  const bool whole = c + kProjOut <= t.att;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = t.n0 + row0 + i * lr_n;
    if (n >= t.n_rows) break;
    TO* o = out + static_cast<size_t>(n) * t.att + c;
    if constexpr (sizeof(TO) == 4) {
      if (whole && t.vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < kProjOut; ++j)
      if (c + j < t.att) proj_store(o + j, acc[i][j], __ldg(b + c + j));
  }
}

// ---- 3xTF32 tensor-core products (mma.sync m16n8k8) ----
// A float32 operand v is split into two TF32 values, v = big + small: big
// is v rounded to TF32 (10 mantissa bits, to nearest: an integer add and a
// mask), small the exact rest, whose own low bits the tensor cores drop
// (2^-21 of v, of either sign). Then a b = big_a big_b + big_a small_b +
// small_a big_b to within about 2^-20 of the product, without bias
// (small_a small_b is left out): float32 products at tensor-core rates.
// (cvt.rna.tf32, a conversion, issues at a fraction of the full-rate
// pipes' rate and did bound the kernels; truncating big instead biased
// every product the same way, and a row's sums drifted past 1e-5 of their
// scale.)
// A bfloat16 operand is a TF32 value already (small = 0), which saves one
// product. Each mma.sync adds 8 products to its float32 accumulator and
// rounds that sum toward zero; the callers keep the chains short (a k8
// step, or a stage of 32 rows, then float32 adds).

__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void tf32_split(float v, uint32_t* big,
                                           uint32_t* small) {
  const uint32_t b = tf32_round(__float_as_uint(v));
  *big = b;
  *small = __float_as_uint(v - __uint_as_float(b));
}

// c[16 x 8] += a[16 x 8] b[8 x 8] (fragments as the PTX ISA lays them out:
// lane (g, t) = (lane / 4, lane % 4) holds a at rows g, g + 8 and columns
// t, t + 4, b at rows t, t + 4 and column g, c at rows g, g + 8 and columns
// 2 t, 2 t + 1)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a zero accumulator)
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(z));
}

// c += a b over the split operands, the small terms first; `exact_a`: a
// holds TF32 values (a bfloat16 table), its small part is zero
template <bool exact_a>
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_big,
                                           const uint32_t* a_small,
                                           const uint32_t* b_big,
                                           const uint32_t* b_small) {
  if (!exact_a) mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// The float32 tables on the tensor cores. A block keeps one group of
// kMmaCols consecutive columns of the tables side by side ([Qw | Kw] with
// two tables) for all of D in shared memory, and walks node tiles of
// kMmaRows nodes, first_tile, first_tile + step, ..., its x stages one
// pipeline across the tiles; 4 x 2 warps of 32 nodes x 32 columns (2 m16
// tiles x 4 n8 tiles). The groups of a tile run side by side, so x comes
// from device memory once for them. (Groups of 128 columns, which would
// stage x once, need 64 sums a lane and spilled: BLEND's tables took
// 0.1856 ms against 0.1402 in groups of 64, H100 80GB HBM3 at 700 W.)
// x rows are padded to 36 floats and W rows to 72, so that every fragment
// load of a warp falls in 32 different banks.
constexpr int kMmaX = kProjDepth + 4;
constexpr int kMmaCols = 64;
constexpr int kMmaW = kMmaCols + 8;
constexpr int kMmaRows = 128;


struct MmaTile {
  const float* x;
  const float* w0;
  const float* w1;
  int n_rows, dim, att, cols, vec, c0;
};

// W's rows of the block's columns (column c of the tables side by side:
// table c / att, its column c % att), all of D, zero past D and the
// columns
__device__ __forceinline__ void mma_weights(const MmaTile& t, float* ws,
                                            int rows) {
  constexpr int kC = kMmaCols, kW = kMmaW;
  if (t.vec) {
    for (int i = threadIdx.x; i < rows * (kC / 4); i += kDenseThreads) {
      const int k = i / (kC / 4), q = i % (kC / 4);
      const int c = t.c0 + 4 * q;
      float* dst = ws + k * kW + 4 * q;
      if (k < t.dim && c < t.cols) {
        const float* w = c < t.att ? t.w0 : t.w1;
        cp_async16(dst, w + static_cast<size_t>(k) * t.att + c % t.att);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * kC; i += kDenseThreads) {
      const int k = i / kC, cc = i % kC, c = t.c0 + cc;
      float v = 0.0f;
      if (k < t.dim && c < t.cols)
        v = (c < t.att ? t.w0 : t.w1)[static_cast<size_t>(k) * t.att +
                                      c % t.att];
      ws[k * kW + cc] = v;
    }
  }
}

// x's columns [k0, k0 + kProjDepth) of the rows [n0, n0 + kMmaRows),
// zero outside
__device__ __forceinline__ void mma_stage(const MmaTile& t, float* xs,
                                          int n0, int k0) {
  if (t.vec) {
    for (int i = threadIdx.x; i < kMmaRows * (kProjDepth / 4);
         i += kDenseThreads) {
      const int r = i / (kProjDepth / 4), q = i % (kProjDepth / 4);
      const int n = n0 + r, k = k0 + 4 * q;
      float* dst = xs + r * kMmaX + 4 * q;
      if (n < t.n_rows && k < t.dim)
        cp_async16(dst, t.x + static_cast<size_t>(n) * t.dim + k);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kMmaRows * kProjDepth;
         i += kDenseThreads) {
      const int r = i / kProjDepth, kk = i % kProjDepth;
      const int n = n0 + r, k = k0 + kk;
      xs[r * kMmaX + kk] = (n < t.n_rows && k < t.dim)
                               ? t.x[static_cast<size_t>(n) * t.dim + k]
                               : 0.0f;
    }
  }
}

// What a projection stores: its sums as they are (the node tables). An
// epilogue reads what it needs of an output row n once a tile (row(n),
// issued with the tile's first stage, so that its loads overlap the
// products) and then changes a lane's NT pairs of sums of that row,
// columns c, c + 1 of n8 tile nt at c = c0 + 8 nt (apply).
struct PlainStore {
  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  template <int NT>
  __device__ __forceinline__ void apply(const Row&, int,
                                        float2 (&)[NT]) const {}
};

// The product of the tile's rows by the resident columns, started from the
// bias (b0, b1 nullable: zero) and stored through the epilogue epi (see
// PlainStore).
template <typename Epi>
__device__ __forceinline__ void project_mma(const MmaTile& t,
                                            const float* __restrict__ b0,
                                            const float* __restrict__ b1,
                                            float* __restrict__ out0,
                                            float* __restrict__ out1,
                                            int first_tile, int step,
                                            int n_tiles, unsigned char* smem,
                                            const Epi& epi) {
  constexpr int MT = 2, NT = 4;      // m16 tiles and n8 tiles a warp
  constexpr int kW = kMmaW, kStages = kProjStages, kRows = kMmaRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m_base = (warp / 2) * 16 * MT, n_base = (warp % 2) * 8 * NT;
  const int ksteps = (t.dim + kProjDepth - 1) / kProjDepth;
  const int my_tiles =
      first_tile < n_tiles ? (n_tiles - first_tile + step - 1) / step : 0;
  const int total = my_tiles * ksteps;          // (tile, stage) pairs
  float* ws = reinterpret_cast<float*>(smem);
  float* xs0 = ws + ksteps * kProjDepth * kW;
  constexpr int kXFloats = kRows * kMmaX;
  float bias[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = t.c0 + n_base + nt * 8 + 2 * t4 + h;
      const float* b = c < t.att ? b0 : b1;
      bias[nt][h] = c < t.cols && b != nullptr ? __ldg(b + c % t.att) : 0.0f;
    }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = bias[nt][e % 2];
  typename Epi::Row rows[MT][2];                // the tile's output rows
  mma_weights(t, ws, ksteps * kProjDepth);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total)
      mma_stage(t, xs0 + i * kXFloats,
                (first_tile + (i / ksteps) * step) * kRows,
                (i % ksteps) * kProjDepth);
    cp_async_commit();
  }
  for (int i = 0; i < total; ++i) {
    if (i % ksteps == 0) {                      // a tile's first stage
      const int n0 = (first_tile + (i / ksteps) * step) * kRows;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rows[mt][h] = epi.row(n0 + m_base + mt * 16 + g + 8 * h);
    }
    const int ahead = i + kStages - 1;
    if (ahead < total)
      mma_stage(t, xs0 + (ahead % kStages) * kXFloats,
                (first_tile + (ahead / ksteps) * step) * kRows,
                (ahead % ksteps) * kProjDepth);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int s = i % ksteps;
    const float* xb = xs0 + (i % kStages) * kXFloats + m_base * kMmaX;
    const float* wb = ws + s * kProjDepth * kW + n_base;
    // KC k8 steps a partial sum: their 3 KC products into a sum of their
    // own, then added to the tile's in float32. Each mma.sync rounds its
    // sum toward zero, and one chain of all 3 D / 8 products drifted past
    // 1e-5 of a row's scale (K6's den at arxiv scale). The stage's columns
    // past D are zeros in x and W.
    constexpr int KC = 2;
#pragma unroll
    for (int k = 0; k < kProjDepth; k += 8 * KC) {
      uint32_t ab[KC][MT][4], as[KC][MT][4];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xr = xb + (mt * 16 + g) * kMmaX + k + 8 * kk + t4;
          tf32_split(xr[0], &ab[kk][mt][0], &as[kk][mt][0]);
          tf32_split(xr[8 * kMmaX], &ab[kk][mt][1], &as[kk][mt][1]);
          tf32_split(xr[4], &ab[kk][mt][2], &as[kk][mt][2]);
          tf32_split(xr[8 * kMmaX + 4], &ab[kk][mt][3], &as[kk][mt][3]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float part[MT][4];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const float* wc = wb + (k + 8 * kk + t4) * kW + nt * 8 + g;
          uint32_t bb[2], bs[2];
          tf32_split(wc[0], &bb[0], &bs[0]);
          tf32_split(wc[4 * kW], &bb[1], &bs[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (kk == 0)
              mma_tf32_zero(part[mt], as[kk][mt], bb);
            else
              mma_tf32(part[mt], as[kk][mt], bb);
            mma_tf32(part[mt], ab[kk][mt], bs);
            mma_tf32(part[mt], ab[kk][mt], bb);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][e];
      }
    }
    if (s == ksteps - 1) {                      // the tile is done
      const int n0 = (first_tile + (i / ksteps) * step) * kRows;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + m_base + mt * 16 + g + 8 * h;
          const int c0 = t.c0 + n_base + 2 * t4;
          float2 v[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            v[nt] = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            acc[mt][nt][2 * h] = bias[nt][0];
            acc[mt][nt][2 * h + 1] = bias[nt][1];
          }
          if (n >= t.n_rows) continue;
          epi.apply(rows[mt][h], c0, v);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // an even column and its neighbour: one table (att is even
            // where t.vec), one 8-byte store
            const int c = c0 + nt * 8;
            float* o = (c < t.att ? out0 : out1) +
                       static_cast<size_t>(n) * t.att + c % t.att;
            if (t.vec && c + 1 < t.cols) {
              *reinterpret_cast<float2*>(o) = v[nt];
            } else {
              if (c < t.cols) o[0] = v[nt].x;
              if (c + 1 < t.cols)
                (c + 1 < t.att ? out0 : out1)[static_cast<size_t>(n) *
                                                  t.att +
                                              (c + 1) % t.att] = v[nt].y;
            }
          }
        }
    }
    __syncthreads();
  }
}

// A float32 x: the tables side by side on the tensor cores (kMma, see
// project_mma; T unused). A float32 x of few nodes, or a bfloat16 x (the
// bfloat16 k table sums in float64): the SIMT tile, T = TM nodes a lane,
// stages of KD columns; the block's task decides the table there
// (block-uniform, so every thread of a block meets the same barriers).
template <typename TX, int T, int KD, bool kMma>
__global__ void __launch_bounds__(kDenseThreads, 2)
    node_project_kernel(ProjLaunch p) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  const int task = blockIdx.x % p.tasks, tile = blockIdx.x / p.tasks;
  if constexpr (kMma) {
    MmaTile t;
    t.x = static_cast<const float*>(p.x);
    t.w0 = p.t0.w;
    t.w1 = p.t1.w;
    t.n_rows = p.n_rows;
    t.dim = p.dim;
    t.att = p.att;
    t.cols = p.cols;
    t.vec = p.vec;
    t.c0 = task * kMmaCols;
    project_mma(t, p.t0.b, p.t1.b, static_cast<float*>(p.t0.out),
                static_cast<float*>(p.t1.out), tile, p.step, p.n_tiles,
                dense_smem, PlainStore());
  } else {
    const int table = task / p.groups;
    ProjTile t;
    t.x = p.x;
    t.w = table ? p.t1.w : p.t0.w;
    t.n_rows = p.n_rows;
    t.dim = p.dim;
    t.att = p.att;
    t.lc = p.lc;
    t.vec = p.vec;
    t.bm = kDenseWarps * (32 / p.lc) * T;
    t.n0 = tile * t.bm;
    t.c0 = (task % p.groups) * 4 * p.lc;
    const float* b = table ? p.t1.b : p.t0.b;
    void* out = table ? p.t1.out : p.t0.out;
    if constexpr (sizeof(TX) == 2) {
      if (table ? p.t1.bf16 : p.t0.bf16) {
        project_tile<TX, T, KD, double>(
            t, b, static_cast<__nv_bfloat16*>(out), dense_smem);
        return;
      }
    }
    project_tile<TX, T, KD, float>(t, b, static_cast<float*>(out),
                                   dense_smem);
  }
}

int dense_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tile design (kernels/dense.py's tables_design mirrors it). A float32
// x: the n_tables tables side by side on the tensor cores, cut into groups
// of kMmaCols columns and node tiles of kMmaRows (see project_mma), each
// group's weights resident in `step` blocks that walk the tiles. Where
// those tiles would leave fewer than two blocks an SM (a few thousand
// nodes), the SIMT tile instead, at most 4 kSmallLC columns a group and
// stages of kSmallDepth columns, so that the stages are few.
// The SIMT tile: lc the lanes over a column group of 4 lc columns (8 <=
// lc <= 32) of one table, a block's nodes 8 warps x (32 / lc) x TM (a
// bfloat16 x: kBf16TM, stages of kProjDepth columns).
template <typename TX>
cudaError_t launch_project(ProjLaunch p, int n_tables, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(TX) == 2;
  constexpr int kE = 16 / static_cast<int>(sizeof(TX));
  p.vec = p.dim % kE == 0 && p.att % 4 == 0 && aligned16(p.x) &&
          aligned16(p.t0.w) && aligned16(p.t0.out) &&
          (n_tables < 2 || (aligned16(p.t1.w) && aligned16(p.t1.out)));
  int tiles = 0, tm = kBf16TM, depth = kProjDepth;
  bool small = false;
  size_t bytes = 0;
  void (*kernel)(ProjLaunch) = nullptr;
  const int sms = dense_sms();
  if constexpr (!kBf16) {
    const int cols = n_tables * p.att;
    const int tasks = (cols + kMmaCols - 1) / kMmaCols;
    if ((p.n_rows + kMmaRows - 1) / kMmaRows * tasks >= 2 * sms) {
      p.cols = cols;
      p.groups = 1;
      p.tasks = tasks;
      kernel = node_project_kernel<TX, 0, kProjDepth, true>;
      p.n_tiles = (p.n_rows + kMmaRows - 1) / kMmaRows;
      const int ksteps = (p.dim + kProjDepth - 1) / kProjDepth;
      bytes = sizeof(float) * (ksteps * kProjDepth * kMmaW +
                               kProjStages * kMmaRows * kMmaX);
      // resident blocks an SM: two, or one where two do not fit
      const int per_sm = 2 * (bytes + 1024) <= 228 * 1024 ? 2 : 1;
      p.step = min(p.n_tiles, (per_sm * sms + p.tasks - 1) / p.tasks);
      tiles = p.step;
    } else {
      // few nodes: the tensor cores' tiles would leave SMs idle; SIMT
      // tiles of at most kSmallLC lanes over a column group (each float4
      // of W feeds 32 / lc lanes, so that shared memory keeps up with the
      // FMAs), stages of kSmallDepth columns, and TM = 8 nodes a lane, or
      // 4 where its tiles end sooner: the blocks of the busiest SM times
      // the nodes of a block
      int lc = 8;
      while (lc < kSmallLC && 4 * lc < p.att) lc *= 2;
      const int small_tasks = n_tables * ((p.att + 4 * lc - 1) / (4 * lc));
      auto cost = [&](int tm_) {
        const int bm = kDenseWarps * (32 / lc) * tm_;
        const int blocks = (p.n_rows + bm - 1) / bm * small_tasks;
        return (blocks + sms - 1) / sms * bm;
      };
      tm = cost(4) < cost(8) ? 4 : 8;
      depth = kSmallDepth;
      small = true;
      kernel = tm == 4 ? node_project_kernel<TX, 4, kSmallDepth, false>
                       : node_project_kernel<TX, 8, kSmallDepth, false>;
    }
  }
  if constexpr (kBf16)
    kernel = node_project_kernel<TX, kBf16TM, kProjDepth, false>;
  if (tiles == 0) {                    // a SIMT launch
    int lc = 8;
    while (lc < (small ? kSmallLC : 32) && 4 * lc < p.att) lc *= 2;
    p.lc = lc;
    p.groups = (p.att + 4 * lc - 1) / (4 * lc);
    p.tasks = n_tables * p.groups;
    const int bm = kDenseWarps * (32 / lc) * tm;
    tiles = (p.n_rows + bm - 1) / bm;
    const int ksteps = (p.dim + depth - 1) / depth;
    const int row = depth + 16 / static_cast<int>(sizeof(TX));
    bytes = min(kProjStages, ksteps) *
            (sizeof(TX) * bm * row + sizeof(float) * depth * 4 * lc);
  }
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<tiles * p.tasks, kDenseThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

ProjTable proj_table(const void* w, const void* b, void* out, int bf16) {
  ProjTable t;
  t.w = static_cast<const float*>(w);
  t.b = static_cast<const float*>(b);
  t.out = out;
  t.bf16 = bf16;
  return t;
}

// q from the row side, k from the column side: for the bfloat16 column
// table a bfloat16 k table, rounded as the JAX package rounds k_e (kw and
// kb come rounded to bfloat16 from the wrapper). One launch writes both
// tables when they project the same x (kTablesF32, kTablesBf16); beside a
// bfloat16 column table a float32 row side takes two.
cudaError_t launch_tables(int tables, const void* x, const void* xcol,
                          const void* qw, const void* qb, const void* kw,
                          const void* kb, void* qtab, void* ktab, int n_rows,
                          int dim, int att, cudaStream_t stream) {
  if (n_rows <= 0) return cudaSuccess;
  ProjLaunch p = {};
  p.n_rows = n_rows;
  p.dim = dim;
  p.att = att;
  p.t0 = proj_table(qw, qb, qtab, 0);
  p.t1 = proj_table(kw, kb, ktab, tables != kTablesF32);
  if (tables == kTablesF32) {
    p.x = x;
    return launch_project<float>(p, 2, stream);
  }
  if (tables == kTablesBf16) {
    p.x = x;
    return launch_project<__nv_bfloat16>(p, 2, stream);
  }
  p.x = x;
  cudaError_t err = launch_project<float>(p, 1, stream);
  if (err != cudaSuccess) return err;
  p.x = xcol;
  p.t0 = p.t1;
  return launch_project<__nv_bfloat16>(p, 1, stream);
}

// ------------------------------------------------------------------------
// dKw / dKb: partial[p, d, a] = sum over block p's rows r of
// [x[idx[r]] | 1][d] dk[r, a] (idx null: r itself), d in [0, dim].
//
// On the tensor cores: a block's tile of 128 rows d by NA columns a (32,
// or 64 past ATT = 32) is x^T dk over the block's rows, 4 x 2 warps of
// 32 x NA / 2 (2 m16 tiles x NA / 16 n8 tiles), the rows of a stage the
// products' depth. Staged rows are padded (x to 136 elements, dk to NA + 8
// floats) so that every fragment load of a warp falls in 32 banks. dKb,
// the ones row, is the column sum of the staged dk rows, taken by NA
// threads of the first row tile.

constexpr int kReduceStages = GNPDE_REDUCE_STAGES;
constexpr int kReduceRows = 32;    // rows a stage
constexpr int kReduceD = 128;      // output rows a tile
constexpr int kReduceX = kReduceD + 8;

struct ReduceLaunch {
  const void* x;                   // [*, dim] of TX
  const int* idx;                  // [rows] or null
  const float* dk;                 // [rows, att]
  float* partial;                  // [blocks, dim + 1, att]
  int rows, rows_per_block, dim, att, vec;
};

// What a block reads of a launch, by value.
struct ReduceTile {
  const void* x;
  const int* idx;
  const float* dk;
  int dim, att, vec, d0, a0, r1;
};

// the stage of rows [r, r + kReduceRows) of this block (zero past r1): the
// tile's columns of their x rows and of their dk rows
template <typename TX, int NA>
__device__ __forceinline__ void reduce_stage(const ReduceTile& t, TX* xs,
                                             float* ks, int r) {
  const TX* x = static_cast<const TX*>(t.x);
  constexpr int kE = 16 / static_cast<int>(sizeof(TX));
  constexpr int kK = NA + 8;
  if (t.vec) {
    constexpr int kXP = kReduceD / kE, kKP = NA / 4;
    for (int i = threadIdx.x; i < kReduceRows * (kXP + kKP);
         i += kDenseThreads) {
      const int j = i / (kXP + kKP), q = i % (kXP + kKP);
      const int rr = r + j;
      if (q < kXP) {
        const int d = t.d0 + q * kE;
        TX* dst = xs + j * kReduceX + q * kE;
        if (rr < t.r1 && d < t.dim) {
          const int src = t.idx ? __ldg(t.idx + rr) : rr;
          cp_async16(dst, x + static_cast<size_t>(src) * t.dim + d);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      } else {
        const int a = t.a0 + 4 * (q - kXP);
        float* dst = ks + j * kK + 4 * (q - kXP);
        if (rr < t.r1 && a < t.att)
          cp_async16(dst, t.dk + static_cast<size_t>(rr) * t.att + a);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kReduceRows * (kReduceD + NA);
         i += kDenseThreads) {
      const int j = i / (kReduceD + NA), q = i % (kReduceD + NA);
      const int rr = r + j;
      if (q < kReduceD) {
        const int d = t.d0 + q;
        TX v = dense_zero<TX>();
        if (rr < t.r1 && d < t.dim) {
          const int src = t.idx ? __ldg(t.idx + rr) : rr;
          v = x[static_cast<size_t>(src) * t.dim + d];
        }
        xs[j * kReduceX + q] = v;
      } else {
        const int a = t.a0 + q - kReduceD;
        ks[j * kK + q - kReduceD] =
            (rr < t.r1 && a < t.att)
                ? t.dk[static_cast<size_t>(rr) * t.att + a]
                : 0.0f;
      }
    }
  }
}

template <typename TX, int NA>
__global__ void __launch_bounds__(kDenseThreads)
    outer_reduce_kernel(ReduceLaunch p) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  constexpr int kNT = NA / 16;      // n8 tiles a warp
  constexpr int kK = NA + 8;
  constexpr bool kExact = sizeof(TX) == 2;   // bfloat16 x: TF32 already
  ReduceTile t;
  t.x = p.x;
  t.idx = p.idx;
  t.dk = p.dk;
  t.dim = p.dim;
  t.att = p.att;
  t.vec = p.vec;
  t.d0 = blockIdx.y * kReduceD;
  t.a0 = blockIdx.z * NA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m_base = (warp / 2) * 32, n_base = (warp % 2) * (NA / 2);
  const int r0 = blockIdx.x * p.rows_per_block;
  t.r1 = min(p.rows, r0 + p.rows_per_block);
  const int stages =
      t.r1 > r0 ? (t.r1 - r0 + kReduceRows - 1) / kReduceRows : 0;
  const size_t x_bytes = sizeof(TX) * kReduceRows * kReduceX;
  const size_t stage = x_bytes + sizeof(float) * kReduceRows * kK;
  // warps whose rows lie past dim only copy
  const bool active = t.d0 + m_base < t.dim;
  const bool ones = blockIdx.y == 0 && threadIdx.x < NA;   // dKb's sums
  float tot[2][kNT][4], acc[2][kNT][4], btot = 0.0f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = acc[mt][nt][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < kReduceStages - 1; ++s) {
    if (s < stages)
      reduce_stage<TX, NA>(
          t, reinterpret_cast<TX*>(dense_smem + s * stage),
          reinterpret_cast<float*>(dense_smem + s * stage + x_bytes),
          r0 + s * kReduceRows);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int ahead = s + kReduceStages - 1;
    if (ahead < stages) {
      unsigned char* buf = dense_smem + (ahead % kReduceStages) * stage;
      reduce_stage<TX, NA>(t, reinterpret_cast<TX*>(buf),
                           reinterpret_cast<float*>(buf + x_bytes),
                           r0 + ahead * kReduceRows);
    }
    cp_async_commit();
    cp_async_wait<kReduceStages - 1>();
    __syncthreads();
    const unsigned char* buf = dense_smem + (s % kReduceStages) * stage;
    const TX* xs = reinterpret_cast<const TX*>(buf) + m_base + g;
    const float* ks = reinterpret_cast<const float*>(buf + x_bytes);
    if (active) {
#pragma unroll
      for (int k = 0; k < kReduceRows; k += 8) {
        uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float* kc = ks + (k + t4) * kK + n_base + nt * 8 + g;
          tf32_split(kc[0], &bb[nt][0], &bs[nt][0]);
          tf32_split(kc[4 * kK], &bb[nt][1], &bs[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const TX* xr = xs + (k + t4) * kReduceX + mt * 16;
          uint32_t ab[4], as[4];
          tf32_split(widen(xr[0]), &ab[0], &as[0]);
          tf32_split(widen(xr[8]), &ab[1], &as[1]);
          tf32_split(widen(xr[4 * kReduceX]), &ab[2], &as[2]);
          tf32_split(widen(xr[4 * kReduceX + 8]), &ab[3], &as[3]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma_3xtf32<kExact>(acc[mt][nt], ab, as, bb[nt], bs[nt]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mt][nt][e] += acc[mt][nt][e];
            acc[mt][nt][e] = 0.0f;
          }
    }
    if (ones) {
      float bsum = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kReduceRows; ++j) bsum += ks[j * kK + threadIdx.x];
      btot += bsum;
    }
    __syncthreads();
  }
  float* out =
      p.partial + static_cast<size_t>(blockIdx.x) * (t.dim + 1) * t.att;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = t.d0 + m_base + mt * 16 + g + 8 * h;
      if (d >= t.dim) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = t.a0 + n_base + nt * 8 + 2 * t4 + e;
          if (a < t.att)
            out[static_cast<size_t>(d) * t.att + a] = tot[mt][nt][2 * h + e];
        }
    }
  if (ones && t.a0 + static_cast<int>(threadIdx.x) < t.att)
    out[static_cast<size_t>(t.dim) * t.att + t.a0 + threadIdx.x] = btot;
}

// The first pass of dKw / dKb over `blocks` contiguous row ranges
// (kernels/dense.py's reduce_blocks: about two blocks an SM with the
// tiles); partial [blocks, dim + 1, att], every element written.
template <typename TX>
void launch_outer_reduce(const TX* x, const int* idx, const float* b,
                         float* partial, int rows, int blocks, int dim,
                         int att, cudaStream_t stream) {
  ReduceLaunch p;
  p.x = x;
  p.idx = idx;
  p.dk = b;
  p.partial = partial;
  p.rows = rows > 0 ? rows : 0;
  p.rows_per_block = (p.rows + blocks - 1) / blocks;
  p.dim = dim;
  p.att = att;
  constexpr int kE = 16 / static_cast<int>(sizeof(TX));
  p.vec = dim % kE == 0 && att % 4 == 0 && aligned16(x) && aligned16(b);
  const int na = att > 32 ? 64 : 32;
  const dim3 grid(blocks, (dim + kReduceD - 1) / kReduceD,
                  (att + na - 1) / na);
  const size_t bytes = kReduceStages * kReduceRows *
                       (sizeof(TX) * kReduceX + sizeof(float) * (na + 8));
  auto kernel = na == 64 ? outer_reduce_kernel<TX, 64>
                         : outer_reduce_kernel<TX, 32>;
  if (allow_shared(kernel, bytes) == cudaSuccess)
    kernel<<<grid, kDenseThreads, bytes, stream>>>(p);
}

}  // namespace
