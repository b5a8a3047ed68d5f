// K15 blocked_spmm and K16 blocked_sddmm: SpMM and SDDMM over a blocked
// edge plan (graph_neural_pde_tpu_torch/ops/plan.py): nodes tiled into
// blocks of B = block_n, edge slots bucketed by (row block, column block)
// in chunks of `chunk` slots, the chunks of one row block contiguous.
//
// K15: out[rb*B + row_local[s]] += w[s] * x[cb*B + col_local[s]] over the
//      plan's valid slots s (rb, cb: the row and column block of s's
//      chunk); out is [N_pad, D], N_pad a multiple of B.
// K16: out[s] = a[rb*B + row_local[s]] . b[cb*B + col_local[s]] for every
//      slot, padding included (there row_local = col_local = 0).
//
// Replace the TPU kernels graph_neural_pde_tpu/ops/pallas/spmm_blocked.py
// _spmm_kernel / _spmm_call (P17) and _sddmm_kernel / _sddmm_call (P18).
// On the TPU each grid step turns one chunk's gather and scatter into
// one-hot matmuls against node blocks held in VMEM (4 * B * D flops per
// slot), because a TPU has no fast indexed access. Hopper has it, so
// these kernels index directly and keep only the blocking: one CTA owns a
// row block and walks its chunks, with the chunk's column block of x in
// shared memory.
//
// What bounds them on the H100: memory traffic. K15 moves each x row of a
// column block once per bucket (staged), 12 bytes of index and weight per
// valid slot, and writes each output row once; 2 flops per slot and
// feature. K16 reads two rows per slot (D * 4 bytes each) for 2 * D flops.
// Both sit two orders of magnitude below the card's ridge point.
//
// K15's design. A CTA owns one row block and a tile of DT features (DT in
// {1, 2, 4, 8, 16}, the smallest power of two covering D, at most 16, and
// halved until two [B, DT] float tiles fit 96 KB, so that two CTAs share
// an SM: B = 1024 takes DT = 8, 64 KB, past the 48 KB default, so the
// launch raises the kernel's dynamic shared-memory limit). The x tile of
// the chunk's column block is staged in shared memory when the column
// block changes; the output tile of the row block accumulates in shared
// memory and is written once at the end. Slots are not walked in plan
// order: the host sorts each chunk's valid slots by row
// (kernels/blocked.py, blocked_layout), so a chunk is a set of row
// segments with distinct rows. Threads take
// (segment, feature) pairs, features fastest, so that the image paths'
// D = 1 and D = 3 put the threads over slots and the wide paths over
// features. Each pair sums its segment in slot order in a register and
// adds it to its output element; the distinct rows of a chunk make that
// free of conflicts, and a barrier between chunks orders the chunks. No
// atomics: every output element is summed in a fixed order, so two
// launches are bit-identical. Padding slots (weight 0) are skipped.
//
// K16's design: a group of L lanes per slot (L the largest power of two
// <= D, at most 32), lanes strided over the features, and the group
// reduces its partial sums with a fixed xor-shuffle butterfly. D = 1 and
// D = 3 give one and two lanes per slot, so a warp covers 32 or 16 slots
// instead of idling 31 lanes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int DT>
__global__ void blocked_spmm_kernel(
    const int* __restrict__ rb_ptr,      // [n_blocks + 1] chunk ranges
    const int* __restrict__ chunk_cols,  // [n_chunks]
    const int* __restrict__ seg_ptr,     // [n_chunks + 1] segment ranges
    const int* __restrict__ seg_row,     // [n_seg] row_local
    const int* __restrict__ seg_start,   // [n_seg + 1] ranges of slot_ord
    const int* __restrict__ slot_ord,    // [n_slots] plan slot
    const int* __restrict__ slot_col,    // [n_slots] col_local of the slot
    const float* __restrict__ w,         // [capacity]
    const float* __restrict__ x,         // [N_pad, dim]
    float* __restrict__ out,             // [N_pad, dim]
    int block_n, int dim) {
  extern __shared__ float smem[];
  float* xs = smem;                                    // [block_n, DT]
  float* acc = smem + static_cast<size_t>(block_n) * DT;
  const int rb = blockIdx.x;
  const int d0 = blockIdx.y * DT;
  const int tile = block_n * DT;
  for (int i = threadIdx.x; i < tile; i += kThreads) acc[i] = 0.0f;

  int staged = -1;
  for (int c = rb_ptr[rb]; c < rb_ptr[rb + 1]; ++c) {
    const int s0 = seg_ptr[c], s1 = seg_ptr[c + 1];
    if (s0 == s1) continue;                            // padding only
    const int cb = chunk_cols[c];
    if (cb != staged) {
      __syncthreads();                                 // xs still in use
      const float* xb = x + static_cast<size_t>(cb) * block_n * dim;
      for (int i = threadIdx.x; i < tile; i += kThreads) {
        const int r = i / DT, d = d0 + i % DT;
        xs[i] = d < dim ? xb[static_cast<size_t>(r) * dim + d] : 0.0f;
      }
      staged = cb;
    }
    __syncthreads();                   // xs staged, last chunk's acc done
    const int items = (s1 - s0) * DT;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int s = s0 + it / DT, j = it % DT;
      float sum = 0.0f;
      for (int k = seg_start[s]; k < seg_start[s + 1]; ++k)
        sum += w[slot_ord[k]] * xs[slot_col[k] * DT + j];
      acc[seg_row[s] * DT + j] += sum;
    }
  }
  __syncthreads();
  float* ob = out + static_cast<size_t>(rb) * block_n * dim;
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    const int r = i / DT, d = d0 + i % DT;
    if (d < dim) ob[static_cast<size_t>(r) * dim + d] = acc[i];
  }
}

template <int DT>
cudaError_t launch_spmm(const int* rb_ptr, const int* chunk_cols,
                        const int* seg_ptr, const int* seg_row,
                        const int* seg_start, const int* slot_ord,
                        const int* slot_col, const float* w, const float* x,
                        float* out, int n_blocks, int block_n, int dim,
                        cudaStream_t stream) {
  const size_t bytes = 2 * static_cast<size_t>(block_n) * DT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_spmm_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (dim + DT - 1) / DT);
  blocked_spmm_kernel<DT><<<grid, kThreads, bytes, stream>>>(
      rb_ptr, chunk_cols, seg_ptr, seg_row, seg_start, slot_ord, slot_col,
      w, x, out, block_n, dim);
  return cudaGetLastError();
}

template <int L>
__global__ void blocked_sddmm_kernel(
    const int* __restrict__ chunk_rows, const int* __restrict__ chunk_cols,
    const int* __restrict__ row_local, const int* __restrict__ col_local,
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int capacity, int chunk, int block_n,
    int dim) {
  const int lane = threadIdx.x % L;
  const long long s =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  // a group of L lanes never straddles a warp, so the shuffles below see
  // only lanes of the same slot; groups past the end still shuffle
  const bool live = s < capacity;
  float acc = 0.0f;
  if (live) {
    const int c = static_cast<int>(s / chunk);
    const float* ar = a + (static_cast<size_t>(chunk_rows[c]) * block_n
                           + row_local[s]) * dim;
    const float* br = b + (static_cast<size_t>(chunk_cols[c]) * block_n
                           + col_local[s]) * dim;
    for (int d = lane; d < dim; d += L) acc += ar[d] * br[d];
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane == 0) out[s] = acc;
}

template <int L>
cudaError_t launch_sddmm(const int* chunk_rows, const int* chunk_cols,
                         const int* row_local, const int* col_local,
                         const float* a, const float* b, float* out,
                         int capacity, int chunk, int block_n, int dim,
                         cudaStream_t stream) {
  const long long threads = static_cast<long long>(capacity) * L;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  blocked_sddmm_kernel<L><<<blocks, kThreads, 0, stream>>>(
      chunk_rows, chunk_cols, row_local, col_local, a, b, out, capacity,
      chunk, block_n, dim);
  return cudaGetLastError();
}

}  // namespace

// tile: DT, chosen by the wrapper (1, 2, 4, 8 or 16)
extern "C" int gnpde_blocked_spmm(
    const void* rb_ptr, const void* chunk_cols, const void* seg_ptr,
    const void* seg_row, const void* seg_start, const void* slot_ord,
    const void* slot_col, const void* w, const void* x, void* out,
    int n_blocks, int block_n, int dim, int tile, void* stream) {
  if (n_blocks <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const auto* rp = static_cast<const int*>(rb_ptr);
  const auto* cc = static_cast<const int*>(chunk_cols);
  const auto* sp = static_cast<const int*>(seg_ptr);
  const auto* sr = static_cast<const int*>(seg_row);
  const auto* ss = static_cast<const int*>(seg_start);
  const auto* so = static_cast<const int*>(slot_ord);
  const auto* sc = static_cast<const int*>(slot_col);
  const auto* wf = static_cast<const float*>(w);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 1: err = launch_spmm<1>(rp, cc, sp, sr, ss, so, sc, wf, xf, of,
                                 n_blocks, block_n, dim, st); break;
    case 2: err = launch_spmm<2>(rp, cc, sp, sr, ss, so, sc, wf, xf, of,
                                 n_blocks, block_n, dim, st); break;
    case 4: err = launch_spmm<4>(rp, cc, sp, sr, ss, so, sc, wf, xf, of,
                                 n_blocks, block_n, dim, st); break;
    case 8: err = launch_spmm<8>(rp, cc, sp, sr, ss, so, sc, wf, xf, of,
                                 n_blocks, block_n, dim, st); break;
    case 16: err = launch_spmm<16>(rp, cc, sp, sr, ss, so, sc, wf, xf, of,
                                   n_blocks, block_n, dim, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// lanes: L, chosen by the wrapper (1, 2, 4, 8, 16 or 32)
extern "C" int gnpde_blocked_sddmm(
    const void* chunk_rows, const void* chunk_cols, const void* row_local,
    const void* col_local, const void* a, const void* b, void* out,
    int capacity, int chunk, int block_n, int dim, int lanes, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  const auto* cr = static_cast<const int*>(chunk_rows);
  const auto* cc = static_cast<const int*>(chunk_cols);
  const auto* rl = static_cast<const int*>(row_local);
  const auto* cl = static_cast<const int*>(col_local);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes) {
    case 1: err = launch_sddmm<1>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 2: err = launch_sddmm<2>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 4: err = launch_sddmm<4>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 8: err = launch_sddmm<8>(cr, cc, rl, cl, af, bf, of, capacity,
                                  chunk, block_n, dim, st); break;
    case 16: err = launch_sddmm<16>(cr, cc, rl, cl, af, bf, of, capacity,
                                    chunk, block_n, dim, st); break;
    case 32: err = launch_sddmm<32>(cr, cc, rl, cl, af, bf, of, capacity,
                                    chunk, block_n, dim, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
