// K21 smem_gather: out[i] = table[idx[i]] with the table [T, D] staged in
// shared memory, for float32 and bfloat16.
//
// Replaces the TPU probe kernels examples/perf_probe13_vmem_gather.py
// pallas_take_kernel (B: a row gather from a VMEM-resident table, which
// Mosaic compiled only at T = 8 and faulted on at T >= 64) and
// pallas_onehot_kernel (C: the same gather as a one-hot matrix product
// against a bf16 table, T = 512). They asked whether a small table held in
// the core's fast memory can serve a gather faster than a gather from
// device memory. On the H100 the fast memory is each SM's shared memory,
// at most 227 KB a block: T * D * sizeof(element) bytes must fit, and the
// wrapper raises where they do not (T = 512 float32 rows of 128, 256 KB).
//
// What bounds it on the H100: memory traffic. Each output row is written
// once (D * sizeof(element) bytes) and each index read once (4 bytes); the
// table is read once per block from L2, which the bound does not count.
// There is no arithmetic.
//
// Design: each block stages the whole table in dynamic shared memory with
// 16-byte copies (dynamic shared memory above 48 KB is requested with
// cudaFuncSetAttribute), then walks its contiguous run of indices. Its
// threads are laid over (output row, 16-byte word) pairs, so that a warp
// writes whole rows with coalesced 16-byte stores and reads each row's
// words from shared memory without bank conflicts (a quarter-warp reads
// 128 contiguous bytes). Rows must be a whole number of 16-byte words that
// divides the block's 512 threads (D = 128: 32 words in float32, 16 in
// bfloat16); the wrapper refuses other widths. Indices must lie in
// [0, T); the kernel does not check them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocksPerSm = 4;
constexpr int kSharedPerSm = 228 * 1024;

// rows of row_words 16-byte words; kThreads % row_words == 0
__global__ void __launch_bounds__(kThreads)
smem_gather_kernel(const int* __restrict__ idx,
                   const uint4* __restrict__ table, uint4* __restrict__ out,
                   int n_idx, int t_rows, int row_words,
                   int rows_per_block) {
  extern __shared__ uint4 tab[];
  const int total = t_rows * row_words;
  for (int i = threadIdx.x; i < total; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int first = blockIdx.x * rows_per_block;
  const int count = min(n_idx, first + rows_per_block) - first;
  if (count <= 0) return;
  const int* bidx = idx + first;
  uint4* bout = out + static_cast<size_t>(first) * row_words;
  // each thread keeps one word of the row; rows advance by the stride
  const int k = threadIdx.x % row_words;
  const int stride = blockDim.x / row_words;
  for (int i = threadIdx.x / row_words; i < count; i += stride)
    bout[static_cast<size_t>(i) * row_words + k] =
        tab[bidx[i] * row_words + k];
}

int launch(const void* idx, const void* table, void* out, int n_idx,
           int t_rows, int row_bytes, cudaStream_t stream) {
  if (row_bytes < 16 || row_bytes % 16 != 0 ||
      kThreads % (row_bytes / 16) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx <= 0) return static_cast<int>(cudaGetLastError());
  const int bytes = t_rows * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      smem_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int per_sm =
      max(1, min(kMaxBlocksPerSm, kSharedPerSm / max(bytes + 1024, 1)));
  int blocks = max(1, sms * per_sm);
  const int rows_per_block = (n_idx + blocks - 1) / blocks;
  blocks = (n_idx + rows_per_block - 1) / rows_per_block;
  smem_gather_kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const int*>(idx), static_cast<const uint4*>(table),
      static_cast<uint4*>(out), n_idx, t_rows, row_bytes / 16,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 for float32, 1 for bfloat16 (the copy is by 16-byte words, so
// the dtype sets only the row's width in bytes)
extern "C" int gnpde_smem_gather(const void* idx, const void* table,
                                 void* out, int n_idx, int t_rows, int dim,
                                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(idx, table, out, n_idx, t_rows, dim * 4, s);
  if (dtype == 1)
    return launch(idx, table, out, n_idx, t_rows, dim * 2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
