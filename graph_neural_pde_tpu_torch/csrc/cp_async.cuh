// Copies global -> shared by cp.async, completed in groups: shared by the
// dense tiles (dense.cuh), K18's key tile (fused_payload.cu) and the node
// pass of K8's per-head mode (payload_bwd.cu). Each source that includes
// this header gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes, through the L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 4 bytes, or 0 where !valid (src is then not read, but must be a global
// address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups (the stages after the next) are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
