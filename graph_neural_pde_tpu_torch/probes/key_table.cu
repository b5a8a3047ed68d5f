// The two-pass variant of K18 for the key families, for
// probes/payload_walk.py --two-pass: the node projections' tile
// (kernels.dense.project) first writes every edge's key to an [E_pad, ATT]
// table, and this walk reads each tile's keys from it in place of the
// tensor-core products of csrc/fused_payload.cu's payload_keys_kernel.
// It includes that source, so that it walks the same windows of row
// pieces (walk_window) and merges the same way; its block holds no Kw
// parts, so its tiles may be larger (the probe picks them as key_design
// would without them). Built alone by the probe (nvcc -shared), never by
// kernels/build.py.

#include "../csrc/fused_payload.cu"

namespace {

// key_layout without Kw's parts: every region moved down by them
__host__ __device__ __forceinline__ KeyLayout table_layout(int dim, int att,
                                                           int heads, int cap,
                                                           int elem) {
  KeyLayout l = key_layout(dim, att, heads, cap, elem);
  const int w = l.w;
  l.w = 0;
  l.x -= w;
  l.rows -= w;
  l.k -= w;
  l.u -= w;
  l.carry -= w;
  l.total -= w;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kKeyThreads, 2)
payload_keys_table_kernel(KeyArgs a, const float* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char table_smem[];
  const int A = a.p.att;
  const KeyLayout l = table_layout(a.p.dim, A, a.p.heads, a.cap, sizeof(T));
  float* kt = reinterpret_cast<float*>(table_smem + l.k);
  walk_window<T>(a, l, table_smem, [&](const T*, int s0, int cnt) {
    for (int i = threadIdx.x; i < cnt * A; i += kKeyThreads)
      kt[(i / A) * l.ks + i % A] =
          __ldg(keys + static_cast<size_t>(s0) * A + i);
  });
}

// as fused_payload.cu's launch_keys, with this kernel and layout
template <typename T>
cudaError_t launch_table(const KeyArgs& a, const float* keys, int n_edges,
                         cudaStream_t s) {
  const int D = a.p.dim, H = a.p.heads;
  const KeyLayout l = table_layout(D, a.p.att, H, a.cap, sizeof(T));
  auto kernel = payload_keys_table_kernel<T>;
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
  kernel<<<grid, kKeyThreads, l.total, s>>>(b, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(payload_keys_merge_kernel, a.pc, a.part, a.stride,
               H * (D + 1), a.num, H * D, a.den, s);
}

}  // namespace

// gnpde_payload_keys's arguments, then keys [n_slots, att] (x_g Kw + kb)
extern "C" int gnpde_probe_payload_keys_table(
    const void* piece_ptr, const void* piece_row, const void* piece_slot,
    const void* multi_row, const void* multi_ptr, const void* row,
    const void* xg, const void* q, const void* kw, const void* kb,
    const void* gmax, const void* var, const void* ls, const void* shifts,
    void* num, void* den, void* part, const void* keys, int n_rows,
    int n_pieces, int n_multi, int dim, int att, int heads, int flags,
    int n_edges, int cap, int vec, int tables, void* stream) {
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
  a.window = 1;
  a.stride = payload_stride(dim, heads);
  a.vec = vec;
  auto k = static_cast<const float*>(keys);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      tables == 0 ? launch_table<float>(a, k, n_edges, s)
                  : launch_table<__nv_bfloat16>(a, k, n_edges, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
