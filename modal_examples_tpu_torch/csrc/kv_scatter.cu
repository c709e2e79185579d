// KV page scatter for Hopper (sm_90a): write every layer's new K/V rows into
// the paged cache, in place.
//
// Replaces modal_examples_tpu/ops/paged_attention.py::_kv_scatter_kernel
// (entry scatter_kv_pages). The TPU kernel issued one strided HBM->HBM DMA
// per (slot, array) and aliased the page arrays through the pallas_call; here
// the cache tensors are updated in place and the wrapper hands back the same
// tensors.
//
// Bound: bytes. The function reads each new row once and writes it once; it
// does no arithmetic. The design moves every row with 16-byte vector loads
// and stores (neighbouring threads on neighbouring addresses) and gives each
// (token, array, layer) row its own block, so a decode step's few tokens
// still spread over many SMs. Dead or padded tokens all target page 0,
// slot 0: those writes race, which is harmless because page 0 is never
// attended.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) kv_scatter_kernel(
    uint4* __restrict__ k_pages,        // [L, P, ps, row_vec] in 16-byte units
    uint4* __restrict__ v_pages,
    const uint4* __restrict__ k_new,    // [L, N, row_vec]
    const uint4* __restrict__ v_new,
    const int* __restrict__ page_idx,   // [N]
    const int* __restrict__ slot,       // [N]
    int N, int P, int ps, int row_vec) {
  const int n = blockIdx.x;
  const int layer = blockIdx.z;
  const bool is_v = blockIdx.y == 1;
  const uint4* src = (is_v ? v_new : k_new) + ((size_t)layer * N + n) * row_vec;
  uint4* dst = (is_v ? v_pages : k_pages) +
               (((size_t)layer * P + page_idx[n]) * ps + slot[n]) * row_vec;
  for (int i = threadIdx.x; i < row_vec; i += THREADS) dst[i] = src[i];
}

}  // namespace

extern "C" int kv_scatter(void* k_pages, void* v_pages, const void* k_new,
                          const void* v_new, const void* page_idx,
                          const void* slot, int L, int N, int P, int ps,
                          int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || L > 65535) return (int)cudaErrorInvalidValue;
  if (N == 0 || L == 0) return (int)cudaSuccess;
  dim3 grid(N, 2, L);
  kv_scatter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (uint4*)k_pages, (uint4*)v_pages, (const uint4*)k_new,
      (const uint4*)v_new, (const int*)page_idx, (const int*)slot, N, P, ps,
      row_bytes / 16);
  return (int)cudaGetLastError();
}

extern "C" const char* kv_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
