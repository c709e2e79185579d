// Ragged paged decode attention over bf16 pages for Hopper (sm_90a): the
// instantiation of paged_decode.cuh (design, bound and numerics there) for
// bf16 rows, with its C entry.
//
// Replaces modal_examples_tpu/ops/paged_attention.py::_decode_kernel_ragged
// and ::_decode_kernel_ragged_grouped, bf16 pages.
#include "paged_decode.cuh"

__global__ void __launch_bounds__(paged::THREADS) paged_decode_split_kernel(paged::Params p) {
  paged::decode_split<paged::Bf16Page, /*INFLIGHT=*/true, /*ROUND_P=*/true>(p);
}

// The cached rows one block takes: the wrapper sizes the grid's split axis
// and the workspace by it.
extern "C" int paged_decode_split_rows() { return paged::SPLIT; }

extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages, const void* page_tables,
                            const void* prefix_lens, const void* k_new, const void* v_new, void* out, void* work,
                            void* tickets, int B, int Hq, int Hkv, int D, int layer, int P, int ps, int pps,
                            int n_split, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  paged::Params p{(const __nv_bfloat16*)q, k_pages, v_pages, nullptr, nullptr, (const int*)page_tables,
                  (const int*)prefix_lens, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
                  (__nv_bfloat16*)out, (float*)work, (int*)tickets, layer, P, ps, Hkv, Hq / Hkv, D, pps, n_split,
                  sm_scale};
  return paged::launch<paged::Bf16Page>(paged_decode_split_kernel, p, B, Hq, (cudaStream_t)stream);
}

extern "C" const char* paged_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
