// Write-then-attend paged decode attention over int8 pages for Hopper
// (sm_90a): K4's function (paged_decode_writeback.cu) over one layer's int8
// pages [P, ps, Hkv, D] plus their f32 scales [P, ps, Hkv] (the contiguous
// views pages.data[li] and pages.scale[li], passed as layer 0). The
// instantiation of paged_decode.cuh (design, bound and numerics there) with
// no in-flight column and the probabilities rounded to bf16 before P.V; a
// sequence with no context gives zeros. With its C entry. Its bytes are half
// the bf16 kernel's (int8 rows plus a 4-byte scale per row).
//
// The TPU's _decode_kernel (modal_examples_tpu/ops/paged_attention.py:72)
// has no int8 branch: the JAX entry paged_decode_attention sends int8 pages
// to _paged_decode_xla (:170), which dequantizes at the query's dtype (bf16)
// in the gather, takes f32 scores and softmax, and rounds the probabilities
// to bf16 for P.V (p.astype(vs.dtype)). This kernel computes that function.
#include "paged_decode.cuh"

__global__ void __launch_bounds__(paged::THREADS) paged_decode_writeback_int8_split_kernel(paged::Params p) {
  paged::decode_split<paged::Int8Page, /*INFLIGHT=*/false, /*ROUND_P=*/true>(p);
}

// The context rows one block takes: the wrapper sizes the grid's split axis
// and the workspace by it.
extern "C" int paged_decode_writeback_int8_split_rows() { return paged::SPLIT; }

extern "C" int paged_decode_writeback_int8(const void* q, const void* k_pages, const void* v_pages,
                                           const void* k_scales, const void* v_scales, const void* page_tables,
                                           const void* context_lens, void* out, void* work, void* tickets, int B,
                                           int Hq, int Hkv, int D, int P, int ps, int pps, int n_split,
                                           float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  paged::Params p{(const __nv_bfloat16*)q, k_pages, v_pages, (const float*)k_scales, (const float*)v_scales,
                  (const int*)page_tables, (const int*)context_lens, nullptr, nullptr, (__nv_bfloat16*)out,
                  (float*)work, (int*)tickets, /*layer=*/0, P, ps, Hkv, Hq / Hkv, D, pps, n_split, sm_scale};
  return paged::launch<paged::Int8Page>(paged_decode_writeback_int8_split_kernel, p, B, Hq, (cudaStream_t)stream);
}

extern "C" const char* paged_decode_writeback_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
