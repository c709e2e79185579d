// Write-then-attend paged decode attention over bf16 pages for Hopper
// (sm_90a): one decode token per sequence attends to the first
// context_lens[b] rows of ONE layer's pages [P, ps, Hkv, D] (the contiguous
// view pages[li] of the [L, P, ...] cache, passed as layer 0), the current
// token already written there. The instantiation of paged_decode.cuh
// (design, bound and numerics there) with no in-flight column and the
// probabilities kept in f32 in P.V, as the TPU kernel keeps them; a
// sequence with no context gives zeros. With its C entry.
//
// Replaces modal_examples_tpu/ops/paged_attention.py::_decode_kernel (the
// write-then-attend kernel, entry paged_decode_attention(impl="pallas")).
// The TPU kernel streamed whole pages (all heads) into VMEM with two DMA
// slots, one grid step per sequence, and masked off-head columns so that one
// MXU product covered every head; here the context is split across blocks
// of (sequence, kv head), rows streamed by cp.async.
#include "paged_decode.cuh"

__global__ void __launch_bounds__(paged::THREADS) paged_decode_writeback_split_kernel(paged::Params p) {
  paged::decode_split<paged::Bf16Page, /*INFLIGHT=*/false, /*ROUND_P=*/false>(p);
}

// The context rows one block takes: the wrapper sizes the grid's split axis
// and the workspace by it.
extern "C" int paged_decode_writeback_split_rows() { return paged::SPLIT; }

extern "C" int paged_decode_writeback(const void* q, const void* k_pages, const void* v_pages,
                                      const void* page_tables, const void* context_lens, void* out, void* work,
                                      void* tickets, int B, int Hq, int Hkv, int D, int P, int ps, int pps,
                                      int n_split, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  paged::Params p{(const __nv_bfloat16*)q, k_pages, v_pages, nullptr, nullptr, (const int*)page_tables,
                  (const int*)context_lens, nullptr, nullptr, (__nv_bfloat16*)out, (float*)work, (int*)tickets,
                  /*layer=*/0, P, ps, Hkv, Hq / Hkv, D, pps, n_split, sm_scale};
  return paged::launch<paged::Bf16Page>(paged_decode_writeback_split_kernel, p, B, Hq, (cudaStream_t)stream);
}

extern "C" const char* paged_decode_writeback_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
