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
//
// Folded write (fold_k non-null): the launch also writes each sequence's new
// K/V rows into the pages and attends with them (paged_decode.cuh, "The
// folded write"), in place of the page scatter (kv_scatter.cu) over the
// one-layer view that the write-then-attend step launched before it: at a
// decode step 8 x 2 x 4096 bf16 (128 KB) a launch, whose own launch was most
// of its time (its byte bound is 0.00008 ms).
#include "paged_decode.cuh"

__global__ void __launch_bounds__(paged::THREADS) paged_decode_writeback_split_kernel(paged::Params p) {
  paged::decode_split<paged::Bf16Page, /*INFLIGHT=*/false, /*ROUND_P=*/false>(p);
}

// The same with the folded write (an instance of its own, so the launch
// without new rows runs the kernel as it was).
__global__ void __launch_bounds__(paged::THREADS) paged_decode_writeback_fold_kernel(paged::Params p) {
  paged::decode_split<paged::Bf16Page, /*INFLIGHT=*/false, /*ROUND_P=*/false, /*FOLD=*/true>(p);
}

// The context rows one block takes: the wrapper sizes the grid's split axis
// and the workspace by it.
extern "C" int paged_decode_writeback_split_rows() { return paged::SPLIT; }

// The folded write's C entry takes the new rows (fold_k, fold_v [B, Hkv, D]
// bf16), their places (fold_page, fold_slot [B] int32), their positions
// (fold_pos [B] int32, or null for context_lens - 1) and the chain length;
// fold_k null launches the kernel without the write.
extern "C" int paged_decode_writeback(const void* q, const void* k_pages, const void* v_pages,
                                      const void* page_tables, const void* context_lens, void* out, void* work,
                                      void* tickets, const void* fold_k, const void* fold_v, const void* fold_page,
                                      const void* fold_slot, const void* fold_pos, int chain, int B, int Hq,
                                      int Hkv, int D, int P, int ps, int pps, int n_split, float sm_scale,
                                      void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (fold_k != nullptr && (fold_v == nullptr || fold_page == nullptr || fold_slot == nullptr || chain <= 0 ||
                            B % chain != 0))
    return (int)cudaErrorInvalidValue;
  paged::Params p{(const __nv_bfloat16*)q, k_pages, v_pages, nullptr, nullptr, (const int*)page_tables,
                  (const int*)context_lens, nullptr, nullptr, (__nv_bfloat16*)out, (float*)work, (int*)tickets,
                  /*layer=*/0, P, ps, Hkv, Hq / Hkv, D, pps, n_split, sm_scale,
                  (const __nv_bfloat16*)fold_k, (const __nv_bfloat16*)fold_v, (const int*)fold_page,
                  (const int*)fold_slot, (const int*)fold_pos, chain};
  return paged::launch<paged::Bf16Page>(
      fold_k != nullptr ? paged_decode_writeback_fold_kernel : paged_decode_writeback_split_kernel, p, B, Hq,
      (cudaStream_t)stream);
}

// 1: this library's entry takes the folded write (benchmarks_torch/kernel_ab.py
// tells it from an older tree's)
extern "C" int paged_decode_writeback_folds() { return 1; }

extern "C" const char* paged_decode_writeback_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
