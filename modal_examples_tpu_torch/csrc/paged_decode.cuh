// Paged decode attention for Hopper (sm_90a), the one body of four kernels:
// the ragged decode (paged_decode.cu, bf16 pages; paged_decode_int8.cu, int8
// pages plus one f32 scale per token and kv head), where one decode token per
// sequence attends to its prefix_lens[b] cached rows plus the in-flight
// token, and the write-then-attend decode (paged_decode_writeback.cu,
// paged_decode_writeback_int8.cu), where it attends to the first
// context_lens[b] rows of one layer's pages, the current token already
// written there.
//
// Replaces modal_examples_tpu/ops/paged_attention.py::_decode_kernel_ragged
// ("flat") and ::_decode_kernel_ragged_grouped ("grouped"), both branches
// (bf16 pages; int8 pages :381-392, :602-606), entry
// paged_decode_attention_ragged; and ::_decode_kernel (write-then-attend,
// entry paged_decode_attention, whose int8 pages go to _paged_decode_xla).
// The TPU needed two ragged formulations because its block-diagonal
// all-heads matmul only tiles at Hkv % 16 (% 32 for int8); this body
// computes the same function for any G = Hq / Hkv and D <= 256.
//
// Two compile-time switches pick the function:
//   INFLIGHT  the in-flight token's K/V (bf16, k_new/v_new) is one extra
//             softmax column after the cached rows (the ragged decode); off,
//             there is no column (write-then-attend: the current token is a
//             cached row) and a sequence with no rows gives zeros;
//   ROUND_P   the unnormalised probabilities are rounded to bf16 before P.V,
//             as the TPU kernel's p.astype(v.dtype) (the ragged decode, and
//             the int8 write-then-attend decode, whose JAX function rounds
//             its probabilities to the pages' bf16); off, they stay f32 (the
//             bf16 write-then-attend decode, as the TPU's _decode_kernel).
//
// What is computed: the page table is [B, pps] and the cache [L, P, ps, Hkv,
// D], indexed by the layer scalar (no slice copy; the write-then-attend
// kernels get one layer's view [P, ps, Hkv, D] with layer 0). Scores q.k *
// sm_scale and the softmax are f32; int8 rows are dequantized as
// bf16(bf16(int8) * bf16(scale)); bf16 out.
//
// Bound: bytes. At G = 1 (Llama-2-7B) each byte read feeds 2 FLOPs, far below
// the card's ~295 FLOP/byte ridge, so the tensor cores would buy nothing; the
// limit is bytes in flight (about 3.35 MB across the card, ~25 KB an SM).
// The design does two things about it:
//   1. The context is split across blocks. The grid is (B, Hkv, n_split),
//      n_split = ceil(pps * ps / SPLIT) from the table's width (known on the
//      host, no sync); a block takes rows [s * SPLIT, min((s + 1) * SPLIT,
//      rows)) of its (sequence, kv head) and exits at once when that range
//      is empty. A long context no longer sets the time while the short
//      ones' blocks sit finished: every busy block has at most SPLIT rows.
//   2. Rows are in flight ahead of the math, and each warp works alone. A
//      block's split is four warps' 32-row pieces. Each warp indexes its
//      rows, issues their K as one cp.async group and their V as another
//      (16-byte cp.async.cg copies, neighbouring lanes on neighbouring 16 B
//      of a row, int8 scales as 4-byte copies in the same groups), scores
//      its rows once its own K group has landed, while its V and the other
//      warps' rows are still in flight, then sums P.V once its V has
//      landed: no block barrier from the copies to the warps' partials.
//      That is 64 KB of K+V in flight per block at D = 128 (bf16), 32 KB for
//      int8. cp.async rather than TMA: it reads exactly the context's rows (a
//      TMA box takes a whole page), needs no tensor map per cache tensor,
//      serves both page types with one loop, and at a few FMAs per byte the
//      address arithmetic TMA would save is not what bounds the kernel; int8
//      scales (one f32 a row) are below TMA's 16-byte box anyway.
// The math reads shared memory, each staged row padded so that the stride
// is 16 bytes past a multiple of 128 (a warp reading the same 16 bytes of 8
// rows hits 8 bank groups). Scores: a lane per row, 16 bytes (8 bf16 or 16
// int8 values) at a time against the G query rows of the group (one
// broadcast address across the warp). Softmax: each warp's piece has its own
// max and sum (warp reductions), its f32 probabilities (rounded to bf16 under
// ROUND_P) kept for P.V. P.V: a lane per column over the piece's rows. The
// block's partial is the four pieces merged in warp order.
//
// Measured alternatives (NVIDIA H100 SXM, phase-5 shape): the same split
// staged and scored by the whole block between block barriers, a ring of
// 32-row stages per block with an online softmax per stage, and a ring of
// 8-row stages per warp all ran 0.030-0.047 ms against this design's 0.027
// (bf16 ragged decode); none changed what bounds the kernel (PERF.md).
//
// The folded write (FOLD: the bf16 write-then-attend kernel's second
// instance, launched when fold_k is non-null). The launch also takes R = B
// new rows: row r's K/V [Hkv, D] goes to (page, slot) = (fold_page[r],
// fold_slot[r]) of the layer's pages and sits at position fold_pos[r] of
// sequence r (null: context_lens[r] - 1, a decode step's token); sequences
// come in chains of ``chain`` consecutive rows that share a page table (a
// speculative verify's T chain tokens, one row each; 1 for decode). Two
// rules, one writer and no read-back:
//   * a context row at position pos of sequence r that a row of r's chain
//     writes in this launch (the chain row j = r - (fold_pos[r] - pos), when
//     (fold_page[j], fold_slot[j]) is that row's place in r's table) is
//     staged from fold_k/fold_v row j by the same cp.async that stages the
//     other rows, never read back from the pages (the staging keeps each
//     row's K and V addresses, so the copy loop takes no select);
//   * the block (r, h, last split with rows, or 0) copies row r's head h into
//     the pages after its P.V, 16 bytes a thread, from the copy it staged
//     (it holds the row's position) or else from fold_k/fold_v. One block a
//     (row, head), so no two race, except dead and past-capacity rows, which
//     all target trash page 0, slot 0, as the scatter's do (the same race,
//     never attended by a live sequence).
// So no block reads a place that a block of the launch writes, the writes
// need no ordering inside the launch, and the next launch on the stream sees
// them. The staged bytes are those the scatter would have written: every
// live row's result and every page are bitwise the scatter's followed by
// this kernel's unfolded launch (a dead row attends its own trash write,
// where that sequence attends the last of the racing trash writes).
// Measured (NVIDIA H100 SXM, phase 5's shape, PERF.md): this form costs
// ~1 us over the unfolded launch, against ~2 us for the scatter's launch it
// replaces; a first form (the row copied at the block's start, a select on
// each copy's source) cost 2.2 us, as much as the scatter.
//
// Partials and combine: each block writes its f32 acc[G][D], m[G], l[G] to
// the workspace [B, Hq, n_split, D + 2]. The last block of a (sequence, kv
// head) to take its atomic ticket merges the splits in split order, the
// in-flight column (INFLIGHT) folded in at the end:
//   m = max(m_s, s_new),
//   o = (sum_s e^(m_s - m) acc_s + e^(s_new - m) v_new) / (sum_s e^(m_s - m) l_s + e^(s_new - m)),
// without the column the terms in s_new drop out. It resets the ticket, so
// the per-stream ticket buffer needs no memset (as K7's ring,
// quantized_matmul.cu). The merge reads every split from memory in a fixed
// order, so the result is bitwise equal from run to run whichever block comes
// last. A sequence with no cached rows has no split: block s = 0 writes
// v_new (INFLIGHT) or zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 128;   // cached rows a block takes: a multiple of the page size
constexpr int CHUNK = 32;    // rows a warp takes, a lane each: one softmax piece
constexpr int MAXD = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block can have
static_assert(SPLIT == THREADS && CHUNK == 32, "a thread indexes one row of the split; a warp takes 32");

struct Params {
  const __nv_bfloat16* q;       // [B, Hq, D]
  const void* k_pages;          // [L, P, ps, Hkv, D]
  const void* v_pages;
  const float* k_scales;        // [L, P, ps, Hkv] (int8 pages only)
  const float* v_scales;
  const int* page_tables;       // [B, pps]
  const int* prefix_lens;       // [B] cached rows to attend (the context, without INFLIGHT)
  const __nv_bfloat16* k_new;   // [B, Hkv, D] (INFLIGHT only)
  const __nv_bfloat16* v_new;
  __nv_bfloat16* out;           // [B, Hq, D]
  float* work;                  // [B, Hq, n_split, D + 2]: acc, m, l
  int* tickets;                 // [B * Hkv], zero between launches
  int layer, P, ps, Hkv, G, D, pps, n_split;
  float sm_scale;
  // the folded write (bf16 write-then-attend; fold_k null otherwise)
  const __nv_bfloat16* fold_k;  // [B, Hkv, D] the launch's new rows
  const __nv_bfloat16* fold_v;
  const int* fold_page;         // [B] where each goes in the layer's pages
  const int* fold_slot;
  const int* fold_pos;          // [B] its position in its sequence (null: context_lens - 1)
  int chain;                    // rows a chain, sharing a page table
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

struct Bf16Page {
  using T = __nv_bfloat16;
  static constexpr int VEC = 8;  // values per 16 bytes
  static constexpr bool SCALED = false;
  static __device__ __forceinline__ float scale(float) { return 1.f; }
  static __device__ __forceinline__ float elem(const unsigned char* row, int d, float) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  }
  static __device__ __forceinline__ void unpack(const uint4& raw, float, float (&x)[VEC]) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
};

struct Int8Page {
  using T = int8_t;
  static constexpr int VEC = 16;
  static constexpr bool SCALED = true;
  // bf16(q) * s rounded to bf16, s the row's scale rounded to bf16
  // (scale()): the product of two 8-bit significands is exact in f32, so one
  // rounding gives the bf16 product
  static __device__ __forceinline__ float scale(float raw) { return round_bf16(raw); }
  static __device__ __forceinline__ float elem(const unsigned char* row, int d, float s) {
    return round_bf16((float)reinterpret_cast<const int8_t*>(row)[d] * s);
  }
  static __device__ __forceinline__ void unpack(const uint4& raw, float s, float (&x)[VEC]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = round_bf16((float)(int8_t)(w[k / 4] >> (8 * (k % 4))) * s);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Bytes from one staged row to the next: the row padded so that the stride
// is 16 bytes past a multiple of 128, and the lanes of a warp reading the
// same 16 bytes of 8 neighbouring rows hit 8 distinct bank groups.
template <class Page>
__host__ __device__ inline int row_stride(int D) {
  const int bytes = D * (int)sizeof(typename Page::T);
  return bytes + (144 - bytes % 128) % 128;
}

// Byte offsets of the shared-memory arrays (each a multiple of 16 bytes, as
// D * sizeof(T) is).
template <class Page>
struct Smem {
  size_t row, vrow, k, v, ks, vs, q, kvn, p, red, stat, wst, mw, flag, total;
  __host__ __device__ Smem(int G, int D, int n_split, bool fold = false) {
    const size_t rows = (size_t)SPLIT * row_stride<Page>(D);
    row = 0;                                           // long long [SPLIT] row index of each cached row (FOLD: its K address)
    vrow = row + SPLIT * sizeof(long long);            // FOLD only: [SPLIT] each row's V address
    k = vrow + (fold ? SPLIT * sizeof(long long) : 0);  // T [SPLIT][D], rows row_stride bytes apart
    v = k + rows;                                      // T [SPLIT][D], the same
    ks = v + rows;                                     // float [SPLIT] K scales (int8)
    vs = ks + (Page::SCALED ? SPLIT * sizeof(float) : 0);
    q = vs + (Page::SCALED ? SPLIT * sizeof(float) : 0);  // float [G][D]
    kvn = q + sizeof(float) * G * D;                   // float [2][D]: the in-flight token's K and V
    p = kvn + sizeof(float) * 2 * D;                   // float [WARPS][G][CHUNK] probabilities
    red = p + sizeof(float) * WARPS * G * CHUNK;       // float [WARPS][G][D] the warps' P.V sums
    stat = red + sizeof(float) * WARPS * G * D;        // float [3][G]: s_new, the merge's den and e_new
    wst = stat + sizeof(float) * 3 * G;                // float [2][WARPS][G] the warps' m and l
    mw = wst + sizeof(float) * 2 * WARPS * G;          // float [2][G][n_split]: the merge's weights and l
    flag = mw + sizeof(float) * 2 * G * n_split;       // int: this block merges
    total = flag + 16;
  }
};

// The in-flight token's score against each of the G query rows, one warp
// per query head: s_new[g] = q_g . k_new * sm_scale.
__device__ __forceinline__ void new_scores(const Params& p, const float* q_s, const float* kn_s, float* snew_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < p.G; g += WARPS) {
    float part = 0.f;
    for (int d = lane; d < p.D; d += 32) part = fmaf(q_s[g * p.D + d], kn_s[d], part);
    part = warp_sum(part);
    if (lane == 0) snew_s[g] = part * p.sm_scale;
  }
}

// The merge of a (sequence, kv head)'s n_used split partials with the
// in-flight column (INFLIGHT: its scores in stat[0..G), its V in vn_s). One
// warp per query head finds m, each split's weight e^(m_s - m) and the
// denominator (summed in split order); then threads across (g, d) sum the
// weighted partials in split order, their loads independent of each other.
// Without the column and with no split the denominator is 0 and the result
// zeros.
template <bool INFLIGHT>
__device__ void merge(const Params& p, const float* vn_s, float* stat, float* mw, int n_used) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.G, D = p.D, Hq = p.Hkv * G, ns = p.n_split;
  const float* snew_s = stat;
  float* den_s = stat + G;
  float* enew_s = stat + 2 * G;
  const float* work = p.work + ((size_t)b * Hq + h * G) * ns * (D + 2);
  for (int g = warp; g < G; g += WARPS) {
    const float s_new = INFLIGHT ? snew_s[g] : -INFINITY;
    const float* w = work + (size_t)g * ns * (D + 2);
    float m = s_new;
    for (int s = lane; s < n_used; s += 32) m = fmaxf(m, __ldcg(w + (size_t)s * (D + 2) + D));
    m = warp_max(m);
    for (int s = lane; s < n_used; s += 32) {
      mw[g * ns + s] = expf(__ldcg(w + (size_t)s * (D + 2) + D) - m);
      mw[(G + g) * ns + s] = __ldcg(w + (size_t)s * (D + 2) + D + 1);
    }
    __syncwarp();
    if (lane == 0) {
      const float e_new = INFLIGHT ? expf(s_new - m) : 0.f;
      float den = 0.f;
      for (int s = 0; s < n_used; ++s) den = fmaf(mw[g * ns + s], mw[(G + g) * ns + s], den);
      den_s[g] = den + e_new;
      enew_s[g] = e_new;
    }
  }
  __syncthreads();
  for (int j = tid; j < G * D; j += THREADS) {
    const int g = j / D, d = j % D;
    const float* w = work + (size_t)g * ns * (D + 2) + d;
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_used; ++s) num = fmaf(mw[g * ns + s], __ldcg(w + (size_t)s * (D + 2)), num);
    if (INFLIGHT) num = fmaf(enew_s[g], vn_s[d], num);
    const float den = den_s[g];
    p.out[((size_t)b * Hq + h * G + g) * D + d] = __float2bfloat16((INFLIGHT || den > 0.f) ? num / den : 0.f);
  }
}

// The folded write's copy of sequence b's new row, head h, into (page,
// slot) of the layer's pages: 16 bytes a thread over the block's first 2 x
// D / 8 threads (K, then V), read from its staged copy in shared memory
// (``staged_k``, the V row ``v_from_k`` bytes after it) or else from
// fold_k/fold_v.
template <class T>
__device__ __forceinline__ void write_row(const Params& p, int b, int h, int page, int slot,
                                          const unsigned char* staged_k, size_t v_from_k = 0) {
  const int per = p.D * (int)sizeof(T) / 16, tid = threadIdx.x;
  if (tid >= 2 * per) return;
  const int a = tid / per, v = tid % per;
  const uint4 val = staged_k != nullptr
      ? *reinterpret_cast<const uint4*>(staged_k + (a ? v_from_k : 0) + 16 * v)
      : reinterpret_cast<const uint4*>((a ? p.fold_v : p.fold_k) + ((size_t)b * p.Hkv + h) * p.D)[v];
  const size_t to = (((size_t)p.layer * p.P + page) * p.ps + slot) * p.Hkv + h;
  unsigned char* pages = (unsigned char*)const_cast<void*>(a ? p.v_pages : p.k_pages);
  *reinterpret_cast<uint4*>(pages + to * p.D * sizeof(T) + 16 * v) = val;
}

template <class Page, bool INFLIGHT, bool ROUND_P, bool FOLD = false>
__device__ __forceinline__ void decode_split(const Params& p) {
  static_assert(!FOLD || (!INFLIGHT && !Page::SCALED), "the folded write is the bf16 write-then-attend kernel's");
  using T = typename Page::T;
  constexpr int VEC = Page::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.G, D = p.D, Hq = p.Hkv * G, NV = D / VEC;
  const int cached = min(max(p.prefix_lens[b], 0), p.pps * p.ps);  // rows to attend
  const int n_used = (cached + SPLIT - 1) / SPLIT;
  if (s >= n_used && !(s == 0 && n_used == 0)) return;  // an empty split
  const int writer = max(n_used - 1, 0);  // the split that holds the new row's position
  // the folded write: this sequence's own new row, its place and its
  // position, loaded beside the context length (the staging rule and the
  // writer read them)
  const int mine = FOLD ? (p.fold_pos ? p.fold_pos[b] : p.prefix_lens[b] - 1) : 0;
  const int mpage = FOLD ? p.fold_page[b] : 0, mslot = FOLD ? p.fold_slot[b] : 0;

  const Smem<Page> L(G, D, p.n_split, FOLD);
  const int rs = row_stride<Page>(D);
  long long* row_s = (long long*)(smem + L.row);
  const unsigned char** vsrc_s = (const unsigned char**)(smem + L.vrow);  // FOLD
  unsigned char* k_s = smem + L.k;
  unsigned char* v_s = smem + L.v;
  float* ks_s = (float*)(smem + L.ks);
  float* vs_s = (float*)(smem + L.vs);
  float* q_s = (float*)(smem + L.q);
  float* kn_s = (float*)(smem + L.kvn);
  float* vn_s = kn_s + D;
  float* p_s = (float*)(smem + L.p);
  float* red = (float*)(smem + L.red);
  float* stat = (float*)(smem + L.stat);
  float* snew_s = stat;
  float* wst = (float*)(smem + L.wst);
  float* mw = (float*)(smem + L.mw);
  int* is_last = (int*)(smem + L.flag);

  const __nv_bfloat16* qg = p.q + ((size_t)b * Hq + h * G) * D;  // the group's G rows are contiguous
  for (int i = tid; i < G * D; i += THREADS) q_s[i] = __bfloat162float(qg[i]);
  if (INFLIGHT) {
    const size_t kv_row = ((size_t)b * p.Hkv + h) * D;
    for (int d = tid; d < D; d += THREADS) {
      kn_s[d] = __bfloat162float(p.k_new[kv_row + d]);
      vn_s[d] = __bfloat162float(p.v_new[kv_row + d]);
    }
  }
  if (n_used == 0) {
    if (FOLD) write_row<T>(p, b, h, mpage, mslot, nullptr);
    __syncthreads();
    if (INFLIGHT) new_scores(p, q_s, kn_s, snew_s);
    __syncthreads();
    merge<INFLIGHT>(p, vn_s, stat, mw, 0);
    return;
  }

  // the split's rows: a thread indexes one, and each warp stages its own 32
  // (their K as one cp.async group, then their V, the int8 scales with
  // them), neighbouring lanes on neighbouring 16 bytes of a row
  // (FOLD: the addresses of each row's K and V instead, the new rows'
  // in fold_k/fold_v, so the copies below take no select)
  const int t0 = s * SPLIT, n = min(SPLIT, cached - t0);
  const size_t row_bytes = (size_t)D * sizeof(T);
  if (tid < n) {
    const int pos = t0 + tid;
    const int page = p.page_tables[(size_t)b * p.pps + pos / p.ps];
    const long long row = (((long long)p.layer * p.P + page) * p.ps + pos % p.ps) * p.Hkv + h;
    if (FOLD) {
      const unsigned char* kr = (const unsigned char*)p.k_pages + row * row_bytes;
      const unsigned char* vr = (const unsigned char*)p.v_pages + row * row_bytes;
      const int j = b - (mine - pos);  // the chain row at this position, if any
      if (j >= b - b % p.chain && j <= b) {
        const int fp = j == b ? mpage : p.fold_page[j], fs = j == b ? mslot : p.fold_slot[j];
        if (fp == page && fs == pos % p.ps) {
          kr = (const unsigned char*)(p.fold_k + ((size_t)j * p.Hkv + h) * D);
          vr = (const unsigned char*)(p.fold_v + ((size_t)j * p.Hkv + h) * D);
        }
      }
      row_s[tid] = (long long)kr;
      vsrc_s[tid] = vr;
    } else {
      row_s[tid] = row;
    }
  }
  __syncwarp();
  const int lo = warp * CHUNK, rows = max(0, min(CHUNK, n - lo));
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const unsigned char* src = (const unsigned char*)(a ? p.v_pages : p.k_pages);
    unsigned char* dst = a ? v_s : k_s;
    for (int i = lane; i < rows * NV; i += 32) {
      const int r = lo + i / NV, v = i % NV;
      if (FOLD)
        cp_async16(dst + r * rs + 16 * v, (a ? vsrc_s[r] : (const unsigned char*)row_s[r]) + 16 * v);
      else
        cp_async16(dst + r * rs + 16 * v, src + row_s[r] * row_bytes + 16 * v);
    }
    if (Page::SCALED && lane < rows) cp_async4((a ? vs_s : ks_s) + tid, (a ? p.v_scales : p.k_scales) + row_s[tid]);
    cp_async_commit();
  }
  __syncthreads();  // q_s and kn_s written

  // each warp on its own rows, with no block barrier: scores (a lane per
  // row, 16 bytes at a time against the G query rows, one broadcast address
  // across the warp), its softmax piece (its own max m_w and sum l_w of the
  // f32 probabilities; P.V takes them rounded to bf16 under ROUND_P), then
  // P.V (a lane per column)
  float* pw = p_s + warp * G * CHUNK;
  float* accw = red + warp * G * D;
  float* mw_w = wst + warp * G;
  float* lw_w = wst + (WARPS + warp) * G;
  const bool ok = lane < rows;
  cp_async_wait<1>();
  __syncwarp();  // the warp's K rows have landed
  {
    const unsigned char* kr = k_s + tid * rs;
    const float ksc = Page::SCALED && ok ? Page::scale(ks_s[tid]) : 1.f;
    for (int g = 0; g < G; ++g) {
      const float4* qv = reinterpret_cast<const float4*>(q_s + g * D);
      float a0 = 0.f, a1 = 0.f;
      if (ok) {
#pragma unroll 2
        for (int v = 0; v < NV; ++v) {
          float x[VEC];
          Page::unpack(*reinterpret_cast<const uint4*>(kr + 16 * v), ksc, x);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; e4 += 2) {
            const float4 qa = qv[v * (VEC / 4) + e4], qb = qv[v * (VEC / 4) + e4 + 1];
            a0 = fmaf(qa.x, x[4 * e4], a0);
            a0 = fmaf(qa.y, x[4 * e4 + 1], a0);
            a0 = fmaf(qa.z, x[4 * e4 + 2], a0);
            a0 = fmaf(qa.w, x[4 * e4 + 3], a0);
            a1 = fmaf(qb.x, x[4 * e4 + 4], a1);
            a1 = fmaf(qb.y, x[4 * e4 + 5], a1);
            a1 = fmaf(qb.z, x[4 * e4 + 6], a1);
            a1 = fmaf(qb.w, x[4 * e4 + 7], a1);
          }
        }
      }
      const float sc = ok ? (a0 + a1) * p.sm_scale : -INFINITY;
      const float m = warp_max(sc);
      const float e = ok ? expf(sc - m) : 0.f;
      pw[g * CHUNK + lane] = ROUND_P ? round_bf16(e) : e;
      const float l = warp_sum(e);
      if (lane == 0) {
        mw_w[g] = m;  // -inf for a warp with no rows
        lw_w[g] = l;
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // the warp's V rows have landed, and pw is written
  {
    const float* vs_w = vs_s + lo;
    for (int g = 0; g < G; ++g) {
      float acc[MAXD / 32];
#pragma unroll
      for (int j = 0; j < MAXD / 32; ++j) acc[j] = 0.f;
      for (int r = 0; r < rows; ++r) {
        const unsigned char* vr = v_s + (lo + r) * rs;
        const float pr = pw[g * CHUNK + r], vsc = Page::SCALED ? Page::scale(vs_w[r]) : 1.f;
#pragma unroll
        for (int j = 0; j < MAXD / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[j] = fmaf(pr, Page::elem(vr, d, vsc), acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < MAXD / 32; ++j) {
        const int d = lane + 32 * j;
        if (d < D) accw[g * D + d] = acc[j];
      }
    }
  }
  __syncthreads();
  // the new row into the pages, from its staged copy when this block staged
  // it (the writer holds its position), else from fold_k/fold_v
  if (FOLD && s == writer) {
    const int r = mine - t0;
    const unsigned char* mk = (const unsigned char*)(p.fold_k + ((size_t)b * p.Hkv + h) * D);
    const bool staged = r >= 0 && r < n && (const unsigned char*)row_s[r] == mk;
    write_row<T>(p, b, h, mpage, mslot, staged ? smem + L.k + (size_t)r * rs : nullptr, L.v - L.k);
  }

  // the block's partial: the warps' pieces merged in warp order
  float* w = p.work + ((size_t)b * Hq + h * G) * p.n_split * (D + 2);
  for (int j = tid; j < G * D; j += THREADS) {
    const int g = j / D, d = j % D;
    float m = -INFINITY;
    for (int k = 0; k < WARPS; ++k) m = fmaxf(m, wst[k * G + g]);
    float a = 0.f;
    for (int k = 0; k < WARPS; ++k) a = fmaf(expf(wst[k * G + g] - m), red[(k * G + g) * D + d], a);
    w[((size_t)g * p.n_split + s) * (D + 2) + d] = a;
  }
  for (int g = tid; g < G; g += THREADS) {
    float m = -INFINITY, l = 0.f;
    for (int k = 0; k < WARPS; ++k) m = fmaxf(m, wst[k * G + g]);
    for (int k = 0; k < WARPS; ++k) l = fmaf(expf(wst[k * G + g] - m), wst[(WARPS + k) * G + g], l);
    w[((size_t)g * p.n_split + s) * (D + 2) + D] = m;
    w[((size_t)g * p.n_split + s) * (D + 2) + D + 1] = l;
  }

  // the in-flight token's scores, ready for the merge
  if (INFLIGHT) new_scores(p, q_s, kn_s, snew_s);

  // the last split of this (sequence, kv head) to finish merges them all
  // (a lone split merges at once, with no ticket)
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + (size_t)b * p.Hkv + h;
  if (n_used > 1) {
    if (tid == 0) *is_last = atomicAdd(ticket, 1) == n_used - 1;
    __syncthreads();
    if (!*is_last) return;
    __threadfence();
  }
  merge<INFLIGHT>(p, vn_s, stat, mw, n_used);
  if (tid == 0 && n_used > 1) *ticket = 0;
}

// Checks the shapes, sizes shared memory and launches ``kernel`` over (B,
// Hkv, n_split). Returns a cudaError_t.
template <class Page>
int launch(void (*kernel)(Params), const Params& p, int B, int Hq, cudaStream_t stream) {
  if (p.D > MAXD || p.D <= 0 || p.D % Page::VEC != 0 || p.Hkv <= 0 || Hq % p.Hkv != 0 || p.Hkv > 65535 ||
      p.ps <= 0 || p.n_split <= 0 || p.n_split > 65535 || p.n_split * SPLIT < p.pps * p.ps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = Smem<Page>(p.G, p.D, p.n_split, p.fold_k != nullptr).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, p.Hkv, p.n_split);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace paged
