// Ragged paged decode attention for Hopper (sm_90a): one decode token per
// sequence attends to its cached prefix pages plus the in-flight token.
//
// Replaces modal_examples_tpu/ops/paged_attention.py::_decode_kernel_ragged
// ("flat") and ::_decode_kernel_ragged_grouped ("grouped"), entry
// paged_decode_attention_ragged. The TPU needed two formulations because its
// block-diagonal all-heads matmul only tiles at Hkv % 16; this kernel computes
// the same function for any Hkv, so one kernel closes both.
//
// Bound: bytes. Each query head reads its kv head's prefix rows once (two
// FLOPs per byte, far below the card's ridge). The design gives each
// (sequence, kv head) its own block so the G query heads of a GQA group share
// every K/V row read; the block reads its own page-table entries and prefix
// length and offsets into the full [L, P, ps, Hkv, D] cache by the layer
// index (no slice copy, no gather). It reads exactly the prefix's rows, not
// the rest of its last page. The softmax is online in f32 over chunks of
// cached tokens; the in-flight token's K/V (not yet in the cache) is one
// extra softmax column folded in at the end, as the TPU kernel's epilogue
// does. Probabilities enter the P.V product at bf16, the cache precision.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;   // cached tokens per online-softmax step
constexpr int MAXD = 256;   // largest head dim the score loop holds in registers

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const __nv_bfloat16* __restrict__ k_pages,  // [L, P, ps, Hkv, D]
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ page_tables,        // [B, pps]
    const int* __restrict__ prefix_lens,        // [B] tokens already in the cache
    const __nv_bfloat16* __restrict__ k_new,    // [B, Hkv, D]
    const __nv_bfloat16* __restrict__ v_new,
    __nv_bfloat16* __restrict__ out,            // [B, Hq, D]
    int layer, int P, int ps, int Hkv, int G, int D, int pps, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = (long long*)smem_raw;      // [CHUNK] element offset of each cached row
  float* q_s = (float*)(row_s + CHUNK);         // [G][D]
  float* acc = q_s + G * D;                     // [G][D]
  float* p_s = acc + G * D;                     // [G][CHUNK] scores, then probabilities
  float* m_s = p_s + G * CHUNK;                 // [G] running max
  float* l_s = m_s + G;                         // [G] running sum
  float* a_s = l_s + G;                         // [G] this chunk's rescale factor

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    q_s[i] = __bfloat162float(q[((size_t)b * Hq + h * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int prefix = prefix_lens[b];
  for (int t0 = 0; t0 < prefix; t0 += CHUNK) {
    const int n = min(CHUNK, prefix - t0);
    __syncthreads();  // init done, or the previous chunk's P.V reads are done
    for (int t = tid; t < n; t += THREADS) {
      const int pos = t0 + t;
      const int page = page_tables[(size_t)b * pps + pos / ps];
      row_s[t] = ((((long long)layer * P + page) * ps + pos % ps) * Hkv + h) * D;
    }
    __syncthreads();

    // scores: one warp per cached token, lanes across D; the row is read once
    // and scored against all G query heads of the group
    for (int t = warp; t < n; t += WARPS) {
      const __nv_bfloat16* kr = k_pages + row_s[t];
      float kv[MAXD / 32];
#pragma unroll
      for (int j = 0; j < MAXD / 32; ++j) {
        const int d = lane + 32 * j;
        kv[j] = d < D ? __bfloat162float(kr[d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MAXD / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) part = fmaf(q_s[g * D + d], kv[j], part);
        }
        part = warp_sum(part);
        if (lane == 0) p_s[g * CHUNK + t] = part * sm_scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, p_s[g * CHUNK + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float s = p_s[g * CHUNK + t];
        const float p = s == -INFINITY ? 0.f : expf(s - m_safe);
        sum += p;
        p_s[g * CHUNK + t] = __bfloat162float(__float2bfloat16(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: threads across (g, d); neighbouring threads read neighbouring d
    // of one V row
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < n; ++t)
        a = fmaf(p_s[g * CHUNK + t], __bfloat162float(v_pages[row_s[t] + d]), a);
      acc[i] = a;
    }
  }
  __syncthreads();

  // the in-flight token: one extra softmax column, then normalise
  const __nv_bfloat16* kn = k_new + ((size_t)b * Hkv + h) * D;
  const __nv_bfloat16* vn = v_new + ((size_t)b * Hkv + h) * D;
  for (int g = warp; g < G; g += WARPS) {
    float part = 0.f;
    for (int d = lane; d < D; d += 32) part = fmaf(q_s[g * D + d], __bfloat162float(kn[d]), part);
    const float s_new = warp_sum(part) * sm_scale;
    const float m_prev = m_s[g];
    const float m_new = fmaxf(m_prev, s_new);
    const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
    const float p_new = expf(s_new - m_new);
    const float l = l_s[g] * alpha + p_new;
    const float inv = 1.f / (l > 0.f ? l : 1.f);
    __nv_bfloat16* o = out + ((size_t)b * Hq + h * G + g) * D;
    for (int d = lane; d < D; d += 32)
      o[d] = __float2bfloat16((acc[g * D + d] * alpha + p_new * __bfloat162float(vn[d])) * inv);
  }
}

}  // namespace

extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_tables,
                            const void* prefix_lens, const void* k_new,
                            const void* v_new, void* out, int B, int Hq,
                            int Hkv, int D, int layer, int P, int ps, int pps,
                            float sm_scale, void* stream) {
  if (D > MAXD || Hkv <= 0 || Hq % Hkv != 0 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = Hq / Hkv;
  const size_t smem = CHUNK * sizeof(long long) +
                      sizeof(float) * (2 * (size_t)G * D + (size_t)G * CHUNK + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)page_tables,
      (const int*)prefix_lens, (const __nv_bfloat16*)k_new,
      (const __nv_bfloat16*)v_new, (__nv_bfloat16*)out, layer, P, ps, Hkv, G,
      D, pps, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
