// Ragged paged decode attention over an int8 KV cache for Hopper (sm_90a):
// one decode token per sequence attends to its cached prefix pages (int8
// rows plus one f32 scale per token and kv head) plus the in-flight token.
//
// Replaces the int8 branch of modal_examples_tpu/ops/paged_attention.py::
// _decode_kernel_ragged ("flat", :381-392) and ::_decode_kernel_ragged_grouped
// ("grouped", :602-606), entry paged_decode_attention_ragged with a
// QuantizedKV cache. As there, each page row is dequantized at the query's
// dtype: the scale rounded to bf16, the product bf16(int8) * bf16(scale)
// rounded to bf16; then the same f32 online softmax as paged_decode.cu. The
// in-flight token's K/V arrive in bf16, not quantized.
//
// Bound: bytes, half those of the bf16 kernel (int8 rows plus a 4-byte scale
// per row and kv head). The design is paged_decode.cu's: one block per
// (sequence, kv head), so the G query heads of a GQA group share every row
// read; the block reads its own page-table entries and prefix length and
// offsets into the full [L, P, ps, Hkv, D] cache by the layer index; it reads
// the prefix's rows and no more (not the rest of its last page). Each chunk's K and V scales are read once
// into shared memory beside the row offsets; the score loop reads a K row as
// 4 bytes a lane, the P.V loop a V row across the threads.
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

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// bf16(q) * s rounded to bf16, s already a bf16 value: the product of two
// 8-bit significands is exact in f32, so one rounding gives the bf16 product
__device__ __forceinline__ float dequant(int q, float s) { return round_bf16((float)q * s); }

__global__ void __launch_bounds__(THREADS) paged_decode_int8_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const int8_t* __restrict__ k_pages,         // [L, P, ps, Hkv, D]
    const int8_t* __restrict__ v_pages,
    const float* __restrict__ k_scales,         // [L, P, ps, Hkv]
    const float* __restrict__ v_scales,
    const int* __restrict__ page_tables,        // [B, pps]
    const int* __restrict__ prefix_lens,        // [B] tokens already in the cache
    const __nv_bfloat16* __restrict__ k_new,    // [B, Hkv, D]
    const __nv_bfloat16* __restrict__ v_new,
    __nv_bfloat16* __restrict__ out,            // [B, Hq, D]
    int layer, int P, int ps, int Hkv, int G, int D, int pps, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = (long long*)smem_raw;      // [CHUNK] (token, kv head) row index of each cached token
  float* ks_s = (float*)(row_s + CHUNK);        // [CHUNK] its K scale, rounded to bf16
  float* vs_s = ks_s + CHUNK;                   // [CHUNK] its V scale, rounded to bf16
  float* q_s = vs_s + CHUNK;                    // [G][D]
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
      const long long row = (((long long)layer * P + page) * ps + pos % ps) * Hkv + h;
      row_s[t] = row;
      ks_s[t] = round_bf16(k_scales[row]);
      vs_s[t] = round_bf16(v_scales[row]);
    }
    __syncthreads();

    // scores: one warp per cached token, 4 bytes of the K row a lane; the
    // row is read once and scored against all G query heads of the group
    for (int t = warp; t < n; t += WARPS) {
      const int8_t* kr = k_pages + row_s[t] * D;
      const float ks = ks_s[t];
      float kv[MAXD / 32];
#pragma unroll
      for (int j = 0; j < MAXD / 128; ++j) {
        const int d = 4 * lane + 128 * j;
        const char4 c = d < D ? *reinterpret_cast<const char4*>(kr + d) : make_char4(0, 0, 0, 0);
        kv[4 * j] = dequant(c.x, ks);
        kv[4 * j + 1] = dequant(c.y, ks);
        kv[4 * j + 2] = dequant(c.z, ks);
        kv[4 * j + 3] = dequant(c.w, ks);
      }
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MAXD / 128; ++j) {
          const int d = 4 * lane + 128 * j;
          if (d < D) {
#pragma unroll
            for (int e = 0; e < 4; ++e) part = fmaf(q_s[g * D + d + e], kv[4 * j + e], part);
          }
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
        p_s[g * CHUNK + t] = round_bf16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: threads across (g, d); neighbouring threads read neighbouring
    // bytes of one V row
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < n; ++t)
        a = fmaf(p_s[g * CHUNK + t], dequant(v_pages[row_s[t] * D + d], vs_s[t]), a);
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

extern "C" int paged_decode_int8(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scales, const void* v_scales, const void* page_tables,
                                 const void* prefix_lens, const void* k_new, const void* v_new, void* out,
                                 int B, int Hq, int Hkv, int D, int layer, int P, int ps, int pps,
                                 float sm_scale, void* stream) {
  if (D > MAXD || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = Hq / Hkv;
  const size_t smem = CHUNK * sizeof(long long) +
                      sizeof(float) * (2 * (size_t)CHUNK + 2 * (size_t)G * D + (size_t)G * CHUNK + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_int8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pages, (const int8_t*)v_pages,
      (const float*)k_scales, (const float*)v_scales, (const int*)page_tables,
      (const int*)prefix_lens, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (__nv_bfloat16*)out, layer, P, ps, Hkv, G, D, pps, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* paged_decode_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
