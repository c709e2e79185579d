// Write-then-attend paged decode attention for Hopper (sm_90a): one decode
// token per sequence attends to the first context_lens[b] rows of its pages,
// the current token already written there.
//
// Replaces modal_examples_tpu/ops/paged_attention.py::_decode_kernel (the
// legacy write-then-attend kernel, entry paged_decode_attention(impl=
// "pallas")). It reads ONE layer's pages [P, ps, Hkv, D] (the contiguous
// view pages[li] of the [L, P, ...] cache); unlike the ragged kernel
// (paged_decode.cu) there is no in-flight column: context_lens counts the
// current token, whose K/V the caller wrote into the cache first.
//
// Bound: bytes. Each query head reads its kv head's context rows once (two
// FLOPs per byte, far below the card's ridge). The TPU kernel streamed whole
// pages (all heads) into VMEM with two DMA slots and masked off-head columns
// so one MXU product covered every head; neither carries over. Here each
// (sequence, kv head) owns a block, so the G query heads of a GQA group share
// every K/V row read. The block stages up to CHUNK context rows of its head
// (whole pages when ps divides CHUNK) in shared memory with 16-byte vector
// loads, scores them with one warp per row, runs the f32 online softmax with
// one warp per query head, and accumulates P.V in f32 with the probabilities
// kept in f32, as the TPU kernel keeps them. The result is divided by the
// softmax sum; a sequence with no context (l == 0) gives zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;  // context rows per online-softmax step
constexpr int MAXD = 256;  // largest head dim the score loop holds in registers
constexpr int VEC = 8;     // bf16 values per 16-byte load

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(THREADS) paged_decode_writeback_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, Hkv, D]: one layer
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ page_tables,        // [B, pps]
    const int* __restrict__ context_lens,       // [B] rows to attend, current token included
    __nv_bfloat16* __restrict__ out,            // [B, Hq, D]
    int ps, int Hkv, int G, int D, int pps, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = (__nv_bfloat16*)smem_raw;  // [CHUNK][D]
  __nv_bfloat16* v_s = k_s + CHUNK * D;           // [CHUNK][D]
  float* q_s = (float*)(v_s + CHUNK * D);         // [G][D] q * sm_scale
  float* acc = q_s + G * D;                       // [G][D]
  float* p_s = acc + G * D;                       // [G][CHUNK] scores, then probabilities
  float* m_s = p_s + G * CHUNK;                   // [G] running max
  float* l_s = m_s + G;                           // [G] running sum
  float* a_s = l_s + G;                           // [G] this chunk's rescale factor

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;
  const int vpr = D / VEC;  // 16-byte vectors per row

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    q_s[i] = __bfloat162float(q[((size_t)b * Hq + h * G + g) * D + d]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int ctx = min(max(context_lens[b], 0), pps * ps);
  for (int t0 = 0; t0 < ctx; t0 += CHUNK) {
    const int n = min(CHUNK, ctx - t0);
    __syncthreads();  // init done, or the previous chunk's P.V reads are done
    // stage the chunk's K and V rows of this head: 16 bytes a thread,
    // neighbouring threads on neighbouring addresses of one row
#pragma unroll 4
    for (int i = tid; i < n * vpr; i += THREADS) {
      const int t = i / vpr, c = i % vpr;
      const int pos = t0 + t;
      const int page = page_tables[(size_t)b * pps + pos / ps];
      const size_t src = (((size_t)page * ps + pos % ps) * Hkv + h) * D + (size_t)c * VEC;
      *(uint4*)(k_s + t * D + c * VEC) = *(const uint4*)(k_pages + src);
      *(uint4*)(v_s + t * D + c * VEC) = *(const uint4*)(v_pages + src);
    }
    __syncthreads();

    // scores: one warp per row, lanes across D; each row scored against all
    // G query heads of the group
    for (int t = warp; t < n; t += WARPS) {
      const __nv_bfloat16* kr = k_s + t * D;
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
        if (lane == 0) p_s[g * CHUNK + t] = part;
      }
    }
    __syncthreads();

    // online softmax in f32: one warp per query head; every row here is < ctx
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
        const float p = expf(p_s[g * CHUNK + t] - m_safe);
        sum += p;
        p_s[g * CHUNK + t] = p;  // kept in f32
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
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(p_s[g * CHUNK + t], __bfloat162float(v_s[t * D + d]), a);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const float l = l_s[g];
    out[((size_t)b * Hq + h * G + g) * D + d] = __float2bfloat16(l > 0.f ? acc[i] / l : 0.f);
  }
}

}  // namespace

extern "C" int paged_decode_writeback(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_tables,
                                      const void* context_lens, void* out,
                                      int B, int Hq, int Hkv, int D, int ps,
                                      int pps, float sm_scale, void* stream) {
  if (D > MAXD || D % VEC != 0 || Hkv <= 0 || Hq % Hkv != 0 || Hkv > 65535 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = Hq / Hkv;
  const size_t smem = 2 * (size_t)CHUNK * D * sizeof(__nv_bfloat16) +
                      sizeof(float) * (2 * (size_t)G * D + (size_t)G * CHUNK + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_writeback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_writeback_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)page_tables,
      (const int*)context_lens, (__nv_bfloat16*)out, ps, Hkv, G, D, pps,
      sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* paged_decode_writeback_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
