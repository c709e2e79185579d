// Flash attention forward for Hopper (sm_90a): blockwise causal or full
// attention with an online softmax, GQA, and a query offset for a prompt
// chunk attending to a longer K/V.
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_fwd_kernel (driven by
// _flash_forward; entries flash_attention, flash_attention_with_lse,
// flash_attention_chunked). The TPU kernel carried m, l and acc in VMEM
// scratch across a sequential k-block grid axis; Hopper blocks run in no
// order, so here one block owns a (batch, query head, 64-row query tile) and
// loops over the key tiles itself, up to the causal limit (fully masked key
// tiles are skipped, as on the TPU). The ragged edge (lengths that are not a
// multiple of 64) is masked in-kernel, so every shape is accepted.
//
// Numerics follow the TPU kernel: q is scaled in f32 before Q.K^T, scores,
// m, l, P and the P.V accumulation are all f32; o is rounded to the input
// dtype once at the end, and lse = m + log(l) is written per row.
//
// Bound: operations at prefill lengths (4*S*Skv*D/2 FLOPs against
// 2*(S+Skv)*D*2 bytes per head). This first kernel runs the products as f32
// FMAs from shared memory (64x64 tiles, each thread a 4x4 score block and a
// 4 x D/16 output block, padded rows so column reads hit distinct banks); it
// does not reach the tensor cores. Moving Q.K^T and P.V onto wgmma with TMA
// tile loads is the work of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4ty..4ty+3, tx columns tx + 16j
constexpr int PP = BK + 1;    // padded probability row

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * PP;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, S, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, Skv, D]
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ o,        // [B, Hq, S, D]
    float* __restrict__ lse,              // [B, Hq, S]
    int Hq, int Hkv, int S, int Skv, int q_offset, int causal, float sm_scale) {
  constexpr int QP = D + 1;
  constexpr int KP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // [BQ][QP]
  float* k_s = q_s + BQ * QP;   // [BK][KP]
  float* v_s = k_s + BK * KP;   // [BK][D]
  float* p_s = v_s + BK * D;    // [BQ][PP]

  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_base = ((size_t)b * Hq + hq) * S;
  const size_t kv_base = ((size_t)b * Hkv + hkv) * Skv;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    q_s[r * QP + d] =
        q0 + r < S ? __bfloat162float(q[(q_base + q0 + r) * D + d]) * sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q_offset + q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // q_s written, or the previous tile's reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const bool ok = k0 + t < Skv;
      const size_t src = (kv_base + k0 + t) * D + d;
      k_s[t * KP + d] = ok ? __bfloat162float(k[src]) : 0.f;
      v_s[i] = ok ? __bfloat162float(v[src]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask and online softmax; the 16 threads of a half-warp share rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_offset + q0 + ty * 4 + i;  // global query position
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= Skv || (causal && col > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        p_s[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = v_s[t * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[(q_base + r) * D + tx + 16 * c] = __float2bfloat16(acc[i][c] * inv);
    if (tx == 0) lse[q_base + r] = l[i] > 0.f ? m[i] + logf(l_safe) : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int S, int Skv, int q_offset, int causal,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, Hq, Hkv, S, Skv, q_offset, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Hq, int Hkv, int S, int Skv,
                         int D, int q_offset, int causal, float sm_scale,
                         void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 256: return launch<256>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
