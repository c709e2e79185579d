// Flash attention backward, dQ, for Hopper (sm_90a): causal or full
// self-attention with GQA.
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dq_kernel (per-block
// math in _bwd_block_ds; driven by _flash_backward). With
// P = exp(scale * Q.K^T - lse) and dS = P * (dO.V^T - delta + dlse),
// dQ = scale * dS.K. The TPU kernel carried dQ in VMEM scratch across a
// sequential key-block grid axis; Hopper blocks run in no order, so here one
// block owns a (batch, query head, 64-row query tile), loops over the key
// tiles up to the causal limit itself (tiles wholly above the diagonal are
// skipped, as on the TPU), keeps dQ in f32 registers and writes it once.
// Rows past S and keys past S are masked in-kernel, so every S is accepted;
// a row whose lse is -inf (fully masked) gets P = 0 and a zero gradient.
//
// Inputs: q, k, v, dO bf16 ([B, Hq, S, D] and [B, Hkv, S, D]); lse, delta,
// dlse f32 [B, Hq, S]. Output dQ bf16 [B, Hq, S, D].
//
// Bound: operations (three products of S*S*D/2 per head when causal, against
// about 8*S*D bytes per head). This first kernel runs the products as f32
// FMAs from shared memory, like flash_fwd.cu: bf16 tiles (rows padded to an
// odd number of 32-bit words, so column reads hit distinct banks), each of
// 256 threads a 4x4 block of scores and a 4 x D/16 block of dQ. Moving the
// products onto wgmma with TMA tile loads is the work of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4ty..4ty+3, tx columns tx + 16j
constexpr int PP = BK + 1;    // padded dS row (floats)

template <int D>
constexpr int kRowPad = D + 2;  // bf16 elements: D/2 + 1 words, odd

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ + 2 * BK) * kRowPad<D> * sizeof(__nv_bfloat16) +
         (size_t)BQ * PP * sizeof(float);
}

// rows [r0, r0 + 64) of a [S, D] bf16 matrix into a padded tile, zeros past S
template <int D>
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                          int r0, int S, int tid) {
  constexpr int RP = kRowPad<D>;
  constexpr int W = D / 2;  // 32-bit words per row
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int i = tid; i < 64 * W; i += THREADS) {
    const int r = i / W, w = i % W;
    const __nv_bfloat162 val =
        r0 + r < S ? reinterpret_cast<const __nv_bfloat162*>(src + (size_t)(r0 + r) * D)[w] : zero;
    reinterpret_cast<__nv_bfloat162*>(dst + r * RP)[w] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, S, D]
    const __nv_bfloat16* __restrict__ k,   // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dO,  // [B, Hq, S, D]
    const float* __restrict__ lse,         // [B, Hq, S]
    const float* __restrict__ delta,
    const float* __restrict__ dlse,
    __nv_bfloat16* __restrict__ dq,        // [B, Hq, S, D]
    int Hq, int Hkv, int S, int causal, float sm_scale) {
  constexpr int RP = kRowPad<D>;
  constexpr int RW = RP / 2;  // padded row in 32-bit words
  constexpr int DC = D / 16;  // dQ columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][RP]
  __nv_bfloat16* do_s = q_s + BQ * RP;                                // [BQ][RP]
  __nv_bfloat16* k_s = do_s + BQ * RP;                                // [BK][RP]
  __nv_bfloat16* v_s = k_s + BK * RP;                                 // [BK][RP]
  float* ds_s = reinterpret_cast<float*>(v_s + BK * RP);              // [BQ][PP]

  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_base = ((size_t)b * Hq + hq) * S;
  const size_t kv_base = ((size_t)b * Hkv + hkv) * S;

  load_tile<D>(q_s, q + q_base * D, q0, S, tid);
  load_tile<D>(do_s, dO + q_base * D, q0, S, tid);

  // per-row statistics; rows past S act as fully masked
  float lse_r[4], dd_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < S ? lse[q_base + r] : -INFINITY;
    dd_r[i] = r < S ? dlse[q_base + r] - delta[q_base + r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const __nv_bfloat162* q_w = reinterpret_cast<const __nv_bfloat162*>(q_s);
  const __nv_bfloat162* do_w = reinterpret_cast<const __nv_bfloat162*>(do_s);
  const __nv_bfloat162* k_w = reinterpret_cast<const __nv_bfloat162*>(k_s);
  const __nv_bfloat162* v_w = reinterpret_cast<const __nv_bfloat162*>(v_s);

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // q/dO tiles written, or the previous tile's reads are done
    load_tile<D>(k_s, k + kv_base * D, k0, S, tid);
    load_tile<D>(v_s, v + kv_base * D, k0, S, tid);
    __syncthreads();

    // s = Q.K^T and dp = dO.V^T for this thread's 4x4 block
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int w = 0; w < D / 2; ++w) {
      float2 qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = __bfloat1622float2(q_w[(ty * 4 + i) * RW + w]);
        dov[i] = __bfloat1622float2(do_w[(ty * 4 + i) * RW + w]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = __bfloat1622float2(k_w[(tx + 16 * j) * RW + w]);
        vv[j] = __bfloat1622float2(v_w[(tx + 16 * j) * RW + w]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
          dp[i][j] = fmaf(dov[i].x, vv[j].x, fmaf(dov[i].y, vv[j].y, dp[i][j]));
        }
    }

    // dS = P * (dP - delta + dlse), with masked and ragged entries zero
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const bool row_live = isfinite(lse_r[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = row_live && col < S && !(causal && col > row);
        const float p = live ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        ds_s[(ty * 4 + i) * PP + tx + 16 * j] = p * (dp[i][j] + dd_r[i]);
      }
    }
    __syncthreads();

    // dQ += dS.K
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty * 4 + i) * PP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = __bfloat162float(k_s[t * RP + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[(q_base + r) * D + tx + 16 * c] = __float2bfloat16(acc[i][c] * sm_scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const void* lse, const void* delta, const void* dlse, void* dq,
           int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dO, (const float*)lse, (const float*)delta,
      (const float*)dlse, (__nv_bfloat16*)dq, Hq, Hkv, S, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dO, const void* lse, const void* delta,
                            const void* dlse, void* dq, int B, int Hq, int Hkv,
                            int S, int D, int causal, float sm_scale,
                            void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, dO, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, dO, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, dO, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    case 256: return launch<256>(q, k, v, dO, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
