// Flash attention backward, dK and dV, for Hopper (sm_90a): causal or full
// self-attention with GQA.
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dkv_kernel (per-block
// math in _bwd_block_ds; driven by _flash_backward). With
// P = exp(scale * Q.K^T - lse) and dS = P * (dO.V^T - delta + dlse),
// dV = P^T.dO and dK = scale * dS^T.Q. The TPU kernel ran per QUERY head,
// carrying dK/dV in VMEM scratch across a sequential query-block grid axis,
// wrote [B*Hq, S, D] per-head results and left the GQA group sum to XLA.
// Here one block owns a (batch, kv head, 64-row key tile), loops over the
// group's query heads and, for each, over the query tiles from the causal
// diagonal on (tiles wholly below it in key order are skipped, as on the
// TPU), and accumulates dK and dV for the kv head in f32 registers: no
// per-query-head intermediate, one rounding at the single write.
// Rows past S are masked in-kernel, so every S is accepted; a query row whose
// lse is -inf (fully masked) contributes nothing.
//
// Inputs: q, k, v, dO bf16 ([B, Hq, S, D] and [B, Hkv, S, D]); lse, delta,
// dlse f32 [B, Hq, S]. Outputs dK, dV bf16 [B, Hkv, S, D].
//
// Bound: operations (four products of S*S*D/2 per query head when causal,
// against about 8*S*D bytes per query head). This first kernel runs the
// products as f32 FMAs from shared memory, like flash_fwd.cu: bf16 tiles
// (rows padded to an odd number of 32-bit words), each of 256 threads a 4x4
// block of P^T/dS^T and 4 x D/16 blocks of dK and dV. Moving the products
// onto wgmma with TMA tile loads is the work of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16: ty owns key rows 4ty..4ty+3, tx query columns tx + 16j
constexpr int PP = BQ + 1;    // padded P^T / dS^T row (floats)

template <int D>
constexpr int kRowPad = D + 2;  // bf16 elements: D/2 + 1 words, odd

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ + 2 * BK) * kRowPad<D> * sizeof(__nv_bfloat16) +
         (size_t)2 * BK * PP * sizeof(float);
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
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, S, D]
    const __nv_bfloat16* __restrict__ k,   // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dO,  // [B, Hq, S, D]
    const float* __restrict__ lse,         // [B, Hq, S]
    const float* __restrict__ delta,
    const float* __restrict__ dlse,
    __nv_bfloat16* __restrict__ dk,        // [B, Hkv, S, D]
    __nv_bfloat16* __restrict__ dv,
    int Hq, int Hkv, int S, int causal, float sm_scale) {
  constexpr int RP = kRowPad<D>;
  constexpr int RW = RP / 2;  // padded row in 32-bit words
  constexpr int DC = D / 16;  // dK/dV columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][RP]
  __nv_bfloat16* v_s = k_s + BK * RP;                                 // [BK][RP]
  __nv_bfloat16* q_s = v_s + BK * RP;                                 // [BQ][RP]
  __nv_bfloat16* do_s = q_s + BQ * RP;                                // [BQ][RP]
  float* p_s = reinterpret_cast<float*>(do_s + BQ * RP);              // [BK][PP]: P^T
  float* ds_s = p_s + BK * PP;                                        // [BK][PP]: dS^T

  const int k0 = blockIdx.x * BK, hkv = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t kv_base = ((size_t)b * Hkv + hkv) * S;

  load_tile<D>(k_s, k + kv_base * D, k0, S, tid);
  load_tile<D>(v_s, v + kv_base * D, k0, S, tid);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const __nv_bfloat162* q_w = reinterpret_cast<const __nv_bfloat162*>(q_s);
  const __nv_bfloat162* do_w = reinterpret_cast<const __nv_bfloat162*>(do_s);
  const __nv_bfloat162* k_w = reinterpret_cast<const __nv_bfloat162*>(k_s);
  const __nv_bfloat162* v_w = reinterpret_cast<const __nv_bfloat162*>(v_s);

  // BQ == BK, so the query tile holding the diagonal starts at k0
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const size_t q_base = ((size_t)b * Hq + hkv * G + g) * S;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();  // k/v tiles written, or the previous tile's reads are done
      load_tile<D>(q_s, q + q_base * D, q0, S, tid);
      load_tile<D>(do_s, dO + q_base * D, q0, S, tid);

      // statistics of this thread's query columns; columns past S act as fully masked
      float lse_c[4], dd_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = q0 + tx + 16 * j;
        lse_c[j] = c < S ? lse[q_base + c] : -INFINITY;
        dd_c[j] = c < S ? dlse[q_base + c] - delta[q_base + c] : 0.f;
      }
      __syncthreads();

      // s^T = K.Q^T and dp^T = V.dO^T for this thread's 4x4 block
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int w = 0; w < D / 2; ++w) {
        float2 kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = __bfloat1622float2(k_w[(ty * 4 + i) * RW + w]);
          vv[i] = __bfloat1622float2(v_w[(ty * 4 + i) * RW + w]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = __bfloat1622float2(q_w[(tx + 16 * j) * RW + w]);
          dov[j] = __bfloat1622float2(do_w[(tx + 16 * j) * RW + w]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[j].x, kv[i].x, fmaf(qv[j].y, kv[i].y, s[i][j]));
            dp[i][j] = fmaf(dov[j].x, vv[i].x, fmaf(dov[j].y, vv[i].y, dp[i][j]));
          }
      }

      // P^T and dS^T, masked and ragged entries zero
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;
          const bool live = isfinite(lse_c[j]) && key < S && !(causal && key > row);
          const float p = live ? expf(s[i][j] * sm_scale - lse_c[j]) : 0.f;
          p_s[(ty * 4 + i) * PP + tx + 16 * j] = p;
          ds_s[(ty * 4 + i) * PP + tx + 16 * j] = p * (dp[i][j] + dd_c[j]);
        }
      }
      __syncthreads();

      // dV += P^T.dO, dK += dS^T.Q
#pragma unroll 2
      for (int t = 0; t < BQ; ++t) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[(ty * 4 + i) * PP + t];
          dsv[i] = ds_s[(ty * 4 + i) * PP + t];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float dov = __bfloat162float(do_s[t * RP + tx + 16 * c]);
          const float qv = __bfloat162float(q_s[t * RP + tx + 16 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t o = (kv_base + r) * D + tx + 16 * c;
      dk[o] = __float2bfloat16(dk_acc[i][c] * sm_scale);
      dv[o] = __float2bfloat16(dv_acc[i][c]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const void* lse, const void* delta, const void* dlse, void* dk,
           void* dv, int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dO, (const float*)lse, (const float*)delta,
      (const float*)dlse, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Hq, Hkv, S,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dO, const void* lse, const void* delta,
                             const void* dlse, void* dk, void* dv, int B, int Hq,
                             int Hkv, int S, int D, int causal, float sm_scale,
                             void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, dO, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, dO, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, dO, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    case 256: return launch<256>(q, k, v, dO, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
