// Flash attention dK/dV in f32 for Hopper (sm_90a): the f32 instance of
// flash_bwd_dkv.cu, with its contract (causal or full self-attention, dK
// and dV summed over each kv head's query heads in the kernel, the lse
// cotangent dlse; a row with lse = -inf has P = 0).
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dkv_kernel at f32
// inputs. With P = exp(scale * q.k - lse) and dS = P * (dO.v - delta + dlse):
//   dV = sum_rows P dO,   dK = scale * sum_rows dS q.
//
// Design (flash_f32.cuh), the dQ kernel transposed: a block owns 32 key
// rows of one (batch, kv head), 8 a warp, with their k and v rows in shared
// memory. It walks the group's query heads in order and, for each, the
// query tiles from the first one the causal mask lets see its first key.
// Per tile each lane computes its query row's q.k and dO.v against the
// warp's 8 keys, P and dS in registers, and dV and dK accumulate D / 32
// columns a lane with each P and dS broadcast by a shuffle; the scale
// multiplies dK once at the end.
#include "flash_f32.cuh"

namespace {

using namespace flash_f32;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ dlse, float* __restrict__ dk,
                         float* __restrict__ dv, int Hq, int Hkv, int S, int causal, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PER = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [ROWS][D]
  float* Vs = Ks + ROWS * D;         // [ROWS][D]
  float* Qt = Vs + ROWS * D;         // [TILE][DP]
  float* Ot = Qt + TILE * DP;        // [TILE][DP], dO
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_plane = blockIdx.x;   // b * Hkv + hk
  const int b = kv_plane / Hkv, hk = kv_plane % Hkv;
  const int G = Hq / Hkv;
  const int key0 = blockIdx.y * ROWS;
  stage_rows<D>(Ks, D, k + (size_t)kv_plane * S * D, key0, ROWS, S);
  stage_rows<D>(Vs, D, v + (size_t)kv_plane * S * D, key0, ROWS, S);

  const int wkey0 = key0 + warp * R;
  float acc_k[R][PER], acc_v[R][PER];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < PER; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;
  const float* kw = Ks + warp * R * D;
  const float* vw = Vs + warp * R * D;
  // query rows before the block's first key see none of its keys
  const int first_tile = causal ? key0 / TILE : 0;
  const int n_tiles = (S + TILE - 1) / TILE;

  for (int g = 0; g < G; ++g) {
    const int plane = b * Hq + hk * G + g;
    const float* qp = q + (size_t)plane * S * D;
    const float* op = dout + (size_t)plane * S * D;
    for (int t = first_tile; t < n_tiles; ++t) {
      const int t0 = t * TILE;
      __syncthreads();
      stage_rows<D>(Qt, DP, qp, t0, TILE, S);
      stage_rows<D>(Ot, DP, op, t0, TILE, S);
      __syncthreads();
      const int row = t0 + lane;
      const size_t at = (size_t)plane * S + (row < S ? row : 0);
      const float row_lse = row < S ? lse[at] : -INFINITY;
      const float row_delta = row < S ? delta[at] : 0.f;
      const float row_dlse = row < S ? dlse[at] : 0.f;
      float s[R], dp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
      const float* qr = Qt + lane * DP;
      const float* orow = Ot + lane * DP;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d], od = orow[d];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r] = fmaf(qd, kw[r * D + d], s[r]);
          dp[r] = fmaf(od, vw[r * D + d], dp[r]);
        }
      }
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int key = wkey0 + r;
        const bool visible = row < S && key < S && (!causal || key <= row) && isfinite(row_lse);
        const float p = visible ? expf(s[r] * sm_scale - row_lse) : 0.f;
        s[r] = p;
        ds[r] = p * (dp[r] - row_delta + row_dlse);
      }
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        float qd[PER], od[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          qd[i] = Qt[j * DP + lane + 32 * i];
          od[i] = Ot[j * DP + lane + 32 * i];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = __shfl_sync(FULL, s[r], j);
          const float dsj = __shfl_sync(FULL, ds[r], j);
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            acc_v[r][i] = fmaf(pj, od[i], acc_v[r][i]);
            acc_k[r][i] = fmaf(dsj, qd[i], acc_k[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = wkey0 + r;
    if (key >= S) continue;
    float* krow = dk + ((size_t)kv_plane * S + key) * D;
    float* vrow = dv + ((size_t)kv_plane * S + key) * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      krow[lane + 32 * i] = acc_k[r][i] * sm_scale;
      vrow[lane + 32 * i] = acc_v[r][i];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           const void* dlse, void* dk, void* dv, int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(2);
  cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, (S + ROWS - 1) / ROWS);
  flash_bwd_dkv_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (const float*)dlse, (float*)dk, (float*)dv, Hq, Hkv, S, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, const void* dlse, void* dk, void* dv, int B, int Hq, int Hkv,
                                 int S, int D, int causal, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (S + ROWS - 1) / ROWS > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dlse, dk, dv, B, Hq, Hkv, S, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dkv_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
