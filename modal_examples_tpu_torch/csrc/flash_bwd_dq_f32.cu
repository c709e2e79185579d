// Flash attention dQ in f32 for Hopper (sm_90a): the f32 instance of
// flash_bwd_dq.cu, with its contract (causal or full self-attention, GQA,
// the lse cotangent dlse; a row with lse = -inf has P = 0).
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dq_kernel at f32
// inputs. With P = exp(scale * q.k - lse):
//   dS = P * (dO.v - delta + dlse),   dQ = scale * sum_keys dS k.
//
// Design (flash_f32.cuh): a block owns 32 query rows of one (batch, query
// head), 8 a warp, with their q and dO rows in shared memory; it walks the
// key tiles up to the causal limit of its last row. Per tile each lane
// computes its key's q.k and dO.v against the warp's 8 rows, P and dS in
// registers, and dQ accumulates D / 32 columns a lane with each dS
// broadcast by a shuffle; the scale multiplies dQ once at the end.
#include "flash_f32.cuh"

namespace {

using namespace flash_f32;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ dlse, float* __restrict__ dq,
                        int Hq, int Hkv, int S, int causal, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PER = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [ROWS][D]
  float* Os = Qs + ROWS * D;         // [ROWS][D], dO
  float* Ks = Os + ROWS * D;         // [TILE][DP]
  float* Vs = Ks + TILE * DP;        // [TILE][DP]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int plane = blockIdx.x;
  const int b = plane / Hq, h = plane % Hq;
  const int kv_plane = b * Hkv + h / (Hq / Hkv);
  const int row0 = blockIdx.y * ROWS;
  const float* kp = k + (size_t)kv_plane * S * D;
  const float* vp = v + (size_t)kv_plane * S * D;
  stage_rows<D>(Qs, D, q + (size_t)plane * S * D, row0, ROWS, S);
  stage_rows<D>(Os, D, dout + (size_t)plane * S * D, row0, ROWS, S);

  const int wrow0 = row0 + warp * R;
  float row_lse[R], row_delta[R], row_dlse[R], acc[R][PER];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = wrow0 + r;
    const size_t at = (size_t)plane * S + (row < S ? row : 0);
    row_lse[r] = row < S ? lse[at] : -INFINITY;
    row_delta[r] = row < S ? delta[at] : 0.f;
    row_dlse[r] = row < S ? dlse[at] : 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }
  const int last_row = min(row0 + ROWS, S) - 1;
  const int kv_end = causal ? last_row + 1 : S;
  const int n_tiles = (kv_end + TILE - 1) / TILE;
  const float* qw = Qs + warp * R * D;
  const float* ow = Os + warp * R * D;

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * TILE;
    __syncthreads();
    stage_rows<D>(Ks, DP, kp, t0, TILE, S);
    stage_rows<D>(Vs, DP, vp, t0, TILE, S);
    __syncthreads();
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * DP;
    const float* vr = Vs + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(qw[r * D + d], kd, s[r]);
        dp[r] = fmaf(ow[r * D + d], vd, dp[r]);
      }
    }
    const int key = t0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool visible = key < S && (!causal || key <= wrow0 + r) && isfinite(row_lse[r]);
      const float p = visible ? expf(s[r] * sm_scale - row_lse[r]) : 0.f;
      s[r] = p * (dp[r] - row_delta[r] + row_dlse[r]);  // dS
    }
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float kd[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) kd[i] = Ks[j * DP + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dsj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[r][i] = fmaf(dsj, kd[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = wrow0 + r;
    if (row >= S) continue;
    float* out = dq + ((size_t)plane * S + row) * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) out[lane + 32 * i] = acc[r][i] * sm_scale;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           const void* dlse, void* dq, int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(2);
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (S + ROWS - 1) / ROWS);
  flash_bwd_dq_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (const float*)dlse, (float*)dq, Hq, Hkv, S, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* dlse, void* dq, int B, int Hq, int Hkv, int S,
                                int D, int causal, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (S + ROWS - 1) / ROWS > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dlse, dq, B, Hq, Hkv, S, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dq_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
