// Flash attention forward in f32 for Hopper (sm_90a): the f32 instance of
// flash_fwd.cu, with the same contract (causal or full, GQA, a query offset
// for a chunk against a longer K/V, o and lse = m + log(l) per row; a row
// with no visible key gets zeros and lse = -inf).
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_fwd_kernel at f32
// inputs (its body upcasts to f32 and writes o in the input's dtype).
//
// Design (flash_f32.cuh): a block owns 32 query rows of one (batch, query
// head), 8 a warp, the rows scaled by sm_scale in f32 as the TPU kernel
// scales q. It walks the key tiles up to the causal limit of its last row;
// tiles wholly past it are never loaded. Per tile each lane scores its key
// against the warp's 8 rows, the online softmax (running max m and sum l)
// reduces over the warp with shuffles, and O += P.V accumulates D / 32
// columns a lane with each probability broadcast by a shuffle. Exponentials
// are expf of f32 differences; every product is an f32 fmaf.
#include "flash_f32.cuh"

namespace {

using namespace flash_f32;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int S, int Skv,
                     int q_offset, int causal, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PER = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [ROWS][D], scaled
  float* Ks = Qs + ROWS * D;         // [TILE][DP]
  float* Vs = Ks + TILE * DP;        // [TILE][DP]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int plane = blockIdx.x;      // b * Hq + h
  const int b = plane / Hq, h = plane % Hq;
  const int kv_plane = b * Hkv + h / (Hq / Hkv);
  const int row0 = blockIdx.y * ROWS;
  const float* qp = q + (size_t)plane * S * D;
  const float* kp = k + (size_t)kv_plane * Skv * D;
  const float* vp = v + (size_t)kv_plane * Skv * D;

  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    Qs[idx] = row < S ? qp[(size_t)row * D + d] * sm_scale : 0.f;
  }
  // keys [0, kv_end) are visible to some row of this block
  const int last_row = min(row0 + ROWS, S) - 1;
  const int kv_end = causal ? min(Skv, q_offset + last_row + 1) : Skv;
  const int n_tiles = (kv_end + TILE - 1) / TILE;

  float m[R], l[R], acc[R][PER];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }
  const float* qw = Qs + warp * R * D;
  const int wrow0 = row0 + warp * R;

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * TILE;
    __syncthreads();
    stage_rows<D>(Ks, DP, kp, t0, TILE, Skv);
    stage_rows<D>(Vs, DP, vp, t0, TILE, Skv);
    __syncthreads();
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }
    const int key = t0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool visible = key < Skv && (!causal || key <= q_offset + wrow0 + r);
      const float sr = visible ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      // m_new = -inf: no key of this row is visible yet, nothing to add
      const float p = m_new == -INFINITY ? 0.f : expf(sr - m_new);
      const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      l[r] = fmaf(l[r], corr, warp_sum(p));
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[r][i] *= corr;
      m[r] = m_new;
      s[r] = p;
    }
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float vd[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) vd[i] = Vs[j * DP + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[r][i] = fmaf(pj, vd[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = wrow0 + r;
    if (row >= S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* orow = o + ((size_t)plane * S + row) * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = acc[r][i] * inv;
    if (lane == 0) lse[(size_t)plane * S + row] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq, int Hkv, int S, int Skv,
           int q_offset, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(1);
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (S + ROWS - 1) / ROWS);
  flash_fwd_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Hq, Hkv, S, Skv, q_offset, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq,
                             int Hkv, int S, int Skv, int D, int q_offset, int causal, float sm_scale,
                             void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (S + ROWS - 1) / ROWS > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
