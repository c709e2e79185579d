// Flash attention forward in f32 for Hopper (sm_90a): the f32 instance of
// flash_fwd.cu, with the same contract (causal or full, GQA, a query offset
// for a chunk against a longer K/V, o and lse = m + log(l) per row; a row
// with no visible key gets zeros and lse = -inf).
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_fwd_kernel at f32
// inputs (its body upcasts to f32, runs both dot_generals in f32 and writes
// o in the input's dtype).
//
// Bound: operations at long sequences, bytes at GPT's. At GPT's shape (B=8,
// H=6, S = 256, D = 64, causal) the two products are 0.40 GFLOP against
// 12.6 MB of inputs and outputs: 6.0 us on the CUDA cores' f32 (67
// TFLOP/s), 2.4 us at three TF32 passes on the tensor cores (495 TFLOP/s),
// 3.8 us of HBM; at the f32 Llama's (B=2, Hq=16, Hkv=8, S=512) 1.07 GFLOP,
// 6.5 us at three passes. The design puts every product on the tensor
// cores and keeps f32's accuracy with the 3xTF32 split (flash_tf32.cuh):
// - A block is one consumer warpgroup owning 64 query rows of one (batch,
//   query head); the grid launches the heaviest causal tiles first. K and V
//   tiles of BK keys (64; 32 at D = 128) arrive by TMA (f32 tensor maps,
//   128-byte swizzle) through a ring of STAGES stages, each with a "full"
//   mbarrier (completed by the TMA bytes) and an "empty" one (every thread
//   arrives once it is done with the stage); thread 0 issues the loads. Key
//   tiles wholly past the block's last row are never loaded.
// - Per tile, one pass over the stage: K is split in place (big parts over
//   the tile, small parts into one tile beside the ring) and V is written
//   transposed, split, into two tiles of its own (tf32::transpose_tile):
//   tf32 wgmma has no transpose, and V's depth (the keys) runs down its
//   columns. The stage is then free once S is computed, so its next load
//   starts before the softmax.
// - S = Q.K^T on wgmma m64nBKk8 tf32: Q is split once per block, into
//   registers as the A fragments at D <= 64 and into shared memory at
//   D = 128 (its fragments would take 128 registers a thread). Per depth
//   step Q_small.K_big, Q_big.K_small, Q_big.K_big, in that order. The Q
//   fragments live across the key loop: CUDA 12.9's ptxas once gave a
//   build with one product a step P's fragments in their registers (o
//   0.27 off), which chip_smoke.py 20a's check refuses; keep that check
//   on any change here.
// - O += P.V on wgmma m64nDk8 tf32 with P from registers: the score
//   accumulator's fragment, split, with each 8-key chunk's keys in the
//   order 0, 2, 4, 6, 1, 3, 5, 7 (tf32::acc_to_a), which the transposed V
//   tile is written in. O stays in the wgmma accumulator.
// - The online softmax runs on the score registers as in flash_fwd.cu
//   (scores scaled by sm_scale*log2(e), exp2f, row max and sum over the 4
//   threads of a row by shuffles), in f32; P is split, not rounded to bf16.
// - Shared memory at D = 64: the ring 2 x (K + V), K's small part and V's
//   two transposed parts, 112 KB, with the barriers in the alignment slack:
//   two blocks an SM. At D = 128: 32-key tiles and Q's two parts, 176 KB.
// - No atomics and a fixed order of every sum: a launch is bitwise
//   repeatable.
#include "flash_tf32.cuh"

#include <math.h>

namespace {

using namespace hopper;
using tf32::Tf32Wgmma;

constexpr int THREADS = 128;  // one consumer warpgroup
constexpr int BQ = 64;        // query rows per block
constexpr int STAGES = 2;     // K/V ring depth

template <int D>
struct Cfg {
  static constexpr int BK = D <= 64 ? 64 : 32;       // key rows per tile (32 at D = 128, to fit)
  static constexpr bool Q_REGS = D <= 64;            // Q's split fragments in registers, else in shared memory
  static constexpr uint32_t KV_TILE = BK * D * 4;    // one K or V tile, or a part of one
  static constexpr uint32_t Q_TILE = BQ * D * 4;     // one part of Q
  static constexpr uint32_t Q_BYTES = Q_REGS ? 0 : 2 * Q_TILE;
  // Q's parts, the ring, K's small part, V's two transposed parts
  static constexpr uint32_t TILES = Q_BYTES + STAGES * 2 * KV_TILE + 3 * KV_TILE;
  static constexpr uint32_t BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 of slack to align the tiles; the barriers sit in it when it has
  // room for them, else after the tiles (within the 1024)
  static constexpr uint32_t SMEM = 1024 + TILES;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(
    const __grid_constant__ CUtensorMap q_map,  // [B*Hq, S, D]
    const __grid_constant__ CUtensorMap k_map,  // [B*Hkv, Skv, D]
    const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ q,  // [B, Hq, S, D]: Q's register fragments
    float* __restrict__ o,        // [B, Hq, S, D]
    float* __restrict__ lse,      // [B, Hq, S]
    int Hq, int Hkv, int S, int Skv, int q_offset, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, PW = tf32::PW, SW = tf32::SW;
  constexpr uint32_t TILE = C::KV_TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto at = [&](uint32_t addr) { return reinterpret_cast<float*>(smem_raw + (addr - raw)); };
  const uint32_t qb_s = base, qs_s = base + C::Q_TILE;  // Q's parts (D = 128)
  const uint32_t ring = base + C::Q_BYTES;              // stage s: K at ring + 2s*TILE, V after it
  const uint32_t ks_s = ring + STAGES * 2 * TILE;       // the current K tile's small part
  const uint32_t vb_s = ks_s + TILE, vs_s = vb_s + TILE;  // the current V tile, transposed: big, small
  const uint32_t bars = base - raw >= C::BAR_BYTES ? raw : base + C::TILES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 16 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int q_plane = b * Hq + hq, kv_plane = b * Hkv + hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kv_end = causal ? min(Skv, q_offset + min(q0 + BQ, S)) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int n) {
    const int s = n % STAGES;
    const uint32_t k_s = ring + 2 * s * TILE, v_s = k_s + TILE;
    mbar_expect_tx(full(s), 2 * TILE);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tma_load_3d(k_s + p * BK * SW, &k_map, full(s), p * PW, n * BK, kv_plane);
      tma_load_3d(v_s + p * BK * SW, &v_map, full(s), p * PW, n * BK, kv_plane);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (!C::Q_REGS) {
      mbar_expect_tx(q_bar, C::Q_TILE);
#pragma unroll
      for (int p = 0; p < D / PW; ++p) tma_load_3d(qb_s + p * BQ * SW, &q_map, q_bar, p * PW, q0, q_plane);
    }
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load_kv(n);
  }
  __syncwarp();

  // this thread's rows: r and r + 8 of the block's 64
  const int r = 16 * warp + g;
  uint32_t qa[C::Q_REGS ? D / 8 : 1][4], qs[C::Q_REGS ? D / 8 : 1][4];  // Q's big and small A fragments
  if constexpr (C::Q_REGS) {
    const float* qp = q + (size_t)q_plane * S * D;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows r, r + 8, r, r + 8; columns t, t, t + 4, t + 4 of the step
        const int row = q0 + r + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
        tf32::split(row < S ? qp[(size_t)row * D + col] : 0.f, qa[kk][i], qs[kk][i]);
      }
  } else {
    mbar_wait(q_bar, 0);
    tf32::split_tile<BQ * D, THREADS>(at(qb_s), at(qs_s), tid);
  }

  const int first = q_offset + q0;  // the block's first query position
  const int pos[2] = {first + r, first + r + 8};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    const uint32_t k_s = ring + 2 * s * TILE, v_s = k_s + TILE;
    mbar_wait(full(s), (j / STAGES) & 1);
    __syncthreads();  // every warp is done with the last tile's split parts
    tf32::split_tile<BK * D, THREADS>(at(k_s), at(ks_s), tid);
    tf32::transpose_tile<true, BK, D, THREADS>(at(v_s), nullptr, 0, at(vb_s), at(vs_s), tid);
    fence_proxy_async();  // the splits (and Q's) before the tensor core reads them
    __syncthreads();

    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t kb = tf32::desc_k(k_s, BK, kk), ksm = tf32::desc_k(ks_s, BK, kk);
      if constexpr (C::Q_REGS) {
        Tf32Wgmma<BK>::rs(sc, qs[kk], kb, kk > 0);
        Tf32Wgmma<BK>::rs(sc, qa[kk], ksm, 1);
        Tf32Wgmma<BK>::rs(sc, qa[kk], kb, 1);
      } else {
        const uint64_t qb = tf32::desc_k(qb_s, BQ, kk), qsm = tf32::desc_k(qs_s, BQ, kk);
        Tf32Wgmma<BK>::ss(sc, qsm, kb, kk > 0);
        Tf32Wgmma<BK>::ss(sc, qb, ksm, 1);
        Tf32Wgmma<BK>::ss(sc, qb, kb, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty(s));  // the stage is read: its next tile may land
    if (tid == 0 && j + STAGES < n_tiles) {
      mbar_wait(empty(s), (j / STAGES) & 1);
      load_kv(j + STAGES);
    }
    __syncwarp();

    const bool masked = (causal && k0 + BK - 1 > first) || k0 + BK > Skv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + 8 * jj + 2 * t + c;
          float x = sc[4 * jj + 2 * h + c] * scale_log2;
          if (masked && (col >= Skv || (causal && col > pos[h]))) x = -INFINITY;
          sc[4 * jj + 2 * h + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - m_use);  // 0 while m is -inf
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(sc[4 * jj + 2 * h + c] - m_use);
          sc[4 * jj + 2 * h + c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 2 * h] *= alpha;
        acc[4 * n + 2 * h + 1] *= alpha;
      }
    }

    // O += P.V: P's split fragments, V's transposed parts
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) tf32::acc_to_a(sc, kk, pb[kk], ps[kk]);
    tf32::pin_frags(pb);
    tf32::pin_frags(ps);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t vb = tf32::desc_k(vb_s, D, kk), vs = tf32::desc_k(vs_s, D, kk);
      Tf32Wgmma<D>::rs(acc, ps[kk], vb, 1);
      Tf32Wgmma<D>::rs(acc, pb[kk], vs, 1);
      Tf32Wgmma<D>::rs(acc, pb[kk], vb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r + 8 * h;
    if (row >= S) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    float* out = o + ((size_t)q_plane * S + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
    if (t == 0) lse[(size_t)q_plane * S + row] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq, int Hkv, int S, int Skv,
           int q_offset, int causal, float sm_scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map;
  int e = encode_3d(&q_map, q, D, S, B * Hq, tf32::PW, BQ, tf32::SW, 4);
  // with no keys nothing is loaded; the maps only need to be valid
  const int kv_rows = Skv > 0 ? Skv : 1;
  if (!e) e = encode_3d(&k_map, Skv > 0 ? k : q, D, kv_rows, B * Hkv, tf32::PW, C::BK, tf32::SW, 4);
  if (!e) e = encode_3d(&v_map, Skv > 0 ? v : q, D, kv_rows, B * Hkv, tf32::PW, C::BK, tf32::SW, 4);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  // all of the SM's 228 KB to shared memory: two 113 KB blocks an SM at D = 64
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, (const float*)q, (float*)o, (float*)lse, Hq, Hkv, S, Skv, q_offset, causal,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq,
                             int Hkv, int S, int Skv, int D, int q_offset, int causal, float sm_scale,
                             void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
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
