// Flash attention dQ in f32 for Hopper (sm_90a): the f32 instance of
// flash_bwd_dq.cu, with its contract (causal or full self-attention, GQA,
// the lse cotangent dlse; a row with lse = -inf has P = 0).
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dq_kernel at f32
// inputs. With P = exp(scale * q.k - lse):
//   dS = P * (dO.v - delta + dlse),   dQ = scale * sum_keys dS k.
//
// Bound: operations at long sequences, bytes at GPT's. Three products of
// S*S*D/2 per query head when causal: 0.60 GFLOP at GPT's shape (B=8, H=6,
// S=256, D=64) against 15.9 MB of inputs and outputs, 3.7 us at three TF32
// passes on the tensor cores (495 TFLOP/s), 4.7 us of HBM; 1.61 GFLOP,
// 9.8 us at three passes, at the f32 Llama's (B=2, Hq=16, Hkv=8, S=512).
// The design follows flash_bwd_dq.cu with every product on the tensor
// cores by the 3xTF32 split (flash_tf32.cuh):
// - A block owns BQ query rows of one (batch, query head): two consumer
//   warpgroups of 64 rows at D <= 64, which share every K/V tile's split
//   and transpose passes (done by all 256 threads, so paid once per 128
//   rows, and one warpgroup's softmax runs beside the other's products);
//   one warpgroup at D = 128, to fit shared memory. The grid launches the
//   heaviest causal query tiles first, every head's.
// - Q and dO arrive once by TMA (f32 tensor maps, 128-byte swizzle) and are
//   split once: dO in place in shared memory (its small part beside it);
//   at D <= 64 each thread splits its own A fragments of Q, keeping the big
//   parts in registers (D / 8 a thread) and writing the small parts over
//   the raw values, read from shared memory by small.big; at D = 128 Q is
//   split as dO is. At D = 64, Q's and dO's fragments in registers would
//   take 128 a thread beside the S, dP and dQ accumulators, and Q's two
//   parts alone spilled (255 registers).
// - K and V tiles of BK keys (64; 32 at D = 128) stream through a ring of
//   STAGES stages, each with a "full" mbarrier (completed by the TMA bytes)
//   and an "empty" one (every thread arrives once S and dP are read); thread
//   0 issues the loads. Key tiles wholly past the block's last row are
//   never loaded.
// - Per tile, one pass over the stage: K and V are split in place (big
//   parts over the stage, small parts into one tile each beside the ring),
//   and in the same pass K is written transposed, big and small parts, into
//   two tiles of its own (tf32::split_transpose_tile): tf32 wgmma has no
//   transpose, and in dS.K the depth (the keys) runs down K's columns. The
//   stage is free once S and dP are computed, so its next load starts
//   before the softmax.
// - S = Q.K^T and dP = dO.V^T on wgmma m64nBKk8 tf32; per depth step
//   small.big, big.small, big.big, in that order. P = exp2(S * scale*log2(e)
//   - lse*log2(e)) and dS = P * (dP - delta + dlse) stay in f32 registers.
// - dQ += dS.K on wgmma m64nDk8 tf32 with dS from registers: the dP
//   accumulator's fragment, split, with each 8-key chunk's keys in the order
//   0, 2, 4, 6, 1, 3, 5, 7 (tf32::acc_to_a), which the transposed K tile is
//   written in. dQ stays in the wgmma accumulator; the scale multiplies it
//   once at the end. A warpgroup skips the products of a tile wholly past
//   its last row (it still joins the passes).
// - Shared memory: at D = 64, Q's small part (32 KB), dO's two parts
//   (64 KB), the 2-stage ring (64 KB), K's and V's small parts and K's two
//   transposed parts (64 KB): 225 KB. At D = 128: Q's and dO's parts
//   (128 KB), a 1-stage ring of 32-key tiles (32 KB) and the four tiles
//   (64 KB): 225 KB.
// - The tensor maps are 3-D over [B*H, S, D]: rows past S of one head read
//   as zeros. Rows of dQ past S are not written. No atomics and a fixed
//   order of every sum: a launch is bitwise repeatable.
#include "flash_tf32.cuh"

#include <math.h>

namespace {

using namespace hopper;
using tf32::Tf32Wgmma;

template <int D>
struct Cfg {
  static constexpr int NWG = D <= 64 ? 2 : 1;         // consumer warpgroups, 64 query rows each
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BQ = 64 * NWG;                 // query rows per block
  static constexpr int BK = D <= 64 ? 64 : 32;        // key rows per tile (32 at D = 128, to fit)
  static constexpr int STAGES = D <= 64 ? 2 : 1;      // K/V ring depth
  static constexpr bool Q_REGS = D <= 64;             // Q's big fragments in registers, else in shared memory
  static constexpr uint32_t KV_TILE = BK * D * 4;     // one K or V tile, or a part of one
  static constexpr uint32_t T_TILE = BQ * D * 4;      // one part of Q or dO
  static constexpr uint32_t Q_BYTES = (Q_REGS ? 1 : 2) * T_TILE;  // Q's small part (and at D = 128 its big)
  // Q's parts, dO's parts, the ring, K's and V's small parts, K's two
  // transposed parts
  static constexpr uint32_t TILES = Q_BYTES + 2 * T_TILE + STAGES * 2 * KV_TILE + 4 * KV_TILE;
  static constexpr uint32_t BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 of slack to align the tiles; then the tiles, the barriers
  static constexpr uint32_t SMEM = 1024 + TILES + BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bwd_dq_f32_kernel(
    const __grid_constant__ CUtensorMap q_map,   // [B*Hq, S, D]
    const __grid_constant__ CUtensorMap k_map,   // [B*Hkv, S, D]
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,  // [B*Hq, S, D]
    const float* __restrict__ lse,               // [B, Hq, S]
    const float* __restrict__ delta,
    const float* __restrict__ dlse,
    float* __restrict__ dq,                      // [B, Hq, S, D]
    int Hq, int Hkv, int S, int causal, float sm_scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES, THREADS = C::THREADS;
  constexpr int PW = tf32::PW, SW = tf32::SW;
  constexpr uint32_t KV = C::KV_TILE, T = C::T_TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  auto at = [&](uint32_t addr) { return reinterpret_cast<float*>(smem_raw + (addr - raw)); };
  const uint32_t qs_s = (raw + 1023) & ~1023u, qb_s = qs_s + T;  // Q's small part; its big part (D = 128)
  const uint32_t ob_s = qs_s + C::Q_BYTES, os_s = ob_s + T;      // dO's parts
  const uint32_t ring = os_s + T;                                // stage s: K at ring + 2s*KV, V after it
  const uint32_t ks_s = ring + STAGES * 2 * KV, vs_s = ks_s + KV;  // the current tile's small parts
  const uint32_t ktb = vs_s + KV, kts = ktb + KV;                // the current K tile, transposed: big, small
  const uint32_t bars = kts + KV;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 16 * STAGES;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first, every head's
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q_plane = b * Hq + hq, kv_plane = b * Hkv + hq / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float scale_log2 = sm_scale * LOG2E;
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int n) {
    const int s = n % STAGES;
    const uint32_t k_s = ring + 2 * s * KV, v_s = k_s + KV;
    mbar_expect_tx(full(s), 2 * KV);
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
    mbar_expect_tx(q_bar, 2 * T);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {  // Q lands where its small part (or, at D = 128, its big part) goes
      tma_load_3d((C::Q_REGS ? qs_s : qb_s) + p * BQ * SW, &q_map, q_bar, p * PW, q0, q_plane);
      tma_load_3d(ob_s + p * BQ * SW, &do_map, q_bar, p * PW, q0, q_plane);
    }
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load_kv(n);
  }
  __syncwarp();

  // this thread's rows: r and r + 8 of its warpgroup's 64, with their
  // statistics (rows past S act as fully masked)
  const int r = 16 * warp + g;
  const int wg_first = q0 + 64 * wg;
  const int row[2] = {wg_first + r, wg_first + r + 8};
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t i = (size_t)q_plane * S + row[h];
    lse2[h] = row[h] < S ? lse[i] * LOG2E : -INFINITY;
    dd[h] = row[h] < S ? dlse[i] - delta[i] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  tf32::split_tile<BQ * D, THREADS>(at(ob_s), at(os_s), tid);
  uint32_t qa[C::Q_REGS ? D / 8 : 1][4];  // Q's big A fragments (D <= 64)
  if constexpr (C::Q_REGS) {
    // each thread splits its own fragments' elements: the big parts into
    // registers, the small parts over the raw values (the A operand of
    // small.big from shared memory)
    float* qt = at(qs_s);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows r, r + 8, r, r + 8; columns t, t, t + 4, t + 4 of the step
        const uint32_t e = tf32::swz(64 * wg + r + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1), BQ) / 4;
        uint32_t small;
        tf32::split(qt[e], qa[kk][i], small);
        qt[e] = __uint_as_float(small);
      }
  } else {
    tf32::split_tile<BQ * D, THREADS>(at(qb_s), at(qs_s), tid);
  }
  // (ordered before the tensor core's reads by the first tile's fence and barrier)

  // this warpgroup's rows of Q's and dO's tiles
  const uint32_t rows_off = wg * 64 * SW;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    const uint32_t k_s = ring + 2 * s * KV, v_s = k_s + KV;
    mbar_wait(full(s), (j / STAGES) & 1);
    __syncthreads();  // both warpgroups are done with the last tile's split and transposed parts
    tf32::split_transpose_tile<BK, D, THREADS>(at(k_s), at(ks_s), at(ktb), at(kts), tid);
    tf32::split_tile<BK * D, THREADS>(at(v_s), at(vs_s), tid);
    fence_proxy_async();  // the splits before the tensor core reads them
    __syncthreads();

    // a tile wholly past this warpgroup's last row, or rows wholly past S: no products
    const bool active = wg_first < S && !(causal && k0 > wg_first + 63);
    // step 0's descriptors of the tiles, each step's taken from them at its use
    const uint32_t z = tf32::opaque_zero();
    const uint64_t kb0 = tf32::desc_k(k_s + z, BK, 0), ks0 = tf32::desc_k(ks_s + z, BK, 0);
    const uint64_t vb0 = tf32::desc_k(v_s + z, BK, 0), vs0 = tf32::desc_k(vs_s + z, BK, 0);
    const uint64_t ob0 = tf32::desc_k(ob_s + rows_off + z, BQ, 0), os0 = tf32::desc_k(os_s + rows_off + z, BQ, 0);
    const uint64_t qb0 = tf32::desc_k(qb_s + rows_off + z, BQ, 0), qs0 = tf32::desc_k(qs_s + rows_off + z, BQ, 0);
    float sc[BK / 2], dp[BK / 2];
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t kb = tf32::desc_step(kb0, BK, kk), ksm = tf32::desc_step(ks0, BK, kk);
        const uint64_t vb = tf32::desc_step(vb0, BK, kk), vsm = tf32::desc_step(vs0, BK, kk);
        const uint64_t ob = tf32::desc_step(ob0, BQ, kk), osm = tf32::desc_step(os0, BQ, kk);
        const uint64_t qb = tf32::desc_step(qb0, BQ, kk), qsm = tf32::desc_step(qs0, BQ, kk);
        Tf32Wgmma<BK>::ss(sc, qsm, kb, kk > 0);
        if constexpr (C::Q_REGS) {
          Tf32Wgmma<BK>::rs(sc, qa[kk], ksm, 1);
        } else {
          Tf32Wgmma<BK>::ss(sc, qb, ksm, 1);
        }
        Tf32Wgmma<BK>::ss(dp, osm, vb, kk > 0);
        Tf32Wgmma<BK>::ss(dp, ob, vsm, 1);
        if constexpr (C::Q_REGS) {
          Tf32Wgmma<BK>::rs(sc, qa[kk], kb, 1);
        } else {
          Tf32Wgmma<BK>::ss(sc, qb, kb, 1);
        }
        Tf32Wgmma<BK>::ss(dp, ob, vb, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
    }
    mbar_arrive(empty(s));  // the stage is read: its next tile may land
    if (tid == 0 && j + STAGES < n_tiles) {
      mbar_wait(empty(s), (j / STAGES) & 1);
      load_kv(j + STAGES);
    }
    __syncwarp();
    if (!active) continue;

    const bool masked = (causal && k0 + BK - 1 > wg_first) || k0 + BK > S;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + 8 * jj + 2 * t + c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h + c;
          const bool live = lse2[h] != -INFINITY && !(masked && (col >= S || (causal && col > row[h])));
          const float p = live ? exp2f(fmaf(sc[i], scale_log2, -lse2[h])) : 0.f;
          dp[i] = p * (dp[i] + dd[h]);  // dS
        }
      }

    // dQ += dS.K: dS's split fragments, K's transposed parts
    uint32_t db[BK / 8][4], ds[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) tf32::acc_to_a(dp, kk, db[kk], ds[kk]);
    tf32::pin_frags(db);
    tf32::pin_frags(ds);
    const uint64_t kt0 = tf32::desc_k(ktb + z, D, 0), kts0 = tf32::desc_k(kts + z, D, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t kb = tf32::desc_step(kt0, D, kk), ksm = tf32::desc_step(kts0, D, kk);
      Tf32Wgmma<D>::rs(acc, ds[kk], kb, 1);
      Tf32Wgmma<D>::rs(acc, db[kk], ksm, 1);
      Tf32Wgmma<D>::rs(acc, db[kk], kb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= S) continue;
    float* out = dq + ((size_t)q_plane * S + row[h]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[4 * n + 2 * h] * sm_scale, acc[4 * n + 2 * h + 1] * sm_scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO, const void* lse, const void* delta,
           const void* dlse, void* dq, int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = encode_3d(&q_map, q, D, S, B * Hq, tf32::PW, C::BQ, tf32::SW, 4);
  if (!e) e = encode_3d(&do_map, dO, D, S, B * Hq, tf32::PW, C::BQ, tf32::SW, 4);
  if (!e) e = encode_3d(&k_map, k, D, S, B * Hkv, tf32::PW, C::BK, tf32::SW, 4);
  if (!e) e = encode_3d(&v_map, v, D, S, B * Hkv, tf32::PW, C::BK, tf32::SW, 4);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (S + C::BQ - 1) / C::BQ);
  flash_bwd_dq_f32_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, do_map, (const float*)lse, (const float*)delta, (const float*)dlse,
      (float*)dq, Hq, Hkv, S, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, const void* dlse, void* dq, int B, int Hq, int Hkv, int S,
                                int D, int causal, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || (S + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
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
