// Flash attention dK/dV in f32 for Hopper (sm_90a): the f32 instance of
// flash_bwd_dkv.cu, with its contract (causal or full self-attention, dK
// and dV summed over each kv head's query heads in the kernel, the lse
// cotangent dlse; a row with lse = -inf has P = 0).
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dkv_kernel at f32
// inputs. With P = exp(scale * q.k - lse) and dS = P * (dO.v - delta + dlse):
//   dV = sum_rows P dO,   dK = scale * sum_rows dS q.
//
// Bound: operations at long sequences, bytes at GPT's (four products of
// S*S*D/2 per query head when causal: 0.81 GFLOP at GPT's shape against
// 19.0 MB, 12.0 us on the CUDA cores' f32, 4.9 us at three TF32 passes on
// the tensor cores, 5.7 us of HBM; 2.15 GFLOP, 13.0 us at three passes, at
// the f32 Llama's B=2, Hq=16, Hkv=8, S=512). The design follows
// flash_bwd_dkv.cu with every product on the tensor cores by the 3xTF32
// split (flash_tf32.cuh):
// - A block owns 64 key rows of one (batch, kv head); K and V arrive once by
//   TMA and are split in place (big parts over the tile, small parts beside
//   it). The block walks the group's query heads in order and, for each,
//   the 32-row query tiles from the causal diagonal on. At D <= 64 two
//   consumer warpgroups take every other tile, each with its own ring of
//   Q/dO stages (TMA, "full" and "empty" mbarriers, its thread 0 issues the
//   loads) and its own split and transposed tiles, so one warpgroup's
//   shared-memory passes and softmax run beside the other's products (with
//   one warpgroup a scheduler has no other warp to hide a latency behind).
//   Both hold all 64 keys' dK and dV for their tiles; at the end the
//   second's sums are added to the first's, in that order. At D = 128 one
//   warpgroup takes every tile, through a one-stage ring.
// - Per tile: Q and dO are split in place (small parts into a pair of tiles
//   beside the ring) and the tile's lse*log2(e) and dlse - delta go to
//   shared memory; then Q and dO are written transposed, big and small
//   parts, into four tiles of their own, over the block's dK/dV columns
//   (tf32::transpose_tile): tf32 wgmma has no transpose, and in dV and dK
//   their depth (the query rows) runs down their columns. The stage is
//   then free once S^T and dP^T are computed, so its next load starts
//   before the rest of the tile's work.
// - S^T = K.Q^T and dP^T = V.dO^T: wgmma m64n32k8 tf32, all operands from
//   shared memory; per depth step K_small.Q_big, K_big.Q_small, K_big.Q_big
//   (and V with dO), in that order.
// - dV += P^T.dO and dK += dS^T.Q: wgmma m64nDNk8 tf32 with P^T and dS^T
//   from registers, their accumulators' fragments split with each
//   8-query chunk's rows in the order 0, 2, 4, 6, 1, 3, 5, 7
//   (tf32::acc_to_a), which the transposed tiles are written in.
// - dK and dV stay in the wgmma accumulators in f32, each warpgroup's
//   summed over its tiles in order; scale multiplies dK once at the end. No
//   atomics: a launch is bitwise repeatable.
// - Shared memory: 224 KB. At D = 64: K, V and their small parts (64 KB),
//   and per warpgroup a 2-stage ring (32 KB), the tile's small parts
//   (16 KB) and its transposed parts (32 KB). At D = 128 K and V take
//   128 KB, and a block covers half of D's dK/dV columns (DN = 64; two
//   blocks per key tile, each recomputing S^T and dP^T) to keep its
//   accumulators in registers.
// - The tensor maps are 3-D over [B*H, S, D]: rows past S of one head read
//   as zeros. The rows of dK and dV past S are not written.
#include "flash_tf32.cuh"

#include <math.h>

namespace {

using namespace hopper;
using tf32::Tf32Wgmma;

constexpr int BK = 64;        // key rows per block
constexpr int BQ = 32;        // query rows per tile

template <int D>
struct Cfg {
  static constexpr int NWG = D <= 64 ? 2 : 1;        // consumer warpgroups, each on every NWG-th tile
  static constexpr int THREADS = 128 * NWG;
  static constexpr int DN = D <= 64 ? D : 64;        // dK/dV columns per block
  static constexpr int NDH = D / DN;                 // blocks per key tile
  static constexpr int STAGES = D <= 64 ? 2 : 1;     // a warpgroup's Q/dO ring depth
  static constexpr uint32_t KV_BYTES = BK * D * 4;   // one of K, V, or a small part
  static constexpr uint32_t T_BYTES = BQ * D * 4;    // one of Q, dO, or a small part
  static constexpr uint32_t TT_BYTES = DN * BQ * 4;  // a transposed part of Q or dO
  // a warpgroup's ring, the tile's small parts and its transposed parts
  static constexpr uint32_t WG_BYTES = STAGES * 2 * T_BYTES + 2 * T_BYTES + 4 * TT_BYTES;
  static constexpr uint32_t TILES = 4 * KV_BYTES + NWG * WG_BYTES;
  static constexpr uint32_t STAT_BYTES = NWG * 2 * BQ * 4;
  static constexpr uint32_t BAR_BYTES = 8 * (NWG * 2 * STAGES + 1);
  // 1024 of slack to align the tiles; then the tiles, the statistics, the barriers
  static constexpr uint32_t SMEM = 1024 + TILES + STAT_BYTES + BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bwd_dkv_f32_kernel(
    const __grid_constant__ CUtensorMap q_map,   // [B*Hq, S, D]
    const __grid_constant__ CUtensorMap k_map,   // [B*Hkv, S, D]
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,  // [B*Hq, S, D]
    const float* __restrict__ lse,               // [B, Hq, S]
    const float* __restrict__ delta,
    const float* __restrict__ dlse,
    float* __restrict__ dk,                      // [B, Hkv, S, D]
    float* __restrict__ dv,
    int Hq, int Hkv, int S, int causal, float sm_scale) {
  using C = Cfg<D>;
  constexpr int DN = C::DN, NWG = C::NWG, STAGES = C::STAGES, PW = tf32::PW, SW = tf32::SW;
  constexpr uint32_t KV = C::KV_BYTES, T = C::T_BYTES, TT = C::TT_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  auto at = [&](uint32_t addr) { return reinterpret_cast<float*>(smem_raw + (addr - raw)); };
  const uint32_t k_s = (raw + 1023) & ~1023u, ksm = k_s + KV, v_s = ksm + KV, vsm = v_s + KV;
  const uint32_t wg_area = vsm + KV, stats = wg_area + NWG * C::WG_BYTES, bars = stats + C::STAT_BYTES;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // this warpgroup's tiles: stage s's Q at ring + 2s*T and dO after it, the
  // current tile's small parts, its transposed parts (Q big, small, dO big,
  // small), its statistics and barriers
  const uint32_t ring = wg_area + wg * C::WG_BYTES;
  const uint32_t qsm = ring + STAGES * 2 * T, dosm = qsm + T;
  const uint32_t qtb = dosm + T, qts = qtb + TT, otb = qts + TT, ots = otb + TT;
  float* lse_s = at(stats + wg * 2 * BQ * 4);
  float* dd_s = lse_s + BQ;
  auto full = [&](int w, int s) { return bars + 8 * (w * 2 * STAGES + s); };
  auto empty = [&](int w, int s) { return bars + 8 * (w * 2 * STAGES + STAGES + s); };
  const uint32_t kv_bar = bars + 8 * NWG * 2 * STAGES;

  // the grid runs key tiles in order, every head's first: the heaviest
  // causal tiles (the first keys, which every query row sees) go first
  const int k0 = (blockIdx.z / C::NDH) * BK, dh = blockIdx.z % C::NDH;
  const int hkv = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv, kv_plane = b * Hkv + hkv;
  const float scale_log2 = sm_scale * LOG2E;

  // query tiles: for each of the group's heads, from the diagonal's tile on;
  // this warpgroup's i-th is tile wg + i * NWG
  const int q_begin = causal ? k0 : 0;  // a multiple of BQ
  const int n_qt = (S - q_begin + BQ - 1) / BQ;
  const int n_tiles = G * n_qt;
  const int n_mine = n_tiles > wg ? (n_tiles - wg + NWG - 1) / NWG : 0;

  auto load_q = [&](int i) {
    const int n = wg + i * NWG, s = i % STAGES;
    const int q_plane = b * Hq + hkv * G + n / n_qt, q0 = q_begin + (n % n_qt) * BQ;
    const uint32_t q_t = ring + 2 * s * T, do_t = q_t + T;
    mbar_expect_tx(full(wg, s), 2 * T);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tma_load_3d(q_t + p * BQ * SW, &q_map, full(wg, s), p * PW, q0, q_plane);
      tma_load_3d(do_t + p * BQ * SW, &do_map, full(wg, s), p * PW, q0, q_plane);
    }
  };

  if (tid == 0) {
    for (int w = 0; w < NWG; ++w)
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 128);
      }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * KV);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tma_load_3d(k_s + p * BK * SW, &k_map, kv_bar, p * PW, k0, kv_plane);
      tma_load_3d(v_s + p * BK * SW, &v_map, kv_bar, p * PW, k0, kv_plane);
    }
  }
  if (wt == 0)
    for (int i = 0; i < min(STAGES, n_mine); ++i) load_q(i);
  __syncwarp();

  // this thread's key rows: r and r + 8 of the block's 64
  const int r = 16 * warp + g;
  const int key[2] = {k0 + r, k0 + r + 8};
  float dk_acc[DN / 2], dv_acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_bar, 0);
  tf32::split_tile<BK * D, C::THREADS>(at(k_s), at(ksm), tid);
  tf32::split_tile<BK * D, C::THREADS>(at(v_s), at(vsm), tid);
  fence_proxy_async();  // K's and V's splits before the tensor core reads them
  __syncthreads();

  for (int i = 0; i < n_mine; ++i) {
    const int n = wg + i * NWG, s = i % STAGES;
    const int q_plane = b * Hq + hkv * G + n / n_qt, q0 = q_begin + (n % n_qt) * BQ;
    const uint32_t q_t = ring + 2 * s * T, do_t = q_t + T;
    mbar_wait(full(wg, s), (i / STAGES) & 1);
    named_sync(1 + wg, 128);  // the warpgroup is done with its last tile's small parts and statistics
    tf32::split_tile<BQ * D, 128>(at(q_t), at(qsm), wt);
    tf32::split_tile<BQ * D, 128>(at(do_t), at(dosm), wt);
    if (wt < BQ) {
      const int q = q0 + wt;
      const size_t at_q = (size_t)q_plane * S + q;
      lse_s[wt] = q < S ? lse[at_q] * LOG2E : -INFINITY;
      dd_s[wt] = q < S ? dlse[at_q] - delta[at_q] : 0.f;
    }
    named_sync(1 + wg, 128);  // the splits before their transposed copies
    tf32::transpose_tile<false, BQ, DN, 128>(at(q_t), at(qsm), dh * DN, at(qtb), at(qts), wt);
    tf32::transpose_tile<false, BQ, DN, 128>(at(do_t), at(dosm), dh * DN, at(otb), at(ots), wt);
    fence_proxy_async();  // the splits before the tensor core reads them
    named_sync(1 + wg, 128);

    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t kb = tf32::desc_k(k_s, BK, kk), ks = tf32::desc_k(ksm, BK, kk);
      const uint64_t vb = tf32::desc_k(v_s, BK, kk), vs = tf32::desc_k(vsm, BK, kk);
      const uint64_t qb = tf32::desc_k(q_t, BQ, kk), qs = tf32::desc_k(qsm, BQ, kk);
      const uint64_t ob = tf32::desc_k(do_t, BQ, kk), os = tf32::desc_k(dosm, BQ, kk);
      Tf32Wgmma<BQ>::ss(st, ks, qb, kk > 0);
      Tf32Wgmma<BQ>::ss(st, kb, qs, 1);
      Tf32Wgmma<BQ>::ss(dpt, vs, ob, kk > 0);
      Tf32Wgmma<BQ>::ss(dpt, vb, os, 1);
      Tf32Wgmma<BQ>::ss(st, kb, qb, 1);
      Tf32Wgmma<BQ>::ss(dpt, vb, ob, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    mbar_arrive(empty(wg, s));  // the stage is read: its next tile may land
    if (wt == 0 && i + STAGES < n_mine) {
      mbar_wait(empty(wg, s), (i / STAGES) & 1);
      load_q(i + STAGES);
    }
    __syncwarp();

    const bool masked = (causal && k0 + BK - 1 > q0) || q0 + BQ > S || k0 + BK > S;
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + 2 * t + c;
        const float lse2 = lse_s[col], dd = dd_s[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * jj + 2 * h + c;
          const bool live = lse2 != -INFINITY && !(masked && (key[h] >= S || (causal && key[h] > q0 + col)));
          const float p = live ? exp2f(fmaf(st[e], scale_log2, -lse2)) : 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] + dd);
        }
      }

    // dV += P^T.dO and dK += dS^T.Q: the split fragments of P^T and dS^T,
    // the transposed parts of dO and Q
    uint32_t pb[BQ / 8][4], ps[BQ / 8][4], db[BQ / 8][4], ds[BQ / 8][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) tf32::acc_to_a(st, kk, pb[kk], ps[kk]);
    tf32::pin_frags(pb);
    tf32::pin_frags(ps);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const uint64_t ob = tf32::desc_k(otb, DN, kk), os = tf32::desc_k(ots, DN, kk);
      Tf32Wgmma<DN>::rs(dv_acc, ps[kk], ob, 1);
      Tf32Wgmma<DN>::rs(dv_acc, pb[kk], os, 1);
      Tf32Wgmma<DN>::rs(dv_acc, pb[kk], ob, 1);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) tf32::acc_to_a(dpt, kk, db[kk], ds[kk]);
    tf32::pin_frags(db);
    tf32::pin_frags(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const uint64_t qb = tf32::desc_k(qtb, DN, kk), qs = tf32::desc_k(qts, DN, kk);
      Tf32Wgmma<DN>::rs(dk_acc, ds[kk], qb, 1);
      Tf32Wgmma<DN>::rs(dk_acc, db[kk], qs, 1);
      Tf32Wgmma<DN>::rs(dk_acc, db[kk], qb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  if constexpr (NWG == 2) {
    // the second warpgroup's sums into the first's, through the first's
    // tiles (free now), [column][thread]
    __syncthreads();
    float* red = at(wg_area);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < DN / 2; ++e) {
        red[e * 128 + wt] = dk_acc[e];
        red[(DN / 2 + e) * 128 + wt] = dv_acc[e];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < DN / 2; ++e) {
      dk_acc[e] += red[e * 128 + wt];
      dv_acc[e] += red[(DN / 2 + e) * 128 + wt];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= S) continue;
    const size_t row = ((size_t)kv_plane * S + key[h]) * D + dh * DN + 2 * t;
#pragma unroll
    for (int nn = 0; nn < DN / 8; ++nn) {
      const int e = 4 * nn + 2 * h;
      *reinterpret_cast<float2*>(dk + row + 8 * nn) = make_float2(dk_acc[e] * sm_scale, dk_acc[e + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + row + 8 * nn) = make_float2(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO, const void* lse, const void* delta,
           const void* dlse, void* dk, void* dv, int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = encode_3d(&q_map, q, D, S, B * Hq, tf32::PW, BQ, tf32::SW, 4);
  if (!e) e = encode_3d(&do_map, dO, D, S, B * Hq, tf32::PW, BQ, tf32::SW, 4);
  if (!e) e = encode_3d(&k_map, k, D, S, B * Hkv, tf32::PW, BK, tf32::SW, 4);
  if (!e) e = encode_3d(&v_map, v, D, S, B * Hkv, tf32::PW, BK, tf32::SW, 4);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B, (S + BK - 1) / BK * C::NDH);
  flash_bwd_dkv_f32_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, do_map, (const float*)lse, (const float*)delta, (const float*)dlse, (float*)dk,
      (float*)dv, Hq, Hkv, S, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, const void* dlse, void* dk, void* dv, int B, int Hq, int Hkv,
                                 int S, int D, int causal, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || (S + BK - 1) / BK * 2 > 65535) return (int)cudaErrorInvalidValue;
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
