// Flash attention backward, dK and dV, for Hopper (sm_90a): causal or full
// self-attention with GQA.
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dkv_kernel (per-block
// math in _bwd_block_ds; driven by _flash_backward). With
// P = exp(scale * Q.K^T - lse) and dS = P * (dO.V^T - delta + dlse),
// dV = P^T.dO and dK = scale * dS^T.Q. The TPU kernel ran per QUERY head,
// carrying dK/dV in VMEM scratch across a sequential query-block grid axis,
// wrote [B*Hq, S, D] per-head results and left the GQA group sum to XLA.
// Here one block owns a (batch, kv head, key tile), loops over the group's
// query heads and, for each, over the 64-row query tiles from the causal
// diagonal on (tiles wholly below it in key order are skipped, as on the
// TPU), and accumulates dK and dV for the kv head in f32 registers: no
// per-query-head intermediate, one rounding at the single write.
//
// Inputs: q, k, v, dO bf16 ([B, Hq, S, D] and [B, Hkv, S, D]); lse, delta,
// dlse f32 [B, Hq, S]. Outputs dK, dV bf16 [B, Hkv, S, D].
//
// Bound: operations (four products of S*S*D/2 per query head when causal,
// against about 8*S*D bytes per query head). The design:
// - Every product is a warpgroup MMA (wgmma, bf16 in, f32 sums). Each
//   consumer warpgroup owns 64 key rows (two warpgroups, 128 rows, at
//   D <= 128; one at D = 256, to fit shared memory and registers) and keeps
//   its dK and dV in f32 registers. Per query tile:
//     S^T = K.Q^T and dP^T = V.dO^T: m64n64k16, all operands from shared
//     memory, K-major;
//     P^T = exp2(S^T * scale*log2(e) - lse*log2(e)), 0 where lse = -inf, past
//     S or under the causal mask; dS^T = P^T * (dP^T - delta + dlse);
//     dV += P^T.dO and dK += dS^T.Q: m64n{DN}k16 with A from registers
//     (bf16; the f32 fragment of P^T / dS^T is the A operand's fragment) and
//     B = the same dO and Q tiles read MN-major (tnspB).
// - K and V arrive once by TMA (hopper.cuh); Q and dO tiles stream through a
//   ring of STAGES stages, each with a "full" mbarrier (completed by the TMA
//   bytes) and an "empty" one (every consumer thread arrives when its
//   products on the stage are done). One thread issues the loads; the tile
//   after the one being multiplied is in flight. The tile's lse*log2(e) and
//   dlse - delta go through shared memory, 64 values per warpgroup and stage.
// - At D = 256 the 64 + 64 accumulators a thread keeps for DN = 128 columns
//   are all it can hold: a block covers half of D (DN = 128) and the grid
//   has two blocks per key tile, each recomputing S^T and dP^T.
// - The tensor maps are 3-D over [B*H, S, D]: rows past S of one head read as
//   zeros. The rows of dK and dV past S are not written.
#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int BQ = 64;      // query rows per tile
constexpr int STAGES = 2;   // Q/dO ring depth

template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span: the bytes of one panel row
  static constexpr int PW = SW / 2;              // bf16 columns per panel
  static constexpr int NWG = D <= 128 ? 2 : 1;   // consumer warpgroups
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BK = 64 * NWG;            // key rows per block
  static constexpr int DN = D <= 128 ? D : 128;  // dK/dV columns per block
  static constexpr int NDH = D / DN;             // blocks per key tile
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr uint32_t T_BYTES = BQ * D * 2;   // one of Q, dO
  static constexpr uint32_t STAT_BYTES = STAGES * NWG * 2 * BQ * 4;
  static constexpr uint32_t BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 of slack to align the tiles; then K, V, the ring, the statistics, the barriers
  static constexpr uint32_t SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * T_BYTES + STAT_BYTES + BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap q_map,   // [B*Hq, S, D]
    const __grid_constant__ CUtensorMap k_map,   // [B*Hkv, S, D]
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,  // [B*Hq, S, D]
    const float* __restrict__ lse,               // [B, Hq, S]
    const float* __restrict__ delta,
    const float* __restrict__ dlse,
    __nv_bfloat16* __restrict__ dk,              // [B, Hkv, S, D]
    __nv_bfloat16* __restrict__ dv,
    int Hq, int Hkv, int S, int causal, float sm_scale) {
  using C = Cfg<D>;
  constexpr int SW = C::SW, PW = C::PW, BK = C::BK, DN = C::DN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + C::KV_BYTES;
  const uint32_t ring = v_s + C::KV_BYTES;  // stage s: Q at ring + 2s*T_BYTES, dO after it
  const uint32_t stats_u32 = ring + STAGES * 2 * C::T_BYTES;
  float* stats = reinterpret_cast<float*>(smem_raw + (stats_u32 - smem_u32(smem_raw)));
  const uint32_t bars = stats_u32 + C::STAT_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t kv_bar = bars + 16 * STAGES;

  const int k0 = (blockIdx.x / C::NDH) * BK, dh = blockIdx.x % C::NDH;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, kv_plane = b * Hkv + hkv;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const float scale_log2 = sm_scale * LOG2E;

  // query tiles: for each of the group's heads, from the diagonal's tile on
  const int q_begin = causal ? k0 : 0;  // a multiple of BQ
  const int n_qt = (S - q_begin + BQ - 1) / BQ;
  const int n_tiles = G * n_qt;

  auto load_q = [&](int n) {
    const int s = n % STAGES;
    const int q_plane = b * Hq + hkv * G + n / n_qt, q0 = q_begin + (n % n_qt) * BQ;
    const uint32_t q_t = ring + 2 * s * C::T_BYTES, do_t = q_t + C::T_BYTES;
    mbar_expect_tx(full(s), 2 * C::T_BYTES);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tma_load_3d(q_t + p * BQ * SW, &q_map, full(s), p * PW, q0, q_plane);
      tma_load_3d(do_t + p * BQ * SW, &do_map, full(s), p * PW, q0, q_plane);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::THREADS);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < D / PW; ++p) {
      tma_load_3d(k_s + p * BK * SW, &k_map, kv_bar, p * PW, k0, kv_plane);
      tma_load_3d(v_s + p * BK * SW, &v_map, kv_bar, p * PW, k0, kv_plane);
    }
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load_q(n);
  }
  __syncwarp();

  // this thread's key rows: r and r + 8 of its warpgroup's 64
  const int r = warp * 16 + lane / 4;
  const int wg_first = k0 + wg * 64;
  const int key[2] = {wg_first + r, wg_first + r + 8};
  float dk_acc[DN / 2], dv_acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % STAGES;
    const int q_plane = b * Hq + hkv * G + n / n_qt, q0 = q_begin + (n % n_qt) * BQ;
    const uint32_t q_t = ring + 2 * s * C::T_BYTES, do_t = q_t + C::T_BYTES;
    mbar_wait(full(s), (n / STAGES) & 1);
    // skip a tile wholly under the causal mask, or keys wholly past S, for this warpgroup
    if (!(causal && q0 + BQ - 1 < wg_first) && wg_first < S) {
      // the tile's statistics; the full barrier above implies every thread is
      // done with this stage's previous tile, statistics included
      float* lse_s = stats + (s * C::NWG + wg) * 2 * BQ;
      float* dd_s = lse_s + BQ;
      if (t < BQ) {
        const int q = q0 + t;
        const size_t i = (size_t)q_plane * S + q;
        lse_s[t] = q < S ? lse[i] * LOG2E : -INFINITY;
        dd_s[t] = q < S ? dlse[i] - delta[i] : 0.f;
      }

      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t panel = kk / (PW / 16), step = (kk % (PW / 16)) * 32;
        const uint32_t a_off = panel * BK * SW + wg * 64 * SW + step, b_off = panel * BQ * SW + step;
        Wgmma<BQ>::ss(st, make_desc(k_s + a_off, 16, 8 * SW, SW), make_desc(q_t + b_off, 16, 8 * SW, SW), kk > 0);
        Wgmma<BQ>::ss(dpt, make_desc(v_s + a_off, 16, 8 * SW, SW), make_desc(do_t + b_off, 16, 8 * SW, SW),
                      kk > 0);
      }
      wgmma_commit();
      named_sync(1 + wg, 128);  // the statistics are written
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const bool masked = (causal && wg_first + 63 > q0) || q0 + BQ > S || wg_first + 64 > S;
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * jj + 2 * (lane % 4) + c;
          const float lse2 = lse_s[col], dd = dd_s[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h + c;
            const bool live = lse2 != -INFINITY && !(masked && (key[h] >= S || (causal && key[h] > q0 + col)));
            const float p = live ? exp2f(fmaf(st[i], scale_log2, -lse2)) : 0.f;
            st[i] = p;
            dpt[i] = p * (dpt[i] + dd);
          }
        }

      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        acc_to_a(st, kk, pa[kk]);
        acc_to_a(dpt, kk, dsa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        // the B operand's columns dh*DN.. start at panel dh*DN/PW
        const uint32_t off = (dh * DN / PW) * BQ * SW + kk * 16 * SW;
        Wgmma<DN>::rs(dv_acc, pa[kk], make_desc(do_t + off, BQ * SW, 8 * SW, SW), 1);
        Wgmma<DN>::rs(dk_acc, dsa[kk], make_desc(q_t + off, BQ * SW, 8 * SW, SW), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    mbar_arrive(empty(s));
    if (tid == 0 && n + STAGES < n_tiles) {
      mbar_wait(empty(s), (n / STAGES) & 1);  // every thread is done with stage s
      load_q(n + STAGES);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= S) continue;
    const size_t row = ((size_t)kv_plane * S + key[h]) * D + dh * DN + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < DN / 8; ++jj) {
      const int i = 4 * jj + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * jj) =
          __floats2bfloat162_rn(dk_acc[i] * sm_scale, dk_acc[i + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * jj) = __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const void* lse, const void* delta, const void* dlse, void* dk,
           void* dv, int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = encode_3d(&q_map, q, D, S, B * Hq, C::PW, BQ, C::SW);
  if (!e) e = encode_3d(&do_map, dO, D, S, B * Hq, C::PW, BQ, C::SW);
  if (!e) e = encode_3d(&k_map, k, D, S, B * Hkv, C::PW, C::BK, C::SW);
  if (!e) e = encode_3d(&v_map, v, D, S, B * Hkv, C::PW, C::BK, C::SW);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + C::BK - 1) / C::BK * C::NDH, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, do_map, (const float*)lse, (const float*)delta, (const float*)dlse,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Hq, Hkv, S, causal, sm_scale);
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
