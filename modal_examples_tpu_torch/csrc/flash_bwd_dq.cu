// Flash attention backward, dQ, for Hopper (sm_90a): causal or full
// self-attention with GQA.
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_dq_kernel (per-block
// math in _bwd_block_ds; driven by _flash_backward). With
// P = exp(scale * Q.K^T - lse) and dS = P * (dO.V^T - delta + dlse),
// dQ = scale * dS.K. The TPU kernel carried dQ in VMEM scratch across a
// sequential key-block grid axis; Hopper blocks run in no order, so here one
// block owns a (batch, query head, query tile), loops over the key tiles up
// to the causal limit itself (tiles wholly above the diagonal are never
// loaded, as on the TPU), keeps dQ in f32 registers and writes it once.
//
// Inputs: q, k, v, dO bf16 ([B, Hq, S, D] and [B, Hkv, S, D]); lse, delta,
// dlse f32 [B, Hq, S]. Output dQ bf16 [B, Hq, S, D].
//
// Bound: operations (three products of S*S*D/2 per head when causal, against
// about 8*S*D bytes per head). The design is flash_bwd_dkv.cu's, turned
// around: the query rows are fixed and the keys stream.
// - Every product is a warpgroup MMA (wgmma, bf16 in, f32 sums). Each
//   consumer warpgroup owns 64 query rows (two warpgroups, 128 rows, at
//   D <= 128; one at D = 256, to fit shared memory) and keeps its dQ in f32
//   registers. Per key tile of 64:
//     S = Q.K^T and dP = dO.V^T: m64n64k16, all operands from shared
//     memory, K-major;
//     P = exp2(S * scale*log2(e) - lse*log2(e)), 0 where lse = -inf (a fully
//     masked row or a row past S), for keys past S or above the diagonal;
//     dS = P * (dP - delta + dlse);
//     dQ += dS.K: m64n{DN}k16 with A from registers (the f32 fragment of dS
//     is the A operand's fragment, rounded to bf16) and B = the same K tile
//     read MN-major (tnspB). dS never goes through shared memory.
// - Q and dO arrive once by TMA (hopper.cuh); K and V tiles stream through
//   a ring of STAGES stages, each with a "full" mbarrier (completed by the
//   TMA bytes) and an "empty" one (every consumer thread arrives when its
//   products on the stage are done). One thread issues the loads; the tile
//   after the one being multiplied is in flight.
// - A block's rows are fixed, so each thread keeps its two rows'
//   lse*log2(e) and dlse - delta in registers for the whole loop.
// - At D = 256 a block covers half of D (DN = 128: 64 dQ accumulators a
//   thread) and the grid has two blocks per query tile, each recomputing S
//   and dP, as flash_bwd_dkv.cu does.
// - The tensor maps are 3-D over [B*H, S, D]: rows past S of one head read
//   as zeros, never the next head's rows. Rows of dQ past S are not written.
// - Causal: only the key tile the diagonal crosses is masked; a warpgroup
//   skips the products of a tile wholly past its last row. The grid
//   launches the heaviest query tiles (the last ones) first.
#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int BK = 64;      // key rows per tile
constexpr int STAGES = 2;   // K/V ring depth

template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span: the bytes of one panel row
  static constexpr int PW = SW / 2;              // bf16 columns per panel
  static constexpr int NP = D / PW;              // panels per tile
  static constexpr int NWG = D <= 128 ? 2 : 1;   // consumer warpgroups
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BQ = 64 * NWG;            // query rows per block
  static constexpr int DN = D <= 128 ? D : 128;  // dQ columns per block
  static constexpr int NDH = D / DN;             // blocks per query tile
  static constexpr uint32_t T_BYTES = BQ * D * 2;   // one of Q, dO
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr uint32_t BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 of slack to align the tiles; then Q, dO, the ring, the barriers
  static constexpr uint32_t SMEM = 1024 + 2 * T_BYTES + STAGES * 2 * KV_BYTES + BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap q_map,   // [B*Hq, S, D]
    const __grid_constant__ CUtensorMap k_map,   // [B*Hkv, S, D]
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,  // [B*Hq, S, D]
    const float* __restrict__ lse,               // [B, Hq, S]
    const float* __restrict__ delta,
    const float* __restrict__ dlse,
    __nv_bfloat16* __restrict__ dq,              // [B, Hq, S, D]
    int Hq, int Hkv, int S, int causal, float sm_scale) {
  using C = Cfg<D>;
  constexpr int SW = C::SW, PW = C::PW, NP = C::NP, BQ = C::BQ, DN = C::DN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + C::T_BYTES;
  const uint32_t ring = do_s + C::T_BYTES;  // stage s: K at ring + 2s*KV_BYTES, V after it
  const uint32_t bars = ring + STAGES * 2 * C::KV_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 16 * STAGES;

  const int q0 = (gridDim.x / C::NDH - 1 - blockIdx.x / C::NDH) * BQ;  // heaviest causal tiles first
  const int dh = blockIdx.x % C::NDH;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int q_plane = b * Hq + hq, kv_plane = b * Hkv + hq / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const float scale_log2 = sm_scale * LOG2E;
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int n) {
    const int s = n % STAGES;
    const uint32_t k_s = ring + 2 * s * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
    mbar_expect_tx(full(s), 2 * C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_3d(k_s + p * BK * SW, &k_map, full(s), p * PW, n * BK, kv_plane);
      tma_load_3d(v_s + p * BK * SW, &v_map, full(s), p * PW, n * BK, kv_plane);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::THREADS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * C::T_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_3d(q_s + p * BQ * SW, &q_map, q_bar, p * PW, q0, q_plane);
      tma_load_3d(do_s + p * BQ * SW, &do_map, q_bar, p * PW, q0, q_plane);
    }
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load_kv(n);
  }
  __syncwarp();

  // this thread's rows: r and r + 8 of its warpgroup's 64, with their
  // statistics (rows past S act as fully masked)
  const int r = warp * 16 + lane / 4;
  const int wg_first = q0 + wg * 64;
  const int row[2] = {wg_first + r, wg_first + r + 8};
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t i = (size_t)q_plane * S + row[h];
    lse2[h] = row[h] < S ? lse[i] * LOG2E : -INFINITY;
    dd[h] = row[h] < S ? dlse[i] - delta[i] : 0.f;
  }
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    const uint32_t k_s = ring + 2 * s * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
    mbar_wait(full(s), (j / STAGES) & 1);
    // skip a tile wholly above the diagonal, or rows wholly past S, for this warpgroup
    if (!(causal && k0 > wg_first + 63) && wg_first < S) {
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t panel = kk / (PW / 16), step = (kk % (PW / 16)) * 32;
        const uint32_t a_off = panel * BQ * SW + wg * 64 * SW + step, b_off = panel * BK * SW + step;
        Wgmma<BK>::ss(sc, make_desc(q_s + a_off, 16, 8 * SW, SW), make_desc(k_s + b_off, 16, 8 * SW, SW), kk > 0);
        Wgmma<BK>::ss(dp, make_desc(do_s + a_off, 16, 8 * SW, SW), make_desc(v_s + b_off, 16, 8 * SW, SW),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool masked = (causal && k0 + BK - 1 > wg_first) || k0 + BK > S;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + 8 * jj + 2 * (lane % 4) + c;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h + c;
            const bool live = lse2[h] != -INFINITY && !(masked && (col >= S || (causal && col > row[h])));
            const float p = live ? exp2f(fmaf(sc[i], scale_log2, -lse2[h])) : 0.f;
            dp[i] = p * (dp[i] + dd[h]);
          }
        }

      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(dp, kk, dsa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // the B operand's columns dh*DN.. start at panel dh*DN/PW
        const uint32_t off = (dh * DN / PW) * BK * SW + kk * 16 * SW;
        Wgmma<DN>::rs(acc, dsa[kk], make_desc(k_s + off, BK * SW, 8 * SW, SW), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(empty(s));
    if (tid == 0 && j + STAGES < n_tiles) {
      mbar_wait(empty(s), (j / STAGES) & 1);  // every thread is done with stage s
      load_kv(j + STAGES);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= S) continue;
    __nv_bfloat16* out = dq + ((size_t)q_plane * S + row[h]) * D + dh * DN + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < DN / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h] * sm_scale, acc[4 * jj + 2 * h + 1] * sm_scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const void* lse, const void* delta, const void* dlse, void* dq,
           int B, int Hq, int Hkv, int S, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = encode_3d(&q_map, q, D, S, B * Hq, C::PW, C::BQ, C::SW);
  if (!e) e = encode_3d(&do_map, dO, D, S, B * Hq, C::PW, C::BQ, C::SW);
  if (!e) e = encode_3d(&k_map, k, D, S, B * Hkv, C::PW, BK, C::SW);
  if (!e) e = encode_3d(&v_map, v, D, S, B * Hkv, C::PW, BK, C::SW);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + C::BQ - 1) / C::BQ * C::NDH, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, do_map, (const float*)lse, (const float*)delta, (const float*)dlse,
      (__nv_bfloat16*)dq, Hq, Hkv, S, causal, sm_scale);
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
