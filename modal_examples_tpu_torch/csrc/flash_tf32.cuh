// Shared pieces of the f32 flash kernels, which run on the tensor cores
// (flash_fwd_f32.cu, flash_bwd_dq_f32.cu, flash_bwd_dkv_f32.cu):
// f32-accurate products from TF32 ones by a 3xTF32 split.
//
// The split: each f32 operand x is carried as big = rna(x), its top 19 bits
// rounded to nearest, ties away from zero (as cvt.rna.tf32.f32), and
// small = rna(x - big), the remainder (x - big is exact in f32). A product
// a.b is then taken as a_small.b_big + a_big.b_small + a_big.b_big, in that
// order, every term a TF32 tensor-core product with f32 sums; the dropped
// a_small.b_small is about 2^-22 of a.b. (Small parts of zero give one TF32
// pass: a planted fault of chip_smoke.F32_FAULTS.) Both parts are rounded
// before the tensor core reads them, so what it reads is the same whether
// it truncates or rounds the low 13 bits of an operand. One TF32 pass (big.big alone) keeps about 3
// decimal digits; the split keeps f32's (within 1e-4 of the largest value
// where one pass is 4e-4 off, at GPT's shapes).
//
// Every product runs on wgmma m64nNk8 tf32, which has no transpose (tnspB
// is for 16-bit types): both operands must be K-major. An operand whose
// depth runs along its rows as it lands (Q and K in Q.K^T) is read where it
// is. One whose depth runs down its columns (V in P.V, dO and Q in dV and
// dK) is first written transposed, big and small parts, into a tile of its
// own (transpose_tile; way (a)), as is K in dS.K, whose depth is the keys.
// The A operand of those products is the previous product's f32
// accumulator, taken as register fragments with no data moving between
// threads (acc_to_a): that fixes the order of the depth within each
// 8-chunk, and the transposed tile is written in the same order.
//
// Tiles are f32 panels of 32 columns (128 bytes) by R rows, in TMA's
// 128-byte swizzle; hopper.cuh's descriptors walk them as they walk bf16's
// (a k8 step of f32 is 32 bytes, as a k16 step of bf16).
#pragma once

#include "hopper.cuh"

namespace tf32 {

constexpr int PW = 32;    // f32 columns per 128-byte panel
constexpr int SW = 128;   // swizzle span, bytes

// x rounded to TF32 (nearest, ties away from zero), as a 32-bit pattern:
// what cvt.rna.tf32.f32 gives for a finite x, in two integer operations
// (half of the dropped 13 bits' span added to the magnitude, then dropped)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

// Splits the N floats at `tile` (16-byte aligned) in place into their big
// parts, writing the small parts at the same offsets from `small`; the
// THREADS threads of the warpgroup share the work, each loading a batch of
// float4s before it stores any (one warp a scheduler has no other warp to
// hide a load's latency behind). The caller orders these writes before the
// tensor core's reads (fence_proxy_async and a barrier).
template <int N, int THREADS>
__device__ __forceinline__ void split_tile(float* __restrict__ tile, float* __restrict__ small, int tid) {
  constexpr int ITERS = N / (4 * THREADS), BATCH = ITERS < 8 ? ITERS : 8;
  static_assert(N % (4 * THREADS) == 0 && ITERS % BATCH == 0, "a tile is whole batches of float4s");
#pragma unroll
  for (int i0 = 0; i0 < ITERS; i0 += BATCH) {
    float4 x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) x[u] = *reinterpret_cast<const float4*>(tile + 4 * (tid + (i0 + u) * THREADS));
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      uint32_t b[4], sm[4];
      split(x[u].x, b[0], sm[0]);
      split(x[u].y, b[1], sm[1]);
      split(x[u].z, b[2], sm[2]);
      split(x[u].w, b[3], sm[3]);
      const int at = 4 * (tid + (i0 + u) * THREADS);
      *reinterpret_cast<uint4*>(tile + at) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(small + at) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
  }
}

// Byte offset of element (row, col) in a tile of `rows` rows stored as
// 32-column panels in the 128-byte swizzle (the 16-byte chunk index XOR
// the row's index mod 8).
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  const int c = col % PW;
  return (uint32_t)((col / PW) * rows * SW + row * SW + ((((c >> 2) ^ (row & 7)) << 4) | ((c & 3) << 2)));
}

// K-major descriptor of depth step kk (8 columns) of a tile of `rows` rows
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return hopper::make_desc(tile + (kk / 4) * rows * SW + (kk % 4) * 32, 16, 8 * SW, SW);
}

// desc_k of step kk from step 0's descriptor: a step moves only the start
// address, in the descriptor's low 14 bits (16-byte units; shared
// addresses stay below 256 KB, so the sum never carries out of them)
__device__ __forceinline__ uint64_t desc_step(uint64_t d0, int rows, int kk) {
  return d0 + (uint64_t)(((kk / 4) * rows * SW + (kk % 4) * 32) >> 4);
}

// A zero the compiler cannot see through. Added to the tiles' addresses at
// the top of a loop's body, it keeps the descriptors of every depth step of
// tiles that do not move from being hoisted out of the loop and held in
// registers across it (a D = 128 kernel has over a hundred of them).
__device__ __forceinline__ uint32_t opaque_zero() {
  uint32_t z;
  asm volatile("mov.u32 %0, 0;\n" : "=r"(z));
  return z;
}

// The A fragment of depth chunk j (8 columns) of an m64nN f32 accumulator,
// split. The tf32 A fragment of a warp's 16 rows holds, in a[0..3], (row,
// column) (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) with g = lane / 4
// and t = lane % 4; the accumulator holds columns 2t and 2t + 1 of rows g
// and g + 8. So the chunk's columns are taken in the order 0, 2, 4, 6, 1, 3,
// 5, 7: fragment column t is column 2t, t + 4 is 2t + 1, and the B
// operand's depth rows must come in the same order (transpose_tile).
__device__ __forceinline__ void acc_to_a(const float* acc, int j, uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(acc[4 * j + 0], big[0], small[0]);
  split(acc[4 * j + 2], big[1], small[1]);
  split(acc[4 * j + 1], big[2], small[2]);
  split(acc[4 * j + 3], big[3], small[3]);
}

// Pins register fragments at this point of the program: placed before a
// wgmma_fence, the fragments that the following wgmmas read as A are
// computed before it (the compiler sees no tie between the fence and
// them), as the fence requires.
template <int K>
__device__ __forceinline__ void pin_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// Writes columns [col0, col0 + COLS) of a tile of DEPTH rows (as TMA
// landed it: 32-column panels, swizzled) transposed, as COLS rows of DEPTH
// columns into `big` and `small` (the same layout), each 8-row chunk's rows
// in acc_to_a's order 0, 2, 4, 6, 1, 3, 5, 7: the K-major B operand of a
// product whose depth is the tile's rows. SPLIT: the source holds f32
// values, split here; otherwise `src` holds the big parts and `src_small`
// the small ones. A unit is one destination 16-byte chunk of a row; the 32
// lanes of a warp take 32 consecutive columns, so the reads hit one
// swizzled row and the writes 8 distinct chunks a quarter-warp (no bank
// conflicts). Each thread loads a batch of units before it stores any.
template <bool SPLIT, int DEPTH, int COLS, int THREADS>
__device__ __forceinline__ void transpose_tile(const float* __restrict__ src, const float* __restrict__ src_small,
                                               int col0, float* __restrict__ big, float* __restrict__ small,
                                               int tid) {
  constexpr int UNITS = COLS * DEPTH / 4 / THREADS, BATCH = UNITS < 4 ? UNITS : 4;
  static_assert((COLS * DEPTH / 4) % THREADS == 0 && UNITS % BATCH == 0, "a tile is whole batches of units");
#pragma unroll
  for (int u0 = 0; u0 < UNITS; u0 += BATCH) {
    float x[BATCH][4], xs[BATCH][4];
#pragma unroll
    for (int v = 0; v < BATCH; ++v) {
      const int u = tid + (u0 + v) * THREADS;
      const int c = u % COLS, j = u / COLS / 2, h = u / COLS % 2;  // row c; chunk j's positions 4h..4h+3
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // position 4h + i holds source row 8j + 2i + h
        const uint32_t at = swz(8 * j + 2 * i + h, col0 + c, DEPTH) / 4;
        x[v][i] = src[at];
        if (!SPLIT) xs[v][i] = src_small[at];
      }
    }
#pragma unroll
    for (int v = 0; v < BATCH; ++v) {
      const int u = tid + (u0 + v) * THREADS;
      const int c = u % COLS, j = u / COLS / 2, h = u / COLS % 2;
      uint32_t b[4], sm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (SPLIT) {
          split(x[v][i], b[i], sm[i]);
        } else {
          b[i] = __float_as_uint(x[v][i]);
          sm[i] = __float_as_uint(xs[v][i]);
        }
      }
      const uint32_t dst = swz(c, 8 * j + 4 * h, COLS) / 4;
      *reinterpret_cast<uint4*>(big + dst) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(small + dst) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
  }
}

// Splits a tile of DEPTH rows by COLS columns (as TMA landed it) in place
// and writes it transposed and split in the same pass: transpose_tile<true>
// over all its columns, with every value it reads written back as its big
// part and its small part put at the same offset from `small`. Each value is
// read and written by one thread, at addresses whose reads are free of bank
// conflicts, so the pass needs no barrier of its own.
template <int DEPTH, int COLS, int THREADS>
__device__ __forceinline__ void split_transpose_tile(float* __restrict__ tile, float* __restrict__ small,
                                                     float* __restrict__ big_t, float* __restrict__ small_t,
                                                     int tid) {
  constexpr int UNITS = COLS * DEPTH / 4 / THREADS, BATCH = UNITS < 4 ? UNITS : 4;
  static_assert((COLS * DEPTH / 4) % THREADS == 0 && UNITS % BATCH == 0, "a tile is whole batches of units");
#pragma unroll
  for (int u0 = 0; u0 < UNITS; u0 += BATCH) {
    float x[BATCH][4];
#pragma unroll
    for (int v = 0; v < BATCH; ++v) {
      const int u = tid + (u0 + v) * THREADS;
      const int c = u % COLS, j = u / COLS / 2, h = u / COLS % 2;  // row c; chunk j's positions 4h..4h+3
#pragma unroll
      for (int i = 0; i < 4; ++i) x[v][i] = tile[swz(8 * j + 2 * i + h, c, DEPTH) / 4];  // source row 8j + 2i + h
    }
#pragma unroll
    for (int v = 0; v < BATCH; ++v) {
      const int u = tid + (u0 + v) * THREADS;
      const int c = u % COLS, j = u / COLS / 2, h = u / COLS % 2;
      uint32_t b[4], sm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(x[v][i], b[i], sm[i]);
        const uint32_t at = swz(8 * j + 2 * i + h, c, DEPTH) / 4;
        tile[at] = __uint_as_float(b[i]);
        small[at] = __uint_as_float(sm[i]);
      }
      const uint32_t dst = swz(c, 8 * j + 4 * h, COLS) / 4;
      *reinterpret_cast<uint4*>(big_t + dst) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(small_t + dst) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
  }
}

// wgmma.mma_async m64nNk8, f32 += tf32 x tf32, for one warpgroup (no
// transpose: both operands K-major). Register d[4j + 2h + c] holds row
// 16 * warp + lane / 4 + 8h, column 8j + 2 * (lane % 4) + c. ss: A and B
// from shared memory; rs: A from registers (acc_to_a's fragment layout, in
// each warp's 16 rows). scale_d = 0 overwrites d.
template <int N>
struct Tf32Wgmma;

template <>
struct Tf32Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
        "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
        "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Tf32Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
        "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

}  // namespace tf32
