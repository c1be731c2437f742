// Device functions shared by the fused Swin block forward
// (fused_block.cu) and backward (fused_block_bwd.cu) kernels: bf16
// packing, the m16n8k16 tensor-core product and the warp GEMMs built on
// it, the shared-memory row padding, and the counter-based dropout hash
// (the murmur3 finalizer of ops/prng.py, bit for bit).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kEps = 1e-6f;
constexpr int kKeyChunk = 64;  // keys per online-softmax step
constexpr int kNT = 8;         // n-tiles (of 8 columns) per warp GEMM chunk

__host__ __device__ constexpr int pad16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two bf16 values (lo at the lower k index) as one mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Elements p[0] and p[step] as one operand register (generic address:
// shared or global memory); one 32-bit load when they are adjacent.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int step) {
  return step == 1 ? lds32(p) : pack_bf16(p[0], p[step]);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += A[r0 + 16 mt .. +16, 0..K) @ Bt[n0 + 8 nt .. +8, 0..K)^T
// for the warp's `mtiles` row tiles and `ntiles` <= kNT column tiles.
// A: row-major, stride lda (shared or global memory, rows up to r0 + 31
// readable); Bt: device memory, [N][K].
__device__ __forceinline__ void warp_gemm_acc(float (&acc)[2][kNT][4],
                                              const bf16* A, int lda, int r0,
                                              int mtiles, const bf16* Bt,
                                              int ldb, int n0, int ntiles,
                                              int K, int lane) {
  const int g = lane / 4, cq = lane % 4;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const bf16* a0 = A + (r0 + mt * 16 + g) * lda + k0 + 2 * cq;
      af[mt][0] = lds32(a0);
      af[mt][1] = lds32(a0 + 8 * lda);
      af[mt][2] = lds32(a0 + 8);
      af[mt][3] = lds32(a0 + 8 * lda + 8);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < ntiles) {
        const bf16* b = Bt + (size_t)(n0 + nt * 8 + g) * ldb + k0 + 2 * cq;
        const uint32_t b0 = ldg32(b), b1 = ldg32(b + 8);
        mma16816(acc[0][nt], af[0], b0, b1);
        if (mtiles > 1) mma16816(acc[1][nt], af[1], b0, b1);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
}

__device__ __forceinline__ void warp_gemm(float (&acc)[2][kNT][4],
                                          const bf16* A, int lda, int r0,
                                          int mtiles, const bf16* Bt, int ldb,
                                          int n0, int ntiles, int K, int lane) {
  zero_acc(acc);
  warp_gemm_acc(acc, A, lda, r0, mtiles, Bt, ldb, n0, ntiles, K, lane);
}

// murmur3 finalizer over the counter (ops/prng.py::hash_u32).
__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t idx) {
  uint32_t x = idx * 0x9E3779B9u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Inverted-dropout keep value: `scale` where the low 24 hash bits reach
// `threshold`, else 0 (ops/prng.py::keep_mask).
__device__ __forceinline__ float keep_value(uint32_t seed, uint32_t idx,
                                            uint32_t threshold, float scale) {
  return (hash_u32(seed, idx) & 0xFFFFFFu) >= threshold ? scale : 0.f;
}

// Dropout settings of one block call.  Attention counters are
// ((w*H + head)*M + row)*drop_cols + col(j), with col(j) = j for keys up
// to the fold column (index M) and j + drop_cols - N after it: the JAX
// kernel's alignment columns.  Projection counters are (w*M + row)*C + c.
struct DropArgs {
  uint32_t seed_a, seed_p, thr_a, thr_p;
  float keep_a, keep_p;
  int drop_cols;
};

__device__ __forceinline__ uint32_t drop_col(int j, int m, int gap) {
  return (uint32_t)(j > m ? j + gap : j);
}

}  // namespace
