// Device functions shared by the fused Swin block forward
// (fused_block.cu), the block pair (fused_pair.cu), the block backward
// (fused_block_bwd.cu) and the window attention kernels
// (window_attention.cu): bf16 packing, the m16n8k16 tensor-core product
// and the warp GEMMs built on it, the shared-memory row padding, the
// counter-based dropout hash (the murmur3 finalizer of ops/prng.py, bit
// for bit), the attention bias built from its factors, one head's
// attention of a 16-row tile (label-equality mask, online fp32 softmax;
// the one softmax body of every kernel here), and one whole Swin block on one window, split over a thread
// block cluster (swin_block_window: B1's body, run once by B1 and twice
// by B5), with the host code that sizes and launches the cluster.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

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

// Activations -- the block's x and output, the backward's dout and dx,
// the attention kernels' y, q, k, v and output -- are fp32 or bf16, one
// flag per launch taken from the input's dtype: the JAX kernels take
// either and write the input's dtype.  The block body (B1, B5) takes the
// flag as a template parameter (its 128-register instances spilled with a
// run-time flag); the backward and the attention kernels read it at run
// time.  Matmul operands are rounded
// to bf16 after the load, as the JAX kernels round them; LN statistics,
// softmax and residuals stay fp32.  Offsets count elements.
template <class T>
__device__ __forceinline__ T* act_at(T* p, size_t i, bool f32) {
  typedef typename std::conditional<std::is_const<T>::value, const char,
                                    char>::type byte;
  return reinterpret_cast<T*>(reinterpret_cast<byte*>(p) + i * (f32 ? 4 : 2));
}

// Elements i and i + 1 (i even) of a typed activation array (the block
// body, whose dtype is a template parameter).
__device__ __forceinline__ float2 ld2(const float* p, size_t i) {
  return *reinterpret_cast<const float2*>(p + i);
}

__device__ __forceinline__ float2 ld2(const bf16* p, size_t i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
}

__device__ __forceinline__ void st2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}

__device__ __forceinline__ void st2(bf16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float ld_act(const void* p, size_t i, bool f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Elements i and i + 1 (i even) of an array of either dtype.
__device__ __forceinline__ float2 ld_act2(const void* p, size_t i, bool f32) {
  return f32 ? ld2(static_cast<const float*>(p), i)
             : ld2(static_cast<const bf16*>(p), i);
}

__device__ __forceinline__ void st_act2(void* p, size_t i, bool f32, float a,
                                        float b) {
  if (f32) st2(static_cast<float*>(p), i, a, b);
  else st2(static_cast<bf16*>(p), i, a, b);
}

__device__ __forceinline__ void st_act(void* p, size_t i, bool f32, float a) {
  if (f32) static_cast<float*>(p)[i] = a;
  else static_cast<bf16*>(p)[i] = __float2bfloat16_rn(a);
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
// readable); Bt: device memory, [N][K], or with KP in the block body's
// k-packed layout (ops/fused_block.py::pack_k16: within each 16-wide k
// block the values 2cq, 2cq + 1, 8 + 2cq and 9 + 2cq of a row are
// adjacent, so a lane's B fragment is one 8-byte load; the same products
// in the same order).
template <bool KP = false>
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
        const bf16* row = Bt + (size_t)(n0 + nt * 8 + g) * ldb + k0;
        uint32_t b0, b1;
        if (KP) {
          const uint2 b = __ldg(reinterpret_cast<const uint2*>(row + 4 * cq));
          b0 = b.x;
          b1 = b.y;
        } else {
          b0 = ldg32(row + 2 * cq);
          b1 = ldg32(row + 2 * cq + 8);
        }
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

template <bool KP = false>
__device__ __forceinline__ void warp_gemm(float (&acc)[2][kNT][4],
                                          const bf16* A, int lda, int r0,
                                          int mtiles, const bf16* Bt, int ldb,
                                          int n0, int ntiles, int K, int lane) {
  zero_acc(acc);
  warp_gemm_acc<KP>(acc, A, lda, r0, mtiles, Bt, ldb, n0, ntiles, K, lane);
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
// w = win_base + the window's index in the call: the window's index in
// the global batch when the call holds one rank's rows of it (data
// parallel), as the JAX kernel's program_id is under jit.  uint32 sums
// wrap at 2^32 as the JAX kernel's do.
struct DropArgs {
  uint32_t seed_a, seed_p, thr_a, thr_p;
  float keep_a, keep_p;
  int drop_cols;
  uint32_t win_base;
};

__device__ __forceinline__ uint32_t drop_col(int j, int m, int gap) {
  return (uint32_t)(j > m ? j + gap : j);
}

// Attention dropout of one 16-row tile (B1's training path): the seed,
// threshold and keep scale, the counter bases of the lane's rows a and b,
// and the fold geometry of drop_col (m, gap).
struct AttnDrop {
  uint32_t seed, thr;
  float keep;
  uint32_t row_a, row_b;
  int m, gap;
};

// Design probes (tools/torch_ab_b1.py --probe): a nonzero MIVP_B1_SKIP
// compiles parts of the block body out (1: attention, 2: q|k|v, 4: the
// row phase's products, 8: LN1, 16: the bias build, 64: P.V) and a
// nonzero MIVP_B1_KS sets the cluster size where it is valid.  A probe's
// output is garbage and only its time is read; the port's own builds
// define neither.
#ifndef MIVP_B1_SKIP
#define MIVP_B1_SKIP 0
#endif
#ifndef MIVP_B1_KS
#define MIVP_B1_KS 0
#endif
// window_attention.cu's probes (MIVP_B6_SKIP); 16 compiles out P.V in
// attend_tile.
#ifndef MIVP_B6_SKIP
#define MIVP_B6_SKIP 0
#endif

constexpr float kThird = 1.0f / 3.0f;

// The same bias built from its factors in shared memory (B1, B5), bit for
// bit the [H, M, N] array that models/relative_pe.py and
// models/swin_block.py assemble on the card:
//
//   j <  m:  ((R[ih_i, ih_j] + Cw[iw_i, iw_j]) + D[id_i, id_j]) / 3 * s
//   j == m:  fold[i]                     (pad-folded geometries)
//   j >  m:  ext[j - m]                  (prompt-token columns)
//
// where (ih, iw, id) is a content row's coordinate in the full window
// (packed ih | iw << 8 | id << 16, plus kNextInDepth when row j + 1 is
// (ih, iw, id + 1): then keys j and j + 1 share R + Cw) and R, Cw, D are
// the per-axis tables of the head.  PyTorch's CUDA division by a scalar
// multiplies by its fp32 reciprocal, so "/ 3" is a product with kThird;
// the adds and products are the _rn intrinsics, which the compiler never
// contracts into an FMA.  tab: the head's [ph*ph | pw*pw | pd*pd | E | M
// (fold only)] table.
constexpr int kNextInDepth = 1 << 24;

struct FactoredBias {
  const float* tab;
  const int* coord;
  int m, ph, pw, pd, oc, od, oe, of;
  bool fold;
  float scale;
  struct Row {
    int r, c, d;
    float f;
  };
  __device__ __forceinline__ Row row(int i) const {
    const int ci = coord[i];
    return {(ci & 255) * ph, oc + ((ci >> 8) & 255) * pw,
            od + ((ci >> 16) & 255) * pd, fold ? tab[of + i] : 0.f};
  }
  __device__ __forceinline__ Row row(int i, int) const { return row(i); }
  __device__ __forceinline__ int col(int j) const {
    return j < m ? coord[j] : 0;
  }
  __device__ __forceinline__ float scaled(float t) const {
    return __fmul_rn(__fmul_rn(t, kThird), scale);
  }
  __device__ __forceinline__ float at(const Row& r, int j) const {
    if (j < m) {
      const int cj = coord[j];
      return scaled(__fadd_rn(__fadd_rn(tab[r.r + (cj & 255)],
                                        tab[r.c + ((cj >> 8) & 255)]),
                              tab[r.d + ((cj >> 16) & 255)]));
    }
    return (fold && j == m) ? r.f : tab[oe + j - m];
  }
  // bias[i, j] and bias[i, j + 1] for j even, cj = col(j); values past
  // the keys are garbage (reads stay inside the CTA's tables).  Every
  // kind of key takes this code (KIND: attend_tile's, unused).
  template <int KIND = 0>
  __device__ __forceinline__ void pair(const Row& r, int cj, int j,
                                       float& b0, float& b1) const {
    if (MIVP_B1_SKIP & 16) {
      b0 = b1 = 0.f;
    } else if (j < m && (cj & kNextInDepth)) {
      const float rc = __fadd_rn(tab[r.r + (cj & 255)],
                                 tab[r.c + ((cj >> 8) & 255)]);
      const int dj = r.d + ((cj >> 16) & 255);
      b0 = scaled(__fadd_rn(rc, tab[dj]));
      b1 = scaled(__fadd_rn(rc, tab[dj + 1]));
    } else {
      b0 = at(r, j);
      b1 = at(r, j + 1);
    }
  }
};

// Attention of one head for the 16 query rows t0..t0+15 of a warp, on
// tensor cores: the one softmax body of the block kernels (B1, B5, B4's
// recompute, through attend_rows) and the window-attention kernels
// (B6/B7/B8).  Each lane quad holds rows a = t0 + g and b = t0 + g + 8:
//
//   s = (q.k * scale + bias[i, j]) * (lab_i == lab_j || lab_j < 0)
//   o = softmax(s) v        fp32, max-subtracted, online over KC-key
//                           steps; P fed to P.V as bf16
//
// qa: the tile's Q as A fragments (qa[ks]: rows a and b at columns 16 ks
// + 2 cq + {0, 1} and + 8).  Shared memory: K rows [npad][qs] of DHK
// bf16 (the head dim zero-padded to the k-step), V^T [DHK][vs]; key rows
// n..npad of K and V^T are zero.  bias: the head's bias (FactoredBias, or
// window_attention.cu's WindowBias / GlobalBias): row(i, lane), col(j)
// and pair<KIND>(row, col(j), j, b0, b1) for j even; slab: the window's
// key labels (read only when `masked`).
//
// FULL (n = npad, a multiple of KC): every key tile holds keys, so the
// bounds checks go, and each step runs code compiled for its kind of keys
// (pair<1> below bias.split(), pair<2> from it) and for the mask or none:
// one block of straight-line code per step, which the compiler schedules
// across key tiles.  Otherwise one body takes every step.  l * corr is
// rounded on its own (__fmul_rn): the straight-line code would let the
// compiler fuse it with the step's first add, and the two forms give the
// same bits.  DROP: attention dropout after the softmax statistics (dr).
//
// On return o[dt] holds the normalised output of row a (o[dt][0..1]) and
// row b (o[dt][2..3]) at head columns dt * 8 + 2 cq + {0, 1}, and, where
// `ml` is given (the block backward's recompute), ml[0] and ml[1] the
// softmax max and (undropped) sum of rows a and b.
// A flag known at compile time (std::true_type, std::false_type) or at
// run time (bool), as a bool in device code.
__device__ __forceinline__ constexpr bool flag_of(std::true_type) {
  return true;
}
__device__ __forceinline__ constexpr bool flag_of(std::false_type) {
  return false;
}
__device__ __forceinline__ bool flag_of(bool b) { return b; }

template <int DHK, int KC, bool FULL, bool DROP, class Bias>
__device__ __forceinline__ void attend_tile(
    float (&o)[DHK / 8][4], const uint32_t (&qa)[DHK / 16][4],
    const bf16* sk, int qs, const bf16* svt, int vs, const int* slab,
    bool masked, const Bias& bias, int t0, int m, int n, int npad,
    float scale, const AttnDrop& dr, int lane, float (*ml)[2] = nullptr) {
  constexpr int KSTEPS = DHK / 16;   // k-steps of QK^T
  constexpr int DTILES = DHK / 8;    // n-tiles of P.V
  const int g = lane / 4, cq = lane % 4;
  int lab[2];
  typename Bias::Row brow[2];
  float mrow[2], lrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = t0 + g + 8 * r;
    const bool valid = i < m;
    lab[r] = (masked && valid) ? slab[i] : 0;
    brow[r] = bias.row(valid ? i : 0, lane);
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

#pragma unroll 1
  for (int j0 = 0; j0 < npad; j0 += KC) {
    const int ntiles = FULL ? KC / 8 : min(KC, npad - j0) / 8;  // even
    float s[KC / 8][4];
    float mx[2] = {-INFINITY, -INFINITY};
    // The step's scores and row maxima, for KIND (the bias's kind of
    // keys) known at compile time and `msk` a compile-time constant
    // (FULL) or the run-time flag.
    auto scores = [&](auto kind, auto msk) {
      constexpr int KIND = decltype(kind)::value;
      const bool mask_on = flag_of(msk);
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
        if (!FULL) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
        if (FULL || nt < ntiles) {
          float sc[4] = {0.f, 0.f, 0.f, 0.f};
          const bf16* k0 = sk + (j0 + nt * 8 + g) * qs + 2 * cq;
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks)
            mma16816(sc, qa[ks], lds32(k0 + ks * 16), lds32(k0 + ks * 16 + 8));
          const int jp = j0 + nt * 8 + 2 * cq;   // keys jp, jp + 1
          const int cj = KIND == 2 ? 0 : bias.col(jp);
          float bv[4];
          bias.template pair<KIND>(brow[0], cj, jp, bv[0], bv[1]);
          bias.template pair<KIND>(brow[1], cj, jp, bv[2], bv[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = jp + (e & 1);
            if (FULL || j < n) {
              float v = sc[e] * scale + bv[e];
              if (mask_on) {
                const int lj = slab[j];
                if (!(lj == lab[e / 2] || lj < 0)) v = 0.f;
              }
              s[nt][e] = v;
            }
          }
          mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
      }
    };
    typedef std::integral_constant<int, 0> AnyKeys;
    if constexpr (!FULL) {
      scores(AnyKeys{}, masked);
    } else {
      typedef std::integral_constant<int, 1> LowKeys;
      typedef std::integral_constant<int, 2> HighKeys;
      const bool low = j0 + KC <= bias.split();
      const bool high = j0 >= bias.split();
      if (masked) {
        if (low) scores(LowKeys{}, std::true_type{});
        else if (high) scores(HighKeys{}, std::true_type{});
        else scores(AnyKeys{}, std::true_type{});
      } else {
        if (low) scores(LowKeys{}, std::false_type{});
        else if (high) scores(HighKeys{}, std::false_type{});
        else scores(AnyKeys{}, std::false_type{});
      }
    }
    float nw[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      nw[r] = fmaxf(mrow[r], mx[r]);
      corr[r] = __expf(mrow[r] - nw[r]);
      mrow[r] = nw[r];
      lrow[r] = __fmul_rn(lrow[r], corr[r]);
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (FULL || 2 * kk < ntiles) {
        float p[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          p[u][0] = __expf(s[2 * kk + u][0] - nw[0]);
          p[u][1] = __expf(s[2 * kk + u][1] - nw[0]);
          p[u][2] = __expf(s[2 * kk + u][2] - nw[1]);
          p[u][3] = __expf(s[2 * kk + u][3] - nw[1]);
          lrow[0] += p[u][0] + p[u][1];
          lrow[1] += p[u][2] + p[u][3];
        }
        if (DROP && dr.thr) {
          // Attention dropout after the softmax statistics, before the
          // bf16 cast that feeds P.V (l keeps the undropped sum).
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = j0 + kk * 16 + u * 8 + 2 * cq + (e & 1);
              p[u][e] *= keep_value(dr.seed,
                                    (e < 2 ? dr.row_a : dr.row_b) +
                                        drop_col(j, dr.m, dr.gap),
                                    dr.thr, dr.keep);
            }
        }
        const uint32_t pa[4] = {pack2(p[0][0], p[0][1]), pack2(p[0][2], p[0][3]),
                                pack2(p[1][0], p[1][1]), pack2(p[1][2], p[1][3])};
        const int jk = j0 + kk * 16 + 2 * cq;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          const bf16* v0 = svt + (dt * 8 + g) * vs + jk;
          if (!(MIVP_B1_SKIP & 64) && !(MIVP_B6_SKIP & 16))
            mma16816(o[dt], pa, lds32(v0), lds32(v0 + 8));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  if (ml != nullptr) {
    ml[0][0] = mrow[0];
    ml[0][1] = lrow[0];
    ml[1][0] = mrow[1];
    ml[1][1] = lrow[1];
  }
  const float inv[2] = {1.f / lrow[0], 1.f / lrow[1]};
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    o[dt][0] *= inv[0];
    o[dt][1] *= inv[0];
    o[dt][2] *= inv[1];
    o[dt][3] *= inv[1];
  }
}

// attend_tile for the block kernels: Q rows from shared memory (stride
// qs, like K), kKeyChunk keys per step, one body for every step.
template <int DHK, bool DROP, class Bias>
__device__ __forceinline__ void attend_rows(
    float (&o)[DHK / 8][4], const bf16* sq, const bf16* sk, int qs,
    const bf16* svt, int vs, const int* slab, bool masked,
    const Bias& bias, int t0, int m, int n, int npad, float scale,
    const AttnDrop& dr, int lane, float (*ml)[2] = nullptr) {
  const int g = lane / 4, cq = lane % 4;
  uint32_t qa[DHK / 16][4];
#pragma unroll
  for (int ks = 0; ks < DHK / 16; ++ks) {
    const bf16* q0 = sq + (t0 + g) * qs + ks * 16 + 2 * cq;
    qa[ks][0] = lds32(q0);
    qa[ks][1] = lds32(q0 + 8 * qs);
    qa[ks][2] = lds32(q0 + 8);
    qa[ks][3] = lds32(q0 + 8 * qs + 8);
  }
  attend_tile<DHK, kKeyChunk, false, DROP>(o, qa, sk, qs, svt, vs, slab,
                                           masked, bias, t0, m, n, npad,
                                           scale, dr, lane, ml);
}

// Operands of one fused-block call: B1's arguments, and each half of B5's.
struct BlockArgs {
  const void* x;        // [BP, M, C], fp32 or bf16 (f32)
  void* out;            // [BP, M, C], x's dtype
  const bf16* wqkv;     // [H, 3, DHK, C]: Wq|Wk|Wv of head h, transposed,
                        // k-packed (warp_gemm_acc)
  const bf16* ext_kv;   // [H, 2, E, DHK]: extra K rows, then extra V rows
  const float* pe_tab;  // [H, tabw]: each head's FactoredBias table
  const int* pe_coord;  // [M] packed window coordinates of the rows
  const int* labels;    // [P, N] shift-region labels, or null
  const float* ln1_s;
  const float* ln1_b;
  const bf16* wproj;    // [C, C] (out, in), k-packed
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* wmlp;     // [C, C] (out, in), k-packed
  const float* bmlp;
  int m, c, heads, n_ext, p_windows;
  int ph, pw, pd;       // window dims of the per-axis bias tables
  int tabw;             // ph^2 + pw^2 + pd^2 + E (+ M with a fold column)
  bool fold;            // key column M is the pad-fold column
  float scale, pe_scale;
  DropArgs drop;
  bool f32;             // x and out are fp32 (else bf16)
  int ks;               // CTAs per window (the cluster size)
};

__host__ __device__ inline int bias_table_floats(int ph, int pw, int pd,
                                                 int m, int e, bool fold) {
  return ph * ph + pw * pw + pd * pd + e + (fold ? m : 0);
}

// Rows of each CTA's row phase (proj, LN2, MLP) when a window is split
// over ks CTAs: the window's rows in blocks of 16-row tiles.
__host__ __device__ inline int row_block(int m, int ks) {
  return ks == 1 ? m : pad16((m + ks - 1) / ks);
}

// Shared-memory layout of one CTA, in bytes.  The head phase holds LN1(x)
// of every row (y), the head's Q, K and V^T tiles, the key labels, the
// bias tables of the CTA's heads and the rows' window coordinates; the
// row phase reuses that space for x1 (fp32) of the CTA's rows.  `ra`
// (after both) receives the attention output of the CTA's rows from
// every CTA of the cluster, then holds LN2(x1).  Row-major; strides: bf16
// rows of C + 8, Q/K rows of dhk + 8, V^T rows of npad + 8, x1 rows of
// C + 4 floats (fragment loads free of bank conflicts).  mp = rows
// rounded up to the warps' 32.
struct BlockSmem {
  int npad, mp, cs, qks, vts, xs, rb;
  size_t y, q, k, vt, lab, tab, coord, x1, ra, total;
  __host__ __device__ BlockSmem(int m, int c, int n, int dhk, int threads,
                                int ks, int tab_floats) {
    npad = pad16(n);
    mp = threads;
    cs = c + 8;
    qks = dhk + 8;
    vts = npad + 8;
    xs = c + 4;
    rb = row_block(m, ks);
    y = 0;
    q = align16(y + (size_t)mp * cs * 2);
    k = align16(q + (size_t)mp * qks * 2);
    vt = align16(k + (size_t)npad * qks * 2);
    lab = align16(vt + (size_t)dhk * vts * 2);
    tab = align16(lab + (size_t)npad * 4);
    coord = align16(tab + (size_t)tab_floats * 4);
    const size_t head_end = align16(coord + (size_t)m * 4);
    x1 = 0;
    const size_t x1_end = align16((size_t)rb * xs * 4);
    ra = head_end > x1_end ? head_end : x1_end;
    total = ra + align16((size_t)((rb + 31) / 32 * 32) * cs * 2);
  }
};

__host__ __device__ inline BlockSmem block_smem(const BlockArgs& a, int dhk,
                                                int ks) {
  return BlockSmem(a.m, a.c, a.m + a.n_ext, dhk, (a.m + 31) / 32 * 32, ks,
                   (a.heads / ks) * a.tabw);
}

// ---- thread block clusters (sm_90) ----
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The two halves of a cluster barrier without memory ordering: after the
// wait, every CTA of the cluster has started (its shared memory may be
// written).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// All threads of every CTA of the cluster: the CTA's earlier writes
// (shared memory of any CTA of the cluster, and device memory) are
// visible to every thread of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 32 bits into the shared memory of CTA `rank` of the cluster, at the
// offset that `local` has in this CTA's.
__device__ __forceinline__ void st_cluster32(const void* local, uint32_t rank,
                                             uint32_t v) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(local), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(remote), "r"(v)
               : "memory");
}

// One whole Swin block on one window, by a cluster of a.ks CTAs of
// blockDim.x = M rounded up to 32 threads each: the body of B1
// (fused_block.cu) and of each half of B5 (fused_pair.cu).
//
//   Head phase.  Every CTA takes LN1 of all M rows (thread per row), then
//   runs q|k|v (one GEMM per head, N = 3 DHK) and attention for its H/ks
//   heads on all rows (each warp owns 32 rows).  Each attention output
//   goes straight to the shared memory (`ra`) of the CTA that owns its
//   row: CTA r owns rows [r rb, (r + 1) rb).  One cluster barrier.
//   Row phase.  Each CTA runs proj, residual, LN2 (warp per row), MLP and
//   residual on its own rows; its warps split the rows in 32-row groups
//   and each group's columns between them.
//
// Every output element takes the arithmetic of the one-CTA form (same
// per-head softmax, same K order in every product), so the output does
// not depend on ks.
//   xw, ow  the window's M input rows and where its output rows go, in
//           the activation dtype (ow may be xw: a row is read and then
//           written by the CTA that owns it, and every CTA's LN1 reads
//           happen before the cluster barrier);
//   rows    PERM: row t of the block reads and writes row rows[t] of xw
//           and ow (M ints in shared memory: B5's in-window token roll);
//           else row t itself;
//   win     the window's index in the call (the dropout counters add
//           a.drop.win_base to it);
//   lab     the window's [N] key labels, or null (no mask);
//   smem    BlockSmem's regions.
// DROP: the dropout code is compiled in only for calls with a nonzero rate.
// F32: xw and ow are fp32 (else bf16; a.f32 chose the instance).
template <int DH, bool DROP, bool PERM, bool F32>
__device__ __forceinline__ void swin_block_window(
    const BlockArgs& a, const void* xw, void* ow, const int* rows,
    uint32_t win, const int* lab, unsigned char* smem) {
  constexpr int DHK = pad16(DH);
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's P.V
  const int M = a.m, C = a.c, E = a.n_ext, N = a.m + a.n_ext;
  const int KS = a.ks, HK = a.heads / KS;
  const BlockSmem L = block_smem(a, DHK, KS);
  const int CS = L.cs, QS = L.qks, VS = L.vts, XS = L.xs, NPAD = L.npad;
  const int RB = L.rb;
  bf16* sy = reinterpret_cast<bf16*>(smem + L.y);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* svt = reinterpret_cast<bf16*>(smem + L.vt);
  int* slab = reinterpret_cast<int*>(smem + L.lab);
  float* stab = reinterpret_cast<float*>(smem + L.tab);
  int* scoord = reinterpret_cast<int*>(smem + L.coord);
  float* sx1 = reinterpret_cast<float*>(smem + L.x1);
  bf16* sra = reinterpret_cast<bf16*>(smem + L.ra);

  const int i = threadIdx.x;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const int nwarps = blockDim.x / 32;
  const int r0 = warp * 32;                       // the warp's first row
  const int dgap = a.drop.drop_cols - N;          // JAX alignment columns
  const int mtiles = r0 + 16 < M ? 2 : 1;         // its 16-row tiles
  const int rank = KS > 1 ? (int)cluster_rank() : 0;
  const int h0 = rank * HK;                       // the CTA's first head
  if (KS > 1) cluster_arrive_relaxed();   // waited for before the first push

  // ---- LN1, a thread per row -> y (bf16, row-major) ----
  // bf16 rows are first copied into y with coalesced 16-byte loads and
  // normalised there in place; fp32 rows are read from device memory.
  // Either way the statistics sum the row's pairs in order.
  typedef typename std::conditional<F32, float, bf16>::type T;
  const T* xt = static_cast<const T*>(xw);
  T* ot = static_cast<T*>(ow);
  if (!F32 && !(MIVP_B1_SKIP & 8)) {
    const int chunks = C / 8;
    for (int t = i; t < M * chunks; t += blockDim.x) {
      const int r = t / chunks, c8 = (t - r * chunks) * 8;
      *reinterpret_cast<uint4*>(sy + r * CS + c8) =
          *reinterpret_cast<const uint4*>(xt + (size_t)(PERM ? rows[r] : r) * C + c8);
    }
    __syncthreads();
  }
  if (i < M && !(MIVP_B1_SKIP & 8)) {
    const T* xr = F32 ? xt + (size_t)(PERM ? rows[i] : i) * C
                      : reinterpret_cast<const T*>(sy + i * CS);
    float sum = 0.f, sq2 = 0.f;
    for (int c = 0; c < C; c += 8) {
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = ld2(xr, c + 2 * k);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sum += v[k].x + v[k].y;
        sq2 += v[k].x * v[k].x + v[k].y * v[k].y;
      }
    }
    const float mu = sum / C;
    const float rstd = rsqrtf(sq2 / C - mu * mu + kEps);
    for (int c = 0; c < C; c += 8) {
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = ld2(xr, c + 2 * k);
      uint32_t packed[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = c + 2 * k;
        packed[k] = pack2(
            (v[k].x - mu) * rstd * __ldg(a.ln1_s + cc) + __ldg(a.ln1_b + cc),
            (v[k].y - mu) * rstd * __ldg(a.ln1_s + cc + 1) + __ldg(a.ln1_b + cc + 1));
      }
      *reinterpret_cast<uint4*>(sy + i * CS + c) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  } else if (i >= M) {
    for (int c = 0; c < C; ++c) sy[i * CS + c] = zero;   // unused tile rows
  }
  // Key rows past N are zero in K and V^T for every head.
  for (int t = N + i; t < NPAD; t += blockDim.x) {
    for (int d = 0; d < DHK; ++d) {
      sk[t * QS + d] = zero;
      svt[d * VS + t] = zero;
    }
  }
  const bool masked = lab != nullptr;
  if (masked)
    for (int t = i; t < N; t += blockDim.x) slab[t] = __ldg(lab + t);
  // The bias tables of the CTA's heads and the rows' coordinates.
  for (int t = i; t < HK * a.tabw; t += blockDim.x)
    stab[t] = __ldg(a.pe_tab + (size_t)h0 * a.tabw + t);
  for (int t = i; t < M; t += blockDim.x) scoord[t] = __ldg(a.pe_coord + t);
  const int oc = a.ph * a.ph, od = oc + a.pw * a.pw, oe = od + a.pd * a.pd;

  float acc[2][kNT][4];
  for (int hl = 0; hl < HK; ++hl) {
    const int h = h0 + hl;
    __syncthreads();  // y, labels, tables written; previous head's K/V read
    // ---- q|k|v of the warp's rows for head h: one GEMM, N = 3 DHK ----
    const bf16* wh = a.wqkv + (size_t)h * 3 * DHK * C;
#pragma unroll 1
    for (int n0 = 0; n0 < (MIVP_B1_SKIP & 2 ? 0 : 3 * DHK); n0 += 8 * kNT) {
      const int ntiles = min(kNT, (3 * DHK - n0) / 8);
      warp_gemm<true>(acc, sy, CS, r0, mtiles, wh, C, n0, ntiles, C, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = n0 + nt * 8;
          const int which = col / DHK;            // 0 q, 1 k, 2 v
          const int d = col - which * DHK + 2 * cq;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + mt * 16 + g + hf * 8;
            const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
            if (mt >= mtiles || nt >= ntiles) continue;
            if (which == 0) {          // Q (rows past M hold zeros)
              *reinterpret_cast<uint32_t*>(sq + r * QS + d) = pack2(v0, v1);
            } else if (r < M) {
              if (which == 1) {
                *reinterpret_cast<uint32_t*>(sk + r * QS + d) = pack2(v0, v1);
              } else {
                svt[d * VS + r] = __float2bfloat16_rn(v0);
                svt[(d + 1) * VS + r] = __float2bfloat16_rn(v1);
              }
            }
          }
        }
      }
    }
    // Extra K/V rows (fold row, prompt tokens) of head h.
    const bf16* ek = a.ext_kv + (size_t)h * 2 * E * DHK;
    const bf16* ev = ek + (size_t)E * DHK;
    for (int t = i; t < E * (DHK / 8); t += blockDim.x) {
      const int r = t / (DHK / 8), d0 = (t % (DHK / 8)) * 8;
      *reinterpret_cast<uint4*>(sk + (M + r) * QS + d0) =
          __ldg(reinterpret_cast<const uint4*>(ek + (size_t)r * DHK + d0));
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(ev + (size_t)r * DHK + d0));
      const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) svt[(d0 + t8) * VS + M + r] = hv[t8];
    }
    __syncthreads();

    // ---- attention of the warp's row tiles (tensor cores) ----
    if (KS > 1 && hl == 0) cluster_wait();   // every peer has started
    const FactoredBias bias{stab + hl * a.tabw, scoord, M, a.ph, a.pw, a.pd,
                            oc, od, oe, oe + E, a.fold, a.pe_scale};
#pragma unroll 1
    for (int mt = 0; mt < (MIVP_B1_SKIP & 1 ? 0 : mtiles); ++mt) {
      const int t0 = r0 + mt * 16;
      const int ra = t0 + g, rb = t0 + g + 8;
      // Dropout counter bases of the two rows (uint32 arithmetic wraps
      // exactly as the JAX kernel's).
      const AttnDrop dr{
          a.drop.seed_a, a.drop.thr_a, a.drop.keep_a,
          (((win + a.drop.win_base) * a.heads + h) * M + ra) *
              (uint32_t)a.drop.drop_cols,
          (((win + a.drop.win_base) * a.heads + h) * M + rb) *
              (uint32_t)a.drop.drop_cols,
          M, dgap};
      float o[DTILES][4];
      attend_rows<DHK, DROP>(o, sq, sk, QS, svt, VS, slab, masked, bias, t0,
                             M, N, NPAD, a.scale, dr, lane);
      // Each row's output columns of head h to the CTA that owns the row.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = hf ? rb : ra;
        if (r >= M) continue;
        const int owner = KS > 1 ? r / RB : 0;
        bf16* dst = sra + (r - owner * RB) * CS + h * DH + 2 * cq;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          if (dt * 8 + 2 * cq < DH) {   // DH is even: d < DH => d + 1 < DH
            const uint32_t v = pack2(o[dt][2 * hf], o[dt][2 * hf + 1]);
            if (KS > 1) st_cluster32(dst + dt * 8, owner, v);
            else *reinterpret_cast<uint32_t*>(dst + dt * 8) = v;
          }
        }
      }
    }
  }
  // Every CTA's attention rows have landed in their owners' `ra`; y, Q, K,
  // V, the labels and the tables are dead from here on.
  if (KS > 1) cluster_sync();
  else __syncthreads();

  // ---- row phase: the CTA's rows [rbase, rbase + nrows) ----
  const int rbase = rank * RB;
  const int nrows = max(0, min(M - rbase, RB));
  const int groups = (nrows + 31) / 32;           // 32-row groups
  const int wpg = groups ? nwarps / groups : 1;   // warps per group
  const int grp = warp / wpg, sub = warp % wpg;
  const bool active = grp < groups;
  const int g0 = grp * 32;                        // the group's first row
  const int gtiles = g0 + 16 < nrows ? 2 : 1;
  const int ct0 = sub * (C / 8) / wpg,
            ct1 = MIVP_B1_SKIP & 4 ? ct0 : (sub + 1) * (C / 8) / wpg;
  const bool split = wpg > 1;                     // groups share columns

  // ---- x1 = x + a Wproj^T + bproj -> sx1 (fp32) ----
  for (int n0 = ct0 * 8; active && n0 < ct1 * 8; n0 += 8 * kNT) {
    const int ntiles = min(kNT, ct1 - n0 / 8);
    warp_gemm<true>(acc, sra, CS, g0, gtiles, a.wproj, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int lr = g0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < gtiles && nt < ntiles && lr < nrows) {
            const int r = rbase + lr;
            const float2 xv = ld2(xt, (size_t)(PERM ? rows[r] : r) * C + col);
            float p0 = acc[mt][nt][2 * hf] + __ldg(a.bproj + col);
            float p1 = acc[mt][nt][2 * hf + 1] + __ldg(a.bproj + col + 1);
            if (DROP && a.drop.thr_p) {   // projection dropout
              const uint32_t base = ((win + a.drop.win_base) * M + r) * C + col;
              p0 *= keep_value(a.drop.seed_p, base, a.drop.thr_p, a.drop.keep_p);
              p1 *= keep_value(a.drop.seed_p, base + 1, a.drop.thr_p, a.drop.keep_p);
            }
            sx1[lr * XS + col] = xv.x + p0;
            sx1[lr * XS + col + 1] = xv.y + p1;
          }
        }
  }
  if (split) __syncthreads();
  else __syncwarp();
  // ---- LN2 -> ra (bf16), a warp per row: the group's own rows, or all
  // of the CTA's rows in turn when groups share columns ----
  for (int lr = split ? warp : g0, end = split ? nrows : min(g0 + 32, nrows);
       lr < end; lr += split ? nwarps : 1) {
    float sum = 0.f, sq2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = sx1[lr * XS + c];
      sum += v;
      sq2 += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq2 += __shfl_xor_sync(0xffffffffu, sq2, off);
    }
    const float mu = sum / C;
    const float rstd = rsqrtf(sq2 / C - mu * mu + kEps);
    for (int c = lane; c < C; c += 32)
      sra[lr * CS + c] = __float2bfloat16_rn(
          (sx1[lr * XS + c] - mu) * rstd * __ldg(a.ln2_s + c) + __ldg(a.ln2_b + c));
  }
  if (split) __syncthreads();
  else __syncwarp();
  // ---- out = x1 + LN2(x1) Wmlp^T + bmlp ----
  for (int n0 = ct0 * 8; active && n0 < ct1 * 8; n0 += 8 * kNT) {
    const int ntiles = min(kNT, ct1 - n0 / 8);
    warp_gemm<true>(acc, sra, CS, g0, gtiles, a.wmlp, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int lr = g0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < gtiles && nt < ntiles && lr < nrows) {
            const int r = rbase + lr;
            st2(ot, (size_t)(PERM ? rows[r] : r) * C + col,
                sx1[lr * XS + col] + (acc[mt][nt][2 * hf] + __ldg(a.bmlp + col)),
                sx1[lr * XS + col + 1] + (acc[mt][nt][2 * hf + 1] + __ldg(a.bmlp + col + 1)));
          }
        }
  }
}

// ---- host side: the cluster size and the launch ----

constexpr size_t kMaxSmem = 227 * 1024;

// CTAs of `kernel` that fit on one SM at this launch shape (the
// occupancy calculator, remembered per shape) and the card's SMs.
template <class Kernel>
int resident_ctas(Kernel kernel, int threads, size_t bytes) {
  struct Shape {
    const void* kernel;
    int threads;
    size_t bytes;
    int ctas;
  };
  static std::mutex lock;
  static Shape seen[256];
  static int n_seen = 0;
  std::lock_guard<std::mutex> hold(lock);
  for (int t = 0; t < n_seen; ++t)
    if (seen[t].kernel == (const void*)kernel && seen[t].threads == threads &&
        seen[t].bytes == bytes)
      return seen[t].ctas;
  int ctas = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                    bytes) != cudaSuccess)
    return 0;
  if (n_seen < 256) seen[n_seen++] = {(const void*)kernel, threads, bytes, ctas};
  return ctas;
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The cluster size of a launch of bp windows, and its shared bytes per
// CTA (`extra` more than the block body's: B5's row map); 0 if no size
// fits a CTA's shared memory.  Of the sizes a window may take (1, 2, 4
// or 8 CTAs, dividing the heads, 16 rows or more each), the fewest CTAs
// per window that reach the most resident CTAs per SM (smaller per-CTA
// tiles can raise it), then more while the grid is less than one wave.
template <class Kernel>
int cluster_size(Kernel kernel, const BlockArgs& a, int bp, int dhk,
                 size_t extra, size_t* bytes) {
  const int threads = (a.m + 31) / 32 * 32;
  int sizes[4], occ[4], n = 0, pick = -1;
  size_t need[4];
  for (int ks = 1; ks <= 8; ks *= 2) {
    if (ks > 1 && (a.heads % ks != 0 || a.m < 16 * ks)) break;
    const size_t total = block_smem(a, dhk, ks).total + extra;
    if (total > kMaxSmem) continue;
    sizes[n] = ks;
    need[n] = total;
    occ[n] = resident_ctas(kernel, threads, total);
    if (occ[n] < 1) continue;
    if (pick < 0 || occ[n] > occ[pick]) pick = n;
    ++n;
  }
  if (pick < 0) return 0;
  while (pick + 1 < n && (long)bp * sizes[pick] < (long)sm_count() * occ[pick])
    ++pick;
  for (int t = 0; MIVP_B1_KS && t < n; ++t)
    if (sizes[t] == MIVP_B1_KS) pick = t;
  *bytes = need[pick];
  return sizes[pick];
}

// Launch (info null) `kernel` over bp windows of ks CTAs each, or write
// info[0..6] = cluster size, CTAs, threads per CTA, CTAs per SM,
// registers, local (spill) bytes per thread and shared bytes per CTA.
template <class Kernel, class Args>
cudaError_t launch_clustered(Kernel kernel, const Args& args, int bp, int ks,
                             int threads, size_t bytes, cudaStream_t stream,
                             int* info) {
  cudaError_t err;
  if (info != nullptr) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    const int v[7] = {ks, bp * ks, threads,
                      resident_ctas(kernel, threads, bytes), fa.numRegs,
                      (int)fa.localSizeBytes, (int)bytes};
    for (int t = 0; t < 7; ++t) info[t] = v[t];
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bp * ks));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
