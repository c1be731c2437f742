// Device functions shared by the fused Swin block forward
// (fused_block.cu), the block pair (fused_pair.cu), the block backward
// (fused_block_bwd.cu) and the window attention kernels
// (window_attention.cu): bf16 packing, the m16n8k16 tensor-core product
// and the warp GEMMs built on it, the shared-memory row padding, the
// counter-based dropout hash (the murmur3 finalizer of ops/prng.py, bit
// for bit), one head's attention of a 16-row tile (label-equality mask,
// online fp32 softmax), and one whole Swin block on one window
// (swin_block_window: B1's body, run once by B1 and twice by B5).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// Attention dropout of one 16-row tile (B1's training path): the seed,
// threshold and keep scale, the counter bases of the lane's rows a and b,
// and the fold geometry of drop_col (m, gap).
struct AttnDrop {
  uint32_t seed, thr;
  float keep;
  uint32_t row_a, row_b;
  int m, gap;
};

// Attention of one head for the 16 query rows t0..t0+15 of a warp, on
// tensor cores.  Each lane quad holds rows a = t0 + g and b = t0 + g + 8:
//
//   s = (q.k * scale + bias[i, j]) * (lab_i == lab_j || lab_j < 0)
//   o = softmax(s) v        fp32, max-subtracted, online over 64-key
//                           chunks; P fed to P.V as bf16
//
// Shared memory: Q rows (stride qs) and K rows [npad][qs] of DHK bf16
// (the head dim zero-padded to the k-step), V^T [DHK][vs]; key rows n..npad
// of K and V^T are zero.  bias: the head's [m, n] fp32 rows in device
// memory; slab: the window's key labels (read only when `masked`).  On
// return o[dt] holds the normalised output of row a (o[dt][0..1]) and row b
// (o[dt][2..3]) at head columns dt * 8 + 2 * (lane % 4) + {0, 1}.
template <int DHK, bool DROP>
__device__ __forceinline__ void attend_tile(
    float (&o)[DHK / 8][4], const bf16* sq, const bf16* sk, int qs,
    const bf16* svt, int vs, const int* slab, bool masked,
    const float* bias, int t0, int m, int n, int npad, float scale,
    const AttnDrop& dr, int lane) {
  constexpr int KSTEPS = DHK / 16;   // k-steps of QK^T
  constexpr int DTILES = DHK / 8;    // n-tiles of P.V
  const int g = lane / 4, cq = lane % 4;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const bf16* q0 = sq + (t0 + g) * qs + ks * 16 + 2 * cq;
    qa[ks][0] = lds32(q0);
    qa[ks][1] = lds32(q0 + 8 * qs);
    qa[ks][2] = lds32(q0 + 8);
    qa[ks][3] = lds32(q0 + 8 * qs + 8);
  }
  const int ra = t0 + g, rb = t0 + g + 8;
  const bool va = ra < m, vb = rb < m;
  const int lab_a = (masked && va) ? slab[ra] : 0;
  const int lab_b = (masked && vb) ? slab[rb] : 0;
  const float* bias_a = bias + (size_t)(va ? ra : 0) * n;
  const float* bias_b = bias + (size_t)(vb ? rb : 0) * n;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

#pragma unroll 1
  for (int j0 = 0; j0 < npad; j0 += kKeyChunk) {
    const int ntiles = min(kKeyChunk, npad - j0) / 8;  // even
    float s[kKeyChunk / 8][4];
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
      if (nt < ntiles) {
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* k0 = sk + (j0 + nt * 8 + g) * qs + 2 * cq;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          mma16816(sc, qa[ks], lds32(k0 + ks * 16), lds32(k0 + ks * 16 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + 2 * cq + (e & 1);
          if (j < n) {
            const bool top = e < 2;
            float v = sc[e] * scale + __ldg((top ? bias_a : bias_b) + j);
            if (masked) {
              const int lj = slab[j];
              if (!(lj == (top ? lab_a : lab_b) || lj < 0)) v = 0.f;
            }
            s[nt][e] = v;
          }
        }
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
    const float corr_a = __expf(m_a - new_a), corr_b = __expf(m_b - new_b);
    m_a = new_a;
    m_b = new_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      o[dt][0] *= corr_a;
      o[dt][1] *= corr_a;
      o[dt][2] *= corr_b;
      o[dt][3] *= corr_b;
    }
#pragma unroll
    for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
      if (2 * kk < ntiles) {
        float p[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          p[u][0] = __expf(s[2 * kk + u][0] - new_a);
          p[u][1] = __expf(s[2 * kk + u][1] - new_a);
          p[u][2] = __expf(s[2 * kk + u][2] - new_b);
          p[u][3] = __expf(s[2 * kk + u][3] - new_b);
          l_a += p[u][0] + p[u][1];
          l_b += p[u][2] + p[u][3];
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
          mma16816(o[dt], pa, lds32(v0), lds32(v0 + 8));
        }
      }
    }
  }
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    o[dt][0] *= inv_a;
    o[dt][1] *= inv_a;
    o[dt][2] *= inv_b;
    o[dt][3] *= inv_b;
  }
}

// Operands of one fused-block call: B1's arguments, and each half of B5's.
struct BlockArgs {
  const void* x;        // [BP, M, C], fp32 or bf16 (f32)
  void* out;            // [BP, M, C], x's dtype
  const bf16* wqkv;     // [H, 3, DHK, C]: Wq|Wk|Wv of head h, transposed
  const bf16* ext_kv;   // [H, 2, E, DHK]: extra K rows, then extra V rows
  const float* bias;    // [H, M, N], N = M + E
  const int* labels;    // [P, N] shift-region labels, or null
  const float* ln1_s;
  const float* ln1_b;
  const bf16* wproj;    // [C, C] (out, in)
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* wmlp;     // [C, C] (out, in)
  const float* bmlp;
  int m, c, heads, n_ext, p_windows;
  float scale;
  DropArgs drop;
  bool f32;             // x and out are fp32 (else bf16)
  unsigned char* scratch;  // B1 windows too large for shared memory:
                           // x1 and region 2 per window (BlockSmem)
};

// Shared-memory layout, in bytes.  Region 1 holds LN1(x), the head's Q,
// K and V^T tiles and the key labels during the projections and
// attention, and x1 (fp32) afterwards; region 2 holds the attention
// output, then LN2(x1).  All row-major over the CTA's rows (mp = rows
// rounded up to the warps' 32).  Strides: bf16 rows of C + 8, Q/K rows of
// dhk + 8, V^T rows of npad + 8, x1 rows of C + 4 floats.  With `spill`
// (windows whose layout exceeds a CTA's shared memory, such as M 256 at C
// 192) x1 and region 2 live in a device scratch of `spill_bytes` per
// window instead (x1 at 0, region 2 at `a`), and shared memory holds
// region 1's attention part only.
struct BlockSmem {
  int npad, mp, cs, qks, vts, xs;
  size_t y, q, k, vt, lab, x1, a, total, spill_bytes;
  __host__ __device__ BlockSmem(int m, int c, int n, int dhk, int threads,
                                bool spill = false) {
    npad = pad16(n);
    mp = threads;
    cs = c + 8;
    qks = dhk + 8;
    vts = npad + 8;
    xs = c + 4;
    y = 0;
    q = align16(y + (size_t)mp * cs * 2);
    k = align16(q + (size_t)mp * qks * 2);
    vt = align16(k + (size_t)npad * qks * 2);
    lab = align16(vt + (size_t)dhk * vts * 2);
    size_t attn_end = align16(lab + (size_t)npad * 4);
    x1 = 0;
    size_t x1_end = align16((size_t)mp * xs * 4);
    if (spill) {
      a = x1_end;
      spill_bytes = a + align16((size_t)mp * cs * 2);
      total = attn_end;
    } else {
      a = attn_end > x1_end ? attn_end : x1_end;
      total = a + align16((size_t)mp * cs * 2);
      spill_bytes = 0;
    }
  }
};

// One whole Swin block on one window, by a CTA of blockDim.x = M rounded
// up to 32 threads (each warp owns 32 rows): the body of B1
// (fused_block.cu) and of each half of B5 (fused_pair.cu).
//   xw, ow  the window's M input rows and where its output rows go, in
//           the activation dtype a.f32 (ow may be xw: every row is read
//           and then written by its own warp);
//   rows    PERM: row t of the block reads and writes row rows[t] of xw
//           and ow (M ints in shared memory: B5's in-window token roll);
//           else row t itself;
//   win     the window index of the dropout counters;
//   lab     the window's [N] key labels, or null (no mask);
//   smem    BlockSmem's regions.
// DROP: the dropout code is compiled in only for calls with a nonzero rate.
// SPILL: x1 and region 2 in a.scratch, at window `win`'s slot (B1 only).
// F32: xw and ow are fp32 (else bf16; a.f32 chose the instance).
template <int DH, bool DROP, bool PERM, bool SPILL, bool F32>
__device__ __forceinline__ void swin_block_window(
    const BlockArgs& a, const void* xw, void* ow, const int* rows,
    uint32_t win, const int* lab, unsigned char* smem) {
  constexpr int DHK = pad16(DH);
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's q/k/v and P.V
  const int M = a.m, C = a.c, E = a.n_ext, N = a.m + a.n_ext;
  const BlockSmem L(M, C, N, DHK, blockDim.x, SPILL);
  const int CS = L.cs, QS = L.qks, VS = L.vts, XS = L.xs, NPAD = L.npad;
  unsigned char* big = SPILL ? a.scratch + (size_t)win * L.spill_bytes
                             : smem;
  bf16* sy = reinterpret_cast<bf16*>(smem + L.y);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* svt = reinterpret_cast<bf16*>(smem + L.vt);
  int* slab = reinterpret_cast<int*>(smem + L.lab);
  float* sx1 = reinterpret_cast<float*>(big + L.x1);
  bf16* sa = reinterpret_cast<bf16*>(big + L.a);

  const int i = threadIdx.x;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const int r0 = warp * 32;                       // the warp's first row
  const int dgap = a.drop.drop_cols - N;          // JAX alignment columns
  const int mtiles = r0 + 16 < M ? 2 : 1;         // its 16-row tiles

  // ---- LN1 of the thread's row -> y (bf16, row-major) ----
  typedef typename std::conditional<F32, float, bf16>::type T;
  const T* xt = static_cast<const T*>(xw);
  T* ot = static_cast<T*>(ow);
  if (i < M) {
    const T* xr = xt + (size_t)(PERM ? rows[i] : i) * C;
    float sum = 0.f, sq2 = 0.f;
    for (int c = 0; c < C; c += 2) {
      const float2 v = ld2(xr, c);
      sum += v.x + v.y;
      sq2 += v.x * v.x + v.y * v.y;
    }
    const float mu = sum / C;
    const float rstd = rsqrtf(sq2 / C - mu * mu + kEps);
    for (int c = 0; c < C; c += 2) {
      const float2 v = ld2(xr, c);
      *reinterpret_cast<uint32_t*>(sy + i * CS + c) = pack2(
          (v.x - mu) * rstd * __ldg(a.ln1_s + c) + __ldg(a.ln1_b + c),
          (v.y - mu) * rstd * __ldg(a.ln1_s + c + 1) + __ldg(a.ln1_b + c + 1));
    }
  } else {
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

  float acc[2][kNT][4];
  for (int h = 0; h < a.heads; ++h) {
    __syncthreads();  // y, labels, pads written; previous head's K/V read
    // ---- q/k/v of the warp's rows for head h (tensor cores) ----
    const bf16* wh = a.wqkv + (size_t)h * 3 * DHK * C;
#pragma unroll 1
    for (int which = 0; which < 3; ++which) {
      warp_gemm(acc, sy, CS, r0, mtiles, wh + (size_t)which * DHK * C, C, 0,
                DTILES, C, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < DTILES; ++nt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + mt * 16 + g + hf * 8;
            const int d = nt * 8 + 2 * cq;
            const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
            if (mt >= mtiles) continue;
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
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      const int t0 = r0 + mt * 16;
      const int ra = t0 + g, rb = t0 + g + 8;
      // Dropout counter bases of the two rows (uint32 arithmetic wraps
      // exactly as the JAX kernel's).
      const AttnDrop dr{
          a.drop.seed_a, a.drop.thr_a, a.drop.keep_a,
          (((uint32_t)win * a.heads + h) * M + ra) * (uint32_t)a.drop.drop_cols,
          (((uint32_t)win * a.heads + h) * M + rb) * (uint32_t)a.drop.drop_cols,
          M, dgap};
      float o[DTILES][4];
      attend_tile<DHK, DROP>(o, sq, sk, QS, svt, VS, slab, masked,
                             a.bias + (size_t)h * M * N, t0, M, N, NPAD,
                             a.scale, dr, lane);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const int d = dt * 8 + 2 * cq;   // DH is even: d < DH => d + 1 < DH
        if (d < DH) {
          *reinterpret_cast<uint32_t*>(sa + ra * CS + h * DH + d) =
              pack2(o[dt][0], o[dt][1]);
          *reinterpret_cast<uint32_t*>(sa + rb * CS + h * DH + d) =
              pack2(o[dt][2], o[dt][3]);
        }
      }
    }
  }
  __syncthreads();  // region 1 (y, q, k, v) is dead from here on

  // ---- x1 = x + a Wproj^T + bproj -> region 1 (fp32) ----
  for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
    const int ntiles = min(kNT, (C - n0) / 8);
    warp_gemm(acc, sa, CS, r0, mtiles, a.wproj, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < mtiles && nt < ntiles && r < M) {
            const float2 xv = ld2(xt, (size_t)(PERM ? rows[r] : r) * C + col);
            float p0 = acc[mt][nt][2 * hf] + __ldg(a.bproj + col);
            float p1 = acc[mt][nt][2 * hf + 1] + __ldg(a.bproj + col + 1);
            if (DROP && a.drop.thr_p) {   // projection dropout
              const uint32_t base = ((uint32_t)win * M + r) * C + col;
              p0 *= keep_value(a.drop.seed_p, base, a.drop.thr_p, a.drop.keep_p);
              p1 *= keep_value(a.drop.seed_p, base + 1, a.drop.thr_p, a.drop.keep_p);
            }
            sx1[r * XS + col] = xv.x + p0;
            sx1[r * XS + col + 1] = xv.y + p1;
          }
        }
  }
  __syncwarp();
  // ---- LN2 of the warp's rows -> region 2 (bf16), one row at a time ----
  for (int rr = 0; rr < 32; ++rr) {
    const int r = r0 + rr;
    if (r >= M) break;
    float sum = 0.f, sq2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = sx1[r * XS + c];
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
      sa[r * CS + c] = __float2bfloat16_rn(
          (sx1[r * XS + c] - mu) * rstd * __ldg(a.ln2_s + c) + __ldg(a.ln2_b + c));
  }
  __syncwarp();
  // ---- out = x1 + LN2(x1) Wmlp^T + bmlp ----
  for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
    const int ntiles = min(kNT, (C - n0) / 8);
    warp_gemm(acc, sa, CS, r0, mtiles, a.wmlp, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < mtiles && nt < ntiles && r < M)
            st2(ot, (size_t)(PERM ? rows[r] : r) * C + col,
                sx1[r * XS + col] + (acc[mt][nt][2 * hf] + __ldg(a.bmlp + col)),
                sx1[r * XS + col + 1] + (acc[mt][nt][2 * hf + 1] + __ldg(a.bmlp + col + 1)));
        }
  }
}

}  // namespace
