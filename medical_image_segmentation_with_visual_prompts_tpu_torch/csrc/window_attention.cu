// Window attention of the unfused Swin block path, for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/
// window_attention_pallas.py):
//
//   _packed_qkv_kernel (B6)  q = y[:M] Wq, k = y Wk, v = y Wv from the LN1
//                            output y, rounded to bf16; s = (q.k) * scale
//   _packed_kernel (B7),     q/k/v already projected; q = bf16(q * scale),
//   _attention_kernel (B8)   s = q.k  ([.., M, H, Dh] is [.., M, C] in
//                            memory, so the two are one kernel)
//
// and then, for every head,
//
//   s = (s + bias[h, i, j]) * (lab_i == lab_j || lab_j < 0)
//   out[w, i, h*Dh : (h+1)*Dh] = softmax(s) v     fp32 softmax, P as bf16
//
// over the M content queries and the N = M + prompt keys of each window.
// The TPU kernels packed heads block-diagonally to fill the MXU's
// contraction width; here each head's width is padded to the bf16 k-step
// (16) instead, as in the fused block kernel (fused_block.cu).
//
// What bounds it on the H100: at the flagship shapes (M 256, N 320, head
// dim 12-48) the tensor-core work is a few MFLOP per (window, head); the
// time is the softmax's per-score work (the bias, the mask, an
// exponential for every key: the multiplicative mask leaves none out) and
// the latency of its dependent steps.  Design:
//
// * One CTA of 8 warps per (window, head), the grid window-major; each
//   warp owns 32-row groups of the queries.  At head dims up to 16 the
//   registers are held to 80, so three CTAs share an SM.  (A cluster of
//   a window's head CTAs staging y once per window, and B7/B8's rows of a
//   head split over two to four CTAs, both measured slower on the H100.)
// * The attention of a 16-row tile is attend_tile of
//   fused_block_common.cuh, B1's softmax body; where N is a whole number
//   of 64-key softmax steps each step is compiled as straight-line code
//   for its kind of keys and mask, without bounds checks: the compiler
//   then overlaps the key tiles' loads, products and bias arithmetic.
// * The bias is built in shared memory from its factors (WindowBias: the
//   per-axis tables and prompt columns of the head, each row's window
//   coordinate; FactoredBias's values bit for bit, for whole windows of
//   depth 2, 4 or 8, with each row's depth terms in registers), or read
//   as the [H, M, N] array from device memory (GlobalBias), as the
//   caller passes it.
// * B6 stages the window's y rows with cp.async.  Where the caller
//   passes the prompt rows apart, as one [E, C] tensor that every window
//   shares (the unfused block's LN1 of the prompt tokens), their K/V are
//   projected once per call (prompt_kv_kernel, [H, 2, E, DHK]) and each
//   CTA stages and projects only the M content rows.  The projections
//   load 4 k-steps of weights ahead of their products; q is staged with
//   k and v at head dims up to 16, else kept in registers per tile.
// * Every product keeps its operands and k order, and the softmax its
//   order, so the output does not depend on the bias's form or on where
//   the prompt rows' K/V were projected.
//
// y, q, k, v and the output are fp32 or bf16 (one run-time flag, the
// inputs' dtype, which the output takes as the JAX kernels' out_shape
// does); they are rounded to bf16 where the JAX kernels round them: y, k
// and v on the load, q after the fp32 scale.

// Design probes (tools/torch_ab_b1.py --kernel b6 --probe): a nonzero
// MIVP_B6_SKIP compiles parts out (1: the bias, 2: the staging of y or
// q/k/v, 4: the projections, 8: the attention, 16: P.V; its default is
// in fused_block_common.cuh); MIVP_B6_MINB and MIVP_B6_CHUNK set the
// register bound and the softmax step.  A probe's output is garbage and
// only its time is read; the port's own builds define none.
#ifndef MIVP_B6_MINB
#define MIVP_B6_MINB 3   // CTAs per SM the registers are held to (head
#endif                   // dims <= 16; 2 above)
#ifndef MIVP_B6_CHUNK
#define MIVP_B6_CHUNK 64   // keys per online-softmax step
#endif

#include "fused_block_common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // 8 warps

// The additive attention bias of one head as [m, n] fp32 rows in device
// memory (the dense form): bias[i, j] = rows[i * n + j].
struct GlobalBias {
  const float* rows;
  int n;
  typedef const float* Row;
  __device__ __forceinline__ Row row(int i, int) const {
    return rows + (size_t)i * n;
  }
  __device__ __forceinline__ int col(int) const { return 0; }
  // Keys below it take pair<1>.
  __device__ __forceinline__ int split() const { return n; }
  // bias[i, j] and bias[i, j + 1] (j even) where they are keys (< n);
  // KIND 1: both are.
  template <int KIND>
  __device__ __forceinline__ void pair(Row r, int, int j, float& b0,
                                       float& b1) const {
    if (MIVP_B6_SKIP & 1) {
      b0 = b1 = 0.f;
    } else if (KIND == 1) {
      b0 = __ldg(r + j);
      b1 = __ldg(r + j + 1);
    } else {
      b0 = j < n ? __ldg(r + j) : 0.f;
      b1 = j + 1 < n ? __ldg(r + j + 1) : 0.f;
    }
  }
};

// The bias of a full (ph, pw, pd) window built from its factors in shared
// memory (the factor form): FactoredBias's values and arithmetic, bit for
// bit, for content rows that are the whole window in order (row i at
// coordinate coord[i]) and a depth pd of 2, 4 or 8.  Keys j, j + 1 (j
// even) then share R + Cw, and the lane's depth columns (2 cq) % pd and
// + 1 are the same for every key pair it holds, so each row keeps its two
// D values in registers:
//
//   j <  m:  ((R[ih_i, ih_j] + Cw[iw_i, iw_j]) + D[id_i, id_j]) / 3 * s
//   j >= m:  ext[j - m]                  (prompt-token columns)
//
// tab: the head's [ph*ph | pw*pw | pd*pd | E] table (FactoredBias's).
struct WindowBias {
  const float* tab;
  const int* coord;
  int m, ph, pw, pd, oc, od, oe;
  float scale;
  struct Row {
    int r, c;
    float d0, d1;
  };
  __device__ __forceinline__ Row row(int i, int lane) const {
    const int ci = coord[i];
    const int d = od + ((ci >> 16) & 255) * pd + (2 * (lane % 4)) % pd;
    return {(ci & 255) * ph, oc + ((ci >> 8) & 255) * pw, tab[d], tab[d + 1]};
  }
  __device__ __forceinline__ int col(int j) const {
    return j < m ? coord[j] : 0;
  }
  __device__ __forceinline__ float scaled(float t) const {
    return __fmul_rn(__fmul_rn(t, kThird), scale);
  }
  // Keys below it are content keys (pair<1>), keys from it prompt keys
  // (pair<2>).
  __device__ __forceinline__ int split() const { return m; }
  // bias[i, j] and bias[i, j + 1] for j even, cj = col(j); values past
  // the keys are garbage (reads stay inside the CTA's table region).
  // KIND 1: content keys, 2: prompt keys, 0: either.
  template <int KIND>
  __device__ __forceinline__ void pair(const Row& r, int cj, int j, float& b0,
                                       float& b1) const {
    if (MIVP_B6_SKIP & 1) {
      b0 = b1 = 0.f;
    } else if (KIND == 1 || (KIND == 0 && j < m)) {
      const float rc = __fadd_rn(tab[r.r + (cj & 255)],
                                 tab[r.c + ((cj >> 8) & 255)]);
      b0 = scaled(__fadd_rn(rc, r.d0));
      b1 = scaled(__fadd_rn(rc, r.d1));
    } else {
      b0 = tab[oe + j - m];
      b1 = tab[oe + j + 1 - m];
    }
  }
};

// The C entry's `mode`: B7/B8, B6, or B6 with the prompt rows apart and
// their K/V projected once per call.
enum Mode { kAttend = 0, kProject = 1, kProjectHoisted = 2 };

struct AttnArgs {
  const void* y;        // B6: LN1 output, [BP, N, C] (hoisted: [BP, M, C])
  const void* y_prompt; // hoisted B6: [E, C], the prompt rows of every
                        // window's y
  const bf16* wqkv;     // B6: [H, 3, DHK, C] Wq|Wk|Wv of head h, transposed
  bf16* prompt_kv;      // hoisted B6: [H, 2, E, DHK], the K then V rows of
                        // y_prompt (prompt_kv_kernel)
  const void* q;        // B7/B8: [BP, M, C]
  const void* k;        // B7/B8: [BP, N, C]
  const void* v;        // B7/B8: [BP, N, C]
  const float* bias;    // dense form: [H, M, N]
  const float* pe_tab;  // factor form: [H, tabw] (WindowBias tables)
  const int* pe_coord;  // factor form: [M] packed window coordinates
  const int* labels;    // [P, N] shift-region labels, or null
  void* out;            // [BP, M, C]
  int m, n, c, heads, p_windows;
  int ph, pw, pd, tabw;
  float scale, pe_scale;
  bool hoisted;         // B6 reads the prompt rows' K/V from prompt_kv
  bool f32;             // y, q, k, v and out are fp32 (else bf16)
};

// Rows of y a B6 CTA stages (the content rows, and the prompt rows unless
// hoisted), rounded up to the warps' 32.
__host__ __device__ inline int y_rows(int m, int n, bool proj, bool hoisted) {
  return proj ? ((hoisted ? m : n) + 31) / 32 * 32 : 0;
}

// Rows of Q a CTA stages: B6 at head dims up to 16 projects q with k and
// v (its attention then holds the registers of B7/B8's), wider heads keep
// each tile's q in registers.
__host__ __device__ inline int q_rows(int m, int dhk, bool proj) {
  return proj && dhk == 16 ? (m + 31) / 32 * 32 : 0;
}

// Shared-memory layout, in bytes: y (B6 only; zero past its rows), Q (B6
// at head dims up to 16), K [npad][dhk + 8], V^T [dhk][npad + 8] (bf16),
// the key labels [npad] (int32), and for the factor form the head's bias
// table [tabw + 16] (fp32; 16 floats of slack: keys up to npad are read)
// and the rows' coordinates [m] (int32).  Row strides are padded by 8
// elements so the fragment loads are free of bank conflicts.  Per CTA at
// the flagship shapes (M 256, N 320, 64 prompt rows hoisted, tabw 208):
//   B6, C 48, dh 12:  y 28,672 + Q 12,288 + K 15,360 + V^T 10,496
//                     + labels 1,280 + table 896 + coordinates 1,024
//                     = 70,016 B (three CTAs per SM)
//   B6, C 96, dh 12:  y 53,248 + the same = 94,592 B (two)
//   B6, C 96, dh 24:  y 53,248 + K 25,600 + V^T 20,992 + 3,200
//                     = 103,040 B (two)
//   B8, C 192, dh 12: 15,360 + 10,496 + 3,200 = 29,056 B (three)
//   B8, C 192, dh 48: K 35,840 + V^T 31,488 + 3,200 = 70,528 B (two)
// (ops/window_attention.py::attention_smem mirrors it.)
struct Smem {
  int npad, cs, qks, vts;
  size_t y, q, k, vt, lab, tab, coord, total;
  __host__ __device__ Smem(int m, int n, int c, int dhk, int yrows, int qrows,
                           int tabw, bool fact) {
    npad = pad16(n);
    cs = c + 8;
    qks = dhk + 8;
    vts = npad + 8;
    y = 0;
    q = align16((size_t)yrows * cs * 2);
    k = align16(q + (size_t)qrows * qks * 2);
    vt = align16(k + (size_t)npad * qks * 2);
    lab = align16(vt + (size_t)dhk * vts * 2);
    tab = align16(lab + (size_t)npad * 4);
    coord = align16(tab + (fact ? (size_t)(tabw + 16) * 4 : 0));
    total = align16(coord + (fact ? (size_t)m * 4 : 0));
  }
};

// 8 activations from element i (a multiple of 8) as bf16.
__device__ __forceinline__ uint4 ld_bf16x8(const void* p, size_t i, bool f32) {
  if (!f32)
    return __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i));
  const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const float4 lo = __ldg(src), hi = __ldg(src + 1);
  return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                    pack2(hi.z, hi.w));
}

// 16 bytes global -> shared without registers; complete after
// cp_async_wait_all (and a barrier for the other threads).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// acc[mt][nt] = A[r0 + 16 mt .. +16, 0..K) @ Bt[8 nt .. +8, 0..K)^T for
// the warp's MT row tiles and NT column tiles (A in shared memory, rows
// of stride lda; Bt [8 NT][K] in device memory): warp_gemm's products in
// its order, with the B fragments of 4 k-steps loaded before their
// products, so the loads' latency is paid once per 4 k-steps.
template <int MT, int NT>
__device__ __forceinline__ void proj_gemm(float (&acc)[MT][NT][4],
                                          const bf16* A, int lda, int r0,
                                          const bf16* Bt, int K, int lane) {
  const int g = lane / 4, cq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    uint32_t b[4][NT][2];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (k0 + 16 * s < K) {
          const bf16* row = Bt + (size_t)(nt * 8 + g) * K + k0 + 16 * s;
          b[s][nt][0] = ldg32(row + 2 * cq);
          b[s][nt][1] = ldg32(row + 2 * cq + 8);
        }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k0 + 16 * s < K) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* a0 = A + (r0 + mt * 16 + g) * lda + k0 + 16 * s + 2 * cq;
          af[mt][0] = lds32(a0);
          af[mt][1] = lds32(a0 + 8 * lda);
          af[mt][2] = lds32(a0 + 8);
          af[mt][3] = lds32(a0 + 8 * lda + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma16816(acc[mt][nt], af[mt], b[s][nt][0], b[s][nt][1]);
      }
    }
  }
}

// The K and V rows of the E = N - M prompt rows y_prompt, for every head:
// one CTA per head, a warp per 32 rows, the main kernel's warp GEMM and
// rounding.
template <int DH>
__global__ void __launch_bounds__(kMaxThreads)
    prompt_kv_kernel(const AttnArgs a) {
  constexpr int DHK = pad16(DH);
  constexpr int DTILES = DHK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sy = reinterpret_cast<bf16*>(smem);
  const int C = a.c, E = a.n - a.m, CS = C + 8;
  const int erows = (E + 31) / 32 * 32;
  const int i = threadIdx.x, warp = i / 32, lane = i % 32;
  const int g = lane / 4, cq = lane % 4, h = blockIdx.x;
  for (int t = i; t < erows * (C / 8); t += blockDim.x) {
    const int r = t / (C / 8), c0 = (t % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(sy + r * CS + c0) =
        r < E ? ld_bf16x8(a.y_prompt, (size_t)r * C + c0, a.f32)
              : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const bf16* wh = a.wqkv + (size_t)h * 3 * DHK * C;
  bf16* dst = a.prompt_kv + (size_t)h * 2 * E * DHK;
  float acc[2][DTILES][4];
  for (int r0 = warp * 32; r0 < erows; r0 += blockDim.x) {
#pragma unroll 1
    for (int which = 1; which < 3; ++which) {
      proj_gemm(acc, sy, CS, r0, wh + (size_t)which * DHK * C, C, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < DTILES; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + mt * 16 + g + hf * 8, d = nt * 8 + 2 * cq;
            if (r < E)
              *reinterpret_cast<uint32_t*>(
                  dst + ((size_t)(which - 1) * E + r) * DHK + d) =
                  pack2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
          }
    }
  }
}

// PROJ: the B6 prologue (q/k/v projected in the kernel) or B7/B8 (q/k/v
// read from device memory, scale folded into q).  FACT: the bias built
// from its factors (else read as [H, M, N]).
template <int DH, bool PROJ, bool FACT>
__global__ void __launch_bounds__(kMaxThreads,
                                  pad16(DH) == 16 ? MIVP_B6_MINB : 2)
    window_attention_kernel(const AttnArgs a) {
  constexpr int DHK = pad16(DH);
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's q/k/v and P.V
  constexpr int KSTEPS = DHK / 16;   // k-steps of QK^T
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.m, N = a.n, C = a.c, H = a.heads;
  const bool hoisted = PROJ && a.hoisted;
  constexpr bool QS = PROJ && DHK == 16;   // q staged with k and v
  const int yrows = y_rows(M, N, PROJ, hoisted);
  const Smem L(M, N, C, DHK, yrows, q_rows(M, DHK, PROJ), a.tabw, FACT);
  bf16* sy = reinterpret_cast<bf16*>(smem + L.y);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* svt = reinterpret_cast<bf16*>(smem + L.vt);
  int* slab = reinterpret_cast<int*>(smem + L.lab);
  float* stab = reinterpret_cast<float*>(smem + L.tab);
  int* scoord = reinterpret_cast<int*>(smem + L.coord);

  const int i = threadIdx.x, nthreads = blockDim.x;
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const int h = blockIdx.x % H;
  const size_t win = blockIdx.x / H;
  const bool f32 = a.f32;
  const bf16 zero = __float2bfloat16_rn(0.f);

  if (MIVP_B6_SKIP & 2) {
  } else if (PROJ) {
    // The window's y rows [0, yreal) -> shared memory (16-byte loads);
    // rows [yreal, yrows) are zero.
    const int yreal = hoisted ? M : N;
    const int c8 = C / 8;
    const size_t yw = win * yreal * C;
    const int chunks = yreal * c8;
    if (!f32) {
      const bf16* yb = static_cast<const bf16*>(a.y) + yw;
      for (int t = i; t < chunks; t += nthreads) {
        const int r = t / c8, c0 = (t % c8) * 8;
        cp_async16(sy + r * L.cs + c0, yb + (size_t)r * C + c0);
      }
    } else {
      // 4 loads in flight per thread, then their stores.
      for (int t0 = i; t0 < chunks; t0 += 4 * nthreads) {
        uint4 u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + k * nthreads;
          if (t < chunks)
            u[k] = ld_bf16x8(a.y, yw + (size_t)(t / c8) * C + (t % c8) * 8,
                             f32);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + k * nthreads;
          if (t < chunks)
            *reinterpret_cast<uint4*>(sy + (t / c8) * L.cs + (t % c8) * 8) =
                u[k];
        }
      }
    }
    for (int t = i; t < (yrows - yreal) * c8; t += nthreads) {
      const int r = yreal + t / c8, c0 = (t % c8) * 8;
      *reinterpret_cast<uint4*>(sy + r * L.cs + c0) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (hoisted) {
      // The prompt rows' K/V of head h, key rows past N zero.
      const int E = N - M;
      const bf16* ek = a.prompt_kv + (size_t)h * 2 * E * DHK;
      const bf16* ev = ek + (size_t)E * DHK;
      for (int t = i; t < E * (DHK / 8); t += nthreads) {
        const int r = t / (DHK / 8), d0 = (t % (DHK / 8)) * 8;
        cp_async16(sk + (M + r) * L.qks + d0, ek + (size_t)r * DHK + d0);
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(ev + (size_t)r * DHK + d0));
        const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8) svt[(d0 + t8) * L.vts + M + r] = hv[t8];
      }
      for (int t = N + i; t < L.npad; t += nthreads)
        for (int d = 0; d < DHK; ++d) {
          sk[t * L.qks + d] = zero;
          svt[d * L.vts + t] = zero;
        }
    }
  } else {
    // Head h's columns of k and v^T; columns DH..DHK and rows past N
    // zero.
    // 4 pairs in flight per thread, then their stores.
    const size_t kw = win * N * C + h * DH;
    const int pairs = L.npad * (DHK / 2);
    for (int t0 = i; t0 < pairs; t0 += 4 * nthreads) {
      uint32_t ku[4], vu[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * nthreads;
        const int r = t / (DHK / 2), d = (t % (DHK / 2)) * 2;
        ku[u] = vu[u] = 0u;
        if (t < pairs && r < N && d < DH && !f32) {
          ku[u] = ldg32(static_cast<const bf16*>(a.k) + kw + (size_t)r * C + d);
          vu[u] = ldg32(static_cast<const bf16*>(a.v) + kw + (size_t)r * C + d);
        } else if (t < pairs && r < N && d < DH) {
          const float2 kf = ld_act2(a.k, kw + (size_t)r * C + d, true);
          const float2 vf = ld_act2(a.v, kw + (size_t)r * C + d, true);
          ku[u] = pack2(kf.x, kf.y);
          vu[u] = pack2(vf.x, vf.y);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * nthreads;
        if (t >= pairs) continue;
        const int r = t / (DHK / 2), d = (t % (DHK / 2)) * 2;
        *reinterpret_cast<uint32_t*>(sk + r * L.qks + d) = ku[u];
        const bf16* hv = reinterpret_cast<const bf16*>(&vu[u]);
        svt[d * L.vts + r] = hv[0];
        svt[(d + 1) * L.vts + r] = hv[1];
      }
    }
  }
  const bool masked = a.labels != nullptr;
  if (masked) {
    const int* lab = a.labels + (size_t)(win % a.p_windows) * N;
    for (int t = i; t < N; t += nthreads) slab[t] = __ldg(lab + t);
  }
  if (FACT) {
    for (int t = i; t < a.tabw; t += nthreads)
      stab[t] = __ldg(a.pe_tab + (size_t)h * a.tabw + t);
    for (int t = i; t < M; t += nthreads) scoord[t] = __ldg(a.pe_coord + t);
  }
  cp_async_wait_all();
  __syncthreads();

  const bf16* wh = a.wqkv + (size_t)h * 3 * DHK * C;
  if (PROJ) {
    // ---- (q and) k and v of head h (tensor cores), 32 rows per warp
    // pass: the content rows, and the prompt rows unless hoisted ----
    const int kv_end = hoisted ? M : L.npad;   // rows stored
    float acc[2][DTILES][4];
    for (int r0 = warp * 32; r0 < (MIVP_B6_SKIP & 4 ? 0 : yrows);
         r0 += nthreads) {
#pragma unroll 1
      for (int which = QS ? 0 : 1; which < 3; ++which) {
        if (which == 0 && r0 >= M) continue;     // q of content rows only
        proj_gemm(acc, sy, L.cs, r0, wh + (size_t)which * DHK * C, C, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < DTILES; ++nt) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = r0 + mt * 16 + g + hf * 8;
              const int d = nt * 8 + 2 * cq;
              const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
              if (which == 0) {   // rows of the last tile past M: unread
                *reinterpret_cast<uint32_t*>(sq + r * L.qks + d) = pack2(v0, v1);
              } else if (r < kv_end) {   // rows past N: from zero y rows
                if (which == 1) {
                  *reinterpret_cast<uint32_t*>(sk + r * L.qks + d) = pack2(v0, v1);
                } else {
                  svt[d * L.vts + r] = __float2bfloat16_rn(v0);
                  svt[(d + 1) * L.vts + r] = __float2bfloat16_rn(v1);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- attention of the warp's query tiles (tensor cores) ----
  const float scale = PROJ ? a.scale : 1.f;   // B7/B8: folded into q
  const size_t qw = win * M * C + h * DH;     // q and out of head h
  const int oc = a.ph * a.ph, od = oc + a.pw * a.pw, oe = od + a.pd * a.pd;
  typedef typename std::conditional<FACT, WindowBias, GlobalBias>::type Bias;
  Bias bias;
  if constexpr (FACT)
    bias = WindowBias{stab, scoord, M, a.ph, a.pw, a.pd, oc, od, oe,
                      a.pe_scale};
  else
    bias = GlobalBias{a.bias + (size_t)h * M * N, N};

  // Tile t0's q as A fragments: staged q (B6 at head dims up to 16), the
  // projection's accumulators (the accumulators of n-tiles 2 ks and 2 ks
  // + 1 are k-step ks's A layout), or head h's columns of q times scale,
  // rounded to bf16 (zero past M and DH).
  auto load_q = [&](uint32_t (&qa)[KSTEPS][4], int t0) {
    if constexpr (QS) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const bf16* q0 = sq + (t0 + g) * L.qks + ks * 16 + 2 * cq;
        qa[ks][0] = lds32(q0);
        qa[ks][1] = lds32(q0 + 8 * L.qks);
        qa[ks][2] = lds32(q0 + 8);
        qa[ks][3] = lds32(q0 + 8 * L.qks + 8);
      }
    } else if constexpr (PROJ) {
      float acc[1][DTILES][4] = {};
      if (!(MIVP_B6_SKIP & 4)) proj_gemm(acc, sy, L.cs, t0, wh, C, lane);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        qa[ks][0] = pack2(acc[0][2 * ks][0], acc[0][2 * ks][1]);
        qa[ks][1] = pack2(acc[0][2 * ks][2], acc[0][2 * ks][3]);
        qa[ks][2] = pack2(acc[0][2 * ks + 1][0], acc[0][2 * ks + 1][1]);
        qa[ks][3] = pack2(acc[0][2 * ks + 1][2], acc[0][2 * ks + 1][3]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = t0 + g + (e & 1) * 8;
          const int d = ks * 16 + 2 * cq + (e & 2) * 4;
          uint32_t val = 0u;
          if (r < M && d < DH && !(MIVP_B6_SKIP & 2)) {
            const float2 f = ld_act2(a.q, qw + (size_t)r * C + d, f32);
            val = pack2(f.x * a.scale, f.y * a.scale);
          }
          qa[ks][e] = val;
        }
    }
  };
  // Tile t0's output rows (< M), head h's columns.
  auto store = [&](const float (&o)[DTILES][4], int t0) {
    const int ra = t0 + g, rb = t0 + g + 8;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + 2 * cq;   // DH is even: d < DH => d + 1 < DH
      if (d < DH) {
        if (ra < M)
          st_act2(a.out, qw + (size_t)ra * C + d, f32, o[dt][0], o[dt][1]);
        if (rb < M)
          st_act2(a.out, qw + (size_t)rb * C + d, f32, o[dt][2], o[dt][3]);
      }
    }
  };
  // Every key tile holds keys (N = npad) and every softmax step is whole.
  const bool full = N == L.npad && L.npad % MIVP_B6_CHUNK == 0;
  for (int r0 = warp * 32; r0 < M; r0 += nthreads) {
    const int mtiles = r0 + 16 < M ? 2 : 1;
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      const int t0 = r0 + mt * 16;
      uint32_t qa[KSTEPS][4];
      load_q(qa, t0);
      float o[DTILES][4] = {};
      if (MIVP_B6_SKIP & 8) {
      } else if (full) {
        attend_tile<DHK, MIVP_B6_CHUNK, true, false>(
            o, qa, sk, L.qks, svt, L.vts, slab, masked, bias, t0, M, N,
            L.npad, scale, AttnDrop{}, lane);
      } else {
        attend_tile<DHK, MIVP_B6_CHUNK, false, false>(
            o, qa, sk, L.qks, svt, L.vts, slab, masked, bias, t0, M, N,
            L.npad, scale, AttnDrop{}, lane);
      }
      store(o, t0);
    }
  }
}

template <int DH, bool PROJ, bool FACT>
cudaError_t launch_as(const AttnArgs& a, int bp, int threads, int* info,
                      cudaStream_t stream) {
  const Smem L(a.m, a.n, a.c, pad16(DH), y_rows(a.m, a.n, PROJ, a.hoisted),
               q_rows(a.m, pad16(DH), PROJ), a.tabw, FACT);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = window_attention_kernel<DH, PROJ, FACT>;
  // Also sets the kernel's shared-memory limit (once per shape).
  if (resident_ctas(kernel, threads, L.total) < 1) return cudaErrorInvalidValue;
  if (info == nullptr && PROJ && a.hoisted) {
    const int erows = (a.n - a.m + 31) / 32 * 32;
    const size_t bytes = (size_t)erows * (a.c + 8) * 2;
    cudaError_t err = cudaFuncSetAttribute(
        prompt_kv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    prompt_kv_kernel<DH><<<a.heads, min(kMaxThreads, erows), bytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_clustered(kernel, a, bp * a.heads, 1, threads, L.total,
                          stream, info);
}

template <int DH>
cudaError_t launch(const AttnArgs& a, bool proj, int bp, int threads,
                   int* info, cudaStream_t s) {
  const bool fact = a.tabw > 0;
  if (proj)
    return fact ? launch_as<DH, true, true>(a, bp, threads, info, s)
                : launch_as<DH, true, false>(a, bp, threads, info, s);
  return fact ? launch_as<DH, false, true>(a, bp, threads, info, s)
              : launch_as<DH, false, false>(a, bp, threads, info, s);
}

}  // namespace

// mode 0: B7/B8 on q, k, v ([bp, m, c], [bp, n, c], [bp, n, c]).  mode 1:
// B6 on y ([bp, n, c], its LN1 output, the first m rows of each window
// the queries) and wqkv, its per-head weights.  mode 2: B6 on the content
// rows y ([bp, m, c]) and the prompt rows y_prompt ([n - m, c]) that
// follow them in every window: their K/V are projected once into
// prompt_kv ([heads, 2, n - m, pad16(c / heads)] bf16 scratch).  The
// bias: the factor form when tabw > 0 (pe_tab [heads, tabw], pe_coord
// [m]; window dims ph, pw, pd), else bias [heads, m, n].  One CTA per
// (window, head).  out: [bp, m, c]; y, y_prompt, q, k, v and out fp32
// when act_f32, else bf16.  With info non-null nothing runs (the pointers
// are not read) and info[0..6] receives the launch's shape
// (launch_clustered).
extern "C" cudaError_t mivp_window_attention(
    const void* y, const void* y_prompt, const void* wqkv, void* prompt_kv,
    const void* q, const void* k, const void* v, const void* bias,
    const void* pe_tab, const void* pe_coord, const void* labels, void* out,
    int* info, int bp, int m, int n, int c, int heads, int p_windows,
    int mode, int ph, int pw, int pd, int tabw, float scale, float pe_scale,
    int act_f32, void* stream) {
  const bool proj = mode != kAttend, hoisted = mode == kProjectHoisted;
  if (bp < 1 || m < 1 || n < 1 || heads < 1 || c % heads != 0 || mode < 0 ||
      mode > 2 || (proj && (m > n || c % 16 != 0)) || (hoisted && n == m) ||
      (labels != nullptr && (p_windows < 1 || bp % p_windows != 0)) ||
      (tabw > 0 && (ph < 1 || pw < 1 || ph > 255 || pw > 255 ||
                    (pd != 2 && pd != 4 && pd != 8) || m != ph * pw * pd ||
                    tabw < ph * ph + pw * pw + pd * pd + n - m)))
    return cudaErrorInvalidValue;
  if (info == nullptr &&
      (out == nullptr ||
       (proj && (y == nullptr || wqkv == nullptr ||
                 (hoisted && (y_prompt == nullptr || prompt_kv == nullptr)))) ||
       (!proj && (q == nullptr || k == nullptr || v == nullptr)) ||
       (tabw > 0 ? (pe_tab == nullptr || pe_coord == nullptr)
                 : bias == nullptr)))
    return cudaErrorInvalidValue;
  AttnArgs a;
  a.y = y;
  a.y_prompt = y_prompt;
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.prompt_kv = static_cast<bf16*>(prompt_kv);
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.pe_tab = static_cast<const float*>(pe_tab);
  a.pe_coord = static_cast<const int*>(pe_coord);
  a.labels = static_cast<const int*>(labels);
  a.out = out;
  a.hoisted = hoisted;
  a.f32 = act_f32 != 0;
  a.m = m;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.p_windows = p_windows;
  a.ph = ph;
  a.pw = pw;
  a.pd = pd;
  a.tabw = tabw;
  a.scale = scale;
  a.pe_scale = pe_scale;
  const int threads = min(kMaxThreads, (m + 31) / 32 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c / heads) {
    case 8: return launch<8>(a, proj, bp, threads, info, s);
    case 12: return launch<12>(a, proj, bp, threads, info, s);
    case 16: return launch<16>(a, proj, bp, threads, info, s);
    case 24: return launch<24>(a, proj, bp, threads, info, s);
    case 32: return launch<32>(a, proj, bp, threads, info, s);
    case 48: return launch<48>(a, proj, bp, threads, info, s);
    case 64: return launch<64>(a, proj, bp, threads, info, s);
    default: return cudaErrorInvalidValue;
  }
}
