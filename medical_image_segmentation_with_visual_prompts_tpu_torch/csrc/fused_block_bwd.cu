// Fused Swin transformer block BACKWARD for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/fused_block_bwd.py,
// launched by `block_backward`).  For each window it recomputes the
// forward of csrc/fused_block.cu (same LN1, the same q|k|v GEMM and
// attention code, the same dropout masks) and chains the gradients
//
//   mlp -> LN2 -> proj (dropout) -> P.V -> softmax
//   (dS = P o (dP - rowsum(dO o O)), dropout mask inside dP)
//   -> multiplicative label mask -> scores -> q/k/v -> LN1 -> residuals
//
// x and dout are fp32 or bf16 (one run-time flag, as the forward's x);
// dx is written in their dtype.  Matmul operands are rounded to bf16 (dout
// too); LN statistics, softmax and the residual gradients stay fp32.
//
// Outputs: dx (per window) and fp32 gradients of every operand: the five
// weights in (in, out) layout, the six LayerNorm/bias vectors, the
// assembled bias [H, M, N] and the [E, C] extra K and V rows.  The wrapper
// (ops/fused_block_bwd.py) maps the row and bias gradients back to the
// prompt tokens and the positional-bias parameters by autograd.
//
// What bounds it on the H100: the matrix products are small (3x the
// forward's, 0.05 ms per training step at the bf16 peak); what costs is
// the attention's elementwise work (exp, the dropout hash, the bias
// build, three times per (row, key) pair), keeping the SMs busy when a
// training batch has 8 windows, and the cross-window sums: the TPU grid
// ran windows in order and carried the weight gradients in VMEM; here
// windows run in parallel.  Design:
//
// * A window runs on a thread block cluster of ks = hs x qs CTAs of 256
//   or 512 threads (the launch plan, ops/fused_block_bwd.py::
//   backward_plan): hs head groups of H / hs heads, each head group split
//   over qs CTAs (qs > 1 where the heads alone cannot fill the card, e.g.
//   4 heads at 8 windows).  In the attention phases a CTA takes its heads' query
//   rows (qs splits them) and key tiles (qs splits them too); in the row
//   phases (proj, LN2, MLP and their gradients, LN1's gradient) it takes
//   its block of rows.  The attention output, its gradient (dO) and the
//   softmax statistics move to the CTAs that need them through
//   distributed shared memory; so do dQ, dK and dV, to the owner of each
//   row, which sums the heads by one GEMM over K = 3C (dY = [dQ dK dV]
//   [Wq Wk Wv]^T): the head sum in a fixed order.
// * dV = P^T dO and dK = dS^T Q run key-major (a warp owns 16 keys and
//   walks every query row, the sums in registers); dQ = dS K runs
//   query-major.  No sum depends on which warp gets there first.
// * Cross-window sums: each window writes its dWq, dWk, dWv (every
//   column by the CTA that owns its head), its bias gradient and its
//   extra-row gradients, and each CTA its dWproj, dWmlp and vector sums
//   over its rows, as fp32 partials in a workspace; a second kernel
//   (bwd_reduce_kernel) sums them in window order.  There is no atomic,
//   and two runs on the same inputs give the same bits.
// * Row-reducing products (dW = A^T B over rows, dV, dK) read their
//   operands from shared memory with ldmatrix.trans.
// * The bias is built in shared memory from its factors (FactoredBias,
//   as B1 does); the [H, M, N] array is never read.
// * Windows too large for that layout at any cluster size (M 256 at C
//   192: the 16x16x2 stages under the reference padding) take the
//   device-memory form (`big`): LN1(x) of every row (y) and the gathered
//   [dQ dK dV] rows (dqkv) live in a workspace in device memory (each
//   CTA its own y, each window one dqkv written by plain stores and read
//   after the cluster barrier); the rest of the layout and every sum's
//   order are the same.
// All products run on tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 sums); the weights are read k-packed from device memory with the
// next k-steps' fragments in flight (rows_gemm).

#include "fused_block_common.cuh"

// Design probes (tools/torch_ab_b1.py --kernel b4 --probe): a nonzero
// MIVP_B4_SKIP compiles parts out (1: the bias gradient's partials, 2:
// the weight-gradient products, 4: the key-major pass (dV, dK), 8: the
// recompute of the attention forward, 16: the reduction kernel, 32: LN1,
// 64: the row phase, 128: the query-major pass (dQ, dS), 256: phase F).
// A probe's output is garbage and only its time is read; the port's own
// builds do not define it.
#ifndef MIVP_B4_SKIP
#define MIVP_B4_SKIP 0
#endif

namespace {


struct BwdArgs {
  const void* x;          // [BP, M, C], fp32 or bf16 (f32)
  const void* dout;       // [BP, M, C], x's dtype
  void* dx;               // [BP, M, C], x's dtype
  const bf16* wqkv;       // [H, 3, DHK, C] (out, in), k-packed (B1's)
  const bf16* ext_kv;     // [H, 2, E, DHK]: extra K rows, then extra V rows
  const float* pe_tab;    // [H, tabw]: each head's FactoredBias table
  const int* pe_coord;    // [M] packed window coordinates of the rows
  const int* labels;      // [P, N] shift-region labels, or null
  const float* ln1_s;
  const float* ln1_b;
  const bf16* wproj;      // [C, C] (out, in), k-packed
  const bf16* wproj_io;   // [C, C] (in, out), k-packed
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* wmlp;       // [C, C] (out, in), k-packed
  const bf16* wmlp_io;    // [C, C] (in, out), k-packed
  const float* bmlp;
  const bf16* wqkv_io;    // [C, 3C]: Wq | Wk | Wv (in, out), k-packed
  float* part_w;          // [BP, PW] per-window partials (bwd_part_w)
  float* part_c;          // [BP * ks, PC] per-CTA partials (bwd_part_c)
  float* out;             // [PW + PC]: their sums
  bf16* yg;               // big: [BP * ks, MP, C + 8] LN1(x) per CTA
  bf16* dqkvg;            // big: [BP, MP, 3C + 8] [dQ dK dV] per window
  int m, c, heads, n_ext, p_windows;
  int ph, pw, pd, tabw;   // the bias factors (FactoredBias)
  bool fold;
  float scale, pe_scale;
  DropArgs drop;
  bool f32;               // x, dout and dx are fp32 (else bf16)
  int ks, hs, qs;         // CTAs per window = head groups x query splits
  bool big;               // y and dqkv in device memory (yg, dqkvg)
};

// Per-window partial: dWq, dWk, dWv [3][C][C], dext [2][E][C], dbias
// [H][M][NB] (NB: N rounded up to even), padded to 4 floats (8-byte
// stores stay aligned).  Per-CTA partial: dWproj, dWmlp [2][C][C], then
// dbproj, dbmlp, dln1s, dln1b, dln2s, dln2b [6][C].  The output is both,
// summed.
__host__ __device__ inline int bias_stride(int n) { return (n + 1) / 2 * 2; }

__host__ __device__ inline size_t bwd_part_w(int m, int c, int h, int e) {
  return ((size_t)3 * c * c + (size_t)2 * e * c +
          (size_t)h * m * bias_stride(m + e) + 3) / 4 * 4;
}

__host__ __device__ inline size_t bwd_part_c(int c) {
  return (size_t)2 * c * c + (size_t)6 * c;
}

// Shared-memory layout of one CTA, in bytes (ops/fused_block_bwd.py::
// backward_smem mirrors it).  Kept for the whole kernel: the key labels,
// the bias tables of the CTA's heads, the rows' coordinates, LN1 and LN2
// statistics, per (head, row) the softmax max and 1 / sum, D = rowsum(dO
// o O) and the row's label (qr, one 16-byte load), per row its offsets
// into the bias tables (rc), dO of the CTA's heads for every row (da),
// the attention output (ao) and d(x1) (g) of the CTA's rows, and LN1(x)
// of every row (y, last).  A
// union (u) holds in turn: the attention recompute (Q, K, V^T), the row
// phase (x1 fp32, LN2(x1), dout, dproj), the attention backward (Q, K,
// V, dQ) beside the rows' gathered [dQ dK dV] (dqkv), and d(LN1 out)
// (dy, at x1).  Row-major; strides: head tiles DHK + 8, activations
// C + 8 (bf16) or C + 4 (fp32), dqkv 3C + 8.  In the device-memory form
// (big) neither y nor dqkv is in shared memory.
struct BwdSmem {
  int npad, mp, r16, ds, cs, xs, qks;
  size_t lab, tab, coord, st1, st2, qr, rc, da, ao, g, u, q, k, vt, v, dq,
      x1, l2, dO, dp, dqkv, y, total;
  __host__ __device__ BwdSmem(int m, int n, int c, int dhk, int hk, int rb,
                              int tabw, bool big) {
    npad = pad16(n);
    mp = (m + 31) / 32 * 32;
    r16 = pad16(rb);
    ds = dhk + 8;
    cs = c + 8;
    xs = c + 4;
    qks = 3 * c + 8;
    lab = 0;
    tab = align16(lab + (size_t)npad * 4);
    coord = align16(tab + (size_t)hk * tabw * 4);
    st1 = align16(coord + (size_t)m * 4);
    st2 = align16(st1 + (size_t)mp * 8);
    qr = align16(st2 + (size_t)r16 * 8);
    rc = align16(qr + (size_t)hk * mp * 16);
    da = align16(rc + (size_t)mp * 16);
    ao = align16(da + (size_t)hk * mp * ds * 2);
    g = align16(ao + (size_t)r16 * cs * 2);
    u = align16(g + (size_t)r16 * xs * 4);
    q = u;
    k = align16(q + (size_t)mp * ds * 2);
    vt = align16(k + (size_t)npad * ds * 2);
    const size_t end_a = align16(vt + (size_t)dhk * (npad + 8) * 2);
    x1 = u;
    l2 = align16(x1 + (size_t)r16 * xs * 4);
    dO = align16(l2 + (size_t)r16 * cs * 2);
    dp = align16(dO + (size_t)r16 * cs * 2);
    const size_t end_r = align16(dp + (size_t)r16 * cs * 2);
    v = align16(k + (size_t)npad * ds * 2);
    dq = align16(v + (size_t)npad * ds * 2);
    const size_t end_e = align16(dq + (size_t)mp * ds * 2);
    const size_t end_dy = align16(x1 + (size_t)r16 * xs * 4);
    dqkv = end_e > end_dy ? end_e : end_dy;
    const size_t end_q = big ? end_e : align16(dqkv + (size_t)r16 * qks * 2);
    y = end_a > end_r ? end_a : end_r;
    if (end_q > y) y = end_q;
    total = big ? y : align16(y + (size_t)mp * cs * 2);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Fragment addresses of a lane (row-major tiles in shared memory, stride
// ld elements, rows and 8-column blocks 16-byte aligned):
//   A of rows r0..r0+15, k k0..k0+15 (ldsm_x4);
//   B of two n-tiles n0, n0 + 8 over k k0..k0+15 from a [n][k] tile
//   (ldsm_x4: regs 0, 1 the first n-tile, 2, 3 the second);
//   B of two n-tiles from a [k][n] tile, or A^T of a [k][m] tile
//   (ldsm_x4_t; for A^T the registers are a0..a3).
__device__ __forceinline__ const bf16* frag_a(const bf16* p, int ld, int r0,
                                              int k0, int lane) {
  return p + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}

__device__ __forceinline__ const bf16* frag_bt(const bf16* p, int ld, int n0,
                                               int k0, int lane) {
  return p + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ const bf16* frag_bk(const bf16* p, int ld, int k0,
                                               int n0, int lane) {
  return p + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

__device__ __forceinline__ const bf16* frag_at(const bf16* p, int ld, int k0,
                                               int m0, int lane) {
  return p + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 + ((lane >> 3) & 1) * 8;
}

// out[r][col] = A[r, :] . Bt[col, :] for rows r < nrows and columns col <
// ncols, handed to epi(r, col, out[r][col], out[r][col + 1]) (col even).
// A: row-major bf16 in shared memory, rows read up to nrows rounded to 16;
// Bt: [ncols][K] k-packed bf16 in device memory (warp_gemm_acc's layout),
// K a multiple of 16.  Tasks of 32 rows x 32 columns go round the warps;
// each keeps the B fragments of the next kPF k-steps in flight (a ring in
// registers), so a product over K = 3C waits for the memory once, not
// once per k-step.  Every output element sums over k in order.
constexpr int kRT = 4;   // n-tiles (of 8 columns) per task
constexpr int kPF = 4;   // k-steps of B fragments in flight

template <class Epi>
__device__ __forceinline__ void rows_gemm(const bf16* A, int lda, int nrows,
                                          const bf16* Bt, int ldb, int ncols,
                                          int K, int warp, int nwarps,
                                          int lane, Epi epi) {
  const int g = lane / 4, cq = lane % 4;
  const int groups = (nrows + 31) / 32, nch = (ncols + 8 * kRT - 1) / (8 * kRT);
  const int steps = K / 16;
  for (int task = warp; task < groups * nch; task += nwarps) {
    const int g0 = (task / nch) * 32, n0 = (task % nch) * 8 * kRT;
    const int mtiles = g0 + 16 < nrows ? 2 : 1;
    const int ntiles = min(kRT, (ncols - n0) / 8);
    const bf16* brow = Bt + (size_t)(n0 + g) * ldb + 4 * cq;
    float acc[2][kRT][4];
    uint2 ring[kPF][kRT];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kRT; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll
    for (int u = 0; u < kPF; ++u)
#pragma unroll
      for (int nt = 0; nt < kRT; ++nt)
        if (u < steps && nt < ntiles)
          ring[u][nt] = __ldg(reinterpret_cast<const uint2*>(
              brow + (size_t)nt * 8 * ldb + u * 16));
    for (int s0 = 0; s0 < steps; s0 += kPF) {
#pragma unroll
      for (int u = 0; u < kPF; ++u) {
        const int s = s0 + u;
        if (s < steps) {
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt < mtiles) {
              const bf16* a0 = A + (g0 + mt * 16 + g) * lda + s * 16 + 2 * cq;
              af[mt][0] = lds32(a0);
              af[mt][1] = lds32(a0 + 8 * lda);
              af[mt][2] = lds32(a0 + 8);
              af[mt][3] = lds32(a0 + 8 * lda + 8);
            }
          }
#pragma unroll
          for (int nt = 0; nt < kRT; ++nt) {
            if (nt < ntiles) {
              mma16816(acc[0][nt], af[0], ring[u][nt].x, ring[u][nt].y);
              if (mtiles > 1)
                mma16816(acc[1][nt], af[1], ring[u][nt].x, ring[u][nt].y);
              if (s + kPF < steps)
                ring[u][nt] = __ldg(reinterpret_cast<const uint2*>(
                    brow + (size_t)nt * 8 * ldb + (s + kPF) * 16));
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kRT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = g0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < mtiles && nt < ntiles && r < nrows)
            epi(r, col, acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
        }
  }
}

// out[o][col0 + c] = sum_r A[r][o] B[r][c] (r < K, a multiple of 16) for
// the output rows o of 16-row tiles part, part + parts, ... < Mo and the
// columns c < n_valid of No (a multiple of 16): a row-reducing product,
// both operands read transposed from shared memory (ldmatrix.trans; A
// element by element from device memory when AG), the sum over r in one
// order.  Plain fp32 stores (each element once).
template <bool AG>
__device__ void tile_tn(const bf16* A, int lda, const bf16* B, int ldb, int K,
                        int Mo, int No, int n_valid, float* out, int ldo,
                        int col0, int part, int parts, int warp, int nwarps,
                        int lane) {
  const int g = lane / 4, cq = lane % 4;
  const int ncl = (No + 31) / 32;
  const int mine = (Mo / 16 - part + parts - 1) / parts;
  for (int task = warp; task < mine * ncl; task += nwarps) {
    const int rt = part + (task / ncl) * parts, c0 = (task % ncl) * 32;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4];
      if (AG) {   // the registers ldmatrix.trans gives (frag_at's tiles)
        const bf16* a0 = A + (size_t)(k0 + 2 * cq) * lda + rt * 16 + g;
        af[0] = ld_pair(a0, lda);
        af[1] = ld_pair(a0 + 8, lda);
        af[2] = ld_pair(a0 + (size_t)8 * lda, lda);
        af[3] = ld_pair(a0 + (size_t)8 * lda + 8, lda);
      } else {
        ldsm_x4_t(af, frag_at(A, lda, k0, rt * 16, lane));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (c0 + np * 16 < No) {
          uint32_t bf[4];
          ldsm_x4_t(bf, frag_bk(B, ldb, k0, c0 + np * 16, lane));
          mma16816(acc[2 * np], af, bf[0], bf[1]);
          mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = rt * 16 + g + hf * 8, cc = c0 + nt * 8 + 2 * cq;
        if (c0 + nt * 8 < No && cc < n_valid)
          *reinterpret_cast<float2*>(out + (size_t)r * ldo + col0 + cc) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
  }
}

// Q, K and V of head h: one GEMM of y against the head's q|k|v rows (N =
// 3 DHK, as B1), then the extra K/V rows.  V goes to V^T
// [DHK][npad + 8] (VT, attend_rows) or row-major like K.
template <int DHK, bool VT>
__device__ __forceinline__ void qkv_head(const BwdArgs& a, int h,
                                         const bf16* sy, int cs, bf16* sq,
                                         bf16* sk, bf16* sv, int ds, int vts,
                                         int warp, int nwarps, int lane) {
  const int M = a.m, C = a.c, E = a.n_ext;
  // Rows up to M rounded to 16: y's rows past M are zero, so are Q's.
  rows_gemm(sy, cs, pad16(M), a.wqkv + (size_t)h * 3 * DHK * C, C, 3 * DHK,
            C, warp, nwarps, lane, [&](int r, int col, float v0, float v1) {
    const int which = col / DHK;            // 0 q, 1 k, 2 v
    const int d = col - which * DHK;
    if (which == 0) {
      *reinterpret_cast<uint32_t*>(sq + r * ds + d) = pack2(v0, v1);
    } else if (r < M) {
      if (which == 1 || !VT) {
        *reinterpret_cast<uint32_t*>((which == 1 ? sk : sv) + r * ds + d) =
            pack2(v0, v1);
      } else {
        sv[d * vts + r] = __float2bfloat16_rn(v0);
        sv[(d + 1) * vts + r] = __float2bfloat16_rn(v1);
      }
    }
  });
  const bf16* ek = a.ext_kv + (size_t)h * 2 * E * DHK;
  const bf16* ev = ek + (size_t)E * DHK;
  for (int t = warp * 32 + lane; t < E * (DHK / 8); t += nwarps * 32) {
    const int r = t / (DHK / 8), d0 = (t % (DHK / 8)) * 8;
    *reinterpret_cast<uint4*>(sk + (M + r) * ds + d0) =
        __ldg(reinterpret_cast<const uint4*>(ek + (size_t)r * DHK + d0));
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(ev + (size_t)r * DHK + d0));
    if (VT) {
      const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) sv[(d0 + t8) * vts + M + r] = hv[t8];
    } else {
      *reinterpret_cast<uint4*>(sv + (M + r) * ds + d0) = u;
    }
  }
}

// 32 bits to the same offset in CTA `rank`'s shared memory (this CTA's
// own when the window runs on one CTA).
__device__ __forceinline__ void put32(void* local, int rank, uint32_t v,
                                      bool cluster) {
  if (cluster) st_cluster32(local, (uint32_t)rank, v);
  else *reinterpret_cast<uint32_t*>(local) = v;
}

__device__ __forceinline__ void sync_window(bool cluster) {
  if (cluster) cluster_sync();
  else __syncthreads();
}

// MAXT: threads per CTA (the launch plan's choice): 256 (8 warps, up to
// 255 registers) or 512 (16 warps, at most 128 registers: more warps to
// hide the attention's latency, a few spills).  One CTA per SM either way
// at the shared memory the flagship's calls take.
template <int DH, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
    fused_block_bwd_kernel(const BwdArgs a) {
  constexpr int DHK = pad16(DH);
  constexpr int KSTEPS = DHK / 16;   // k-steps over a head's dims
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's dims
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.m, C = a.c, E = a.n_ext, N = a.m + a.n_ext, H = a.heads;
  const int KS = a.ks, QS = a.qs, HK = H / a.hs;
  const bool CL = KS > 1;
  const int rank = CL ? (int)cluster_rank() : 0;
  const int hg = rank / QS, qi = rank % QS, h0 = hg * HK;
  const int RB = row_block(M, KS);
  const BwdSmem L(M, N, C, DHK, HK, RB, a.tabw, a.big);
  const int MP = L.mp, NPAD = L.npad, DS = L.ds, CS = L.cs, XS = L.xs;
  const int R16 = L.r16, QKS = L.qks, VTS = NPAD + 8;
  int* slab = reinterpret_cast<int*>(smem + L.lab);
  float* stab = reinterpret_cast<float*>(smem + L.tab);
  int* scoord = reinterpret_cast<int*>(smem + L.coord);
  float* st1 = reinterpret_cast<float*>(smem + L.st1);
  float* st2 = reinterpret_cast<float*>(smem + L.st2);
  float* sqr = reinterpret_cast<float*>(smem + L.qr);
  int* srow = reinterpret_cast<int*>(smem + L.rc);
  bf16* sda = reinterpret_cast<bf16*>(smem + L.da);
  bf16* sao = reinterpret_cast<bf16*>(smem + L.ao);
  float* sg = reinterpret_cast<float*>(smem + L.g);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* svt = reinterpret_cast<bf16*>(smem + L.vt);
  bf16* sv = reinterpret_cast<bf16*>(smem + L.v);
  bf16* sdq = reinterpret_cast<bf16*>(smem + L.dq);
  float* sx1 = reinterpret_cast<float*>(smem + L.x1);
  bf16* sl2 = reinterpret_cast<bf16*>(smem + L.l2);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L.dO);
  bf16* sdp = reinterpret_cast<bf16*>(smem + L.dp);
  const size_t win = blockIdx.x / KS;
  // big: this CTA's y and the window's dqkv (rows by window row).
  bf16* sdqkv = a.big ? a.dqkvg + win * (size_t)MP * QKS
                      : reinterpret_cast<bf16*>(smem + L.dqkv);
  bf16* sy = a.big ? a.yg + (size_t)blockIdx.x * MP * CS
                   : reinterpret_cast<bf16*>(smem + L.y);

  const int i = threadIdx.x, T = blockDim.x;
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const int nwarps = T / 32;
  const int dgap = a.drop.drop_cols - N;
  const bool f32 = a.f32, masked = a.labels != nullptr;
  const void* xw = act_at(a.x, win * M * C, f32);
  const void* dw = act_at(a.dout, win * M * C, f32);
  const bf16 zero = __float2bfloat16_rn(0.f);
  // The CTA's query rows (attention), key tiles (key-major pass), rows.
  const int QB = QS == 1 ? M : pad16((M + QS - 1) / QS);
  const int q_lo = qi * QB, q_hi = min(M, q_lo + QB);
  const int nkt = NPAD / 16, KB = (nkt + QS - 1) / QS;
  const int kt_lo = qi * KB, kt_hi = min(nkt, kt_lo + KB);
  const int rbase = rank * RB, nrows = max(0, min(M - rbase, RB));
  float* pw = a.part_w + win * bwd_part_w(M, C, H, E);
  float* pc = a.part_c + (size_t)blockIdx.x * bwd_part_c(C);
  float* pext = pw + (size_t)3 * C * C;
  float* pbias = pext + (size_t)2 * E * C;   // rows of bias_stride(N)
  if (CL) cluster_arrive_relaxed();   // waited for before the first push

  // ---- 0: zeroed receive buffers, LN1 of every row -> y, tables ----
  for (int t = i; t < HK * MP * DS; t += T) sda[t] = zero;
  for (int t = nrows * CS + i; t < R16 * CS; t += T) sao[t] = zero;
  typedef const bf16* BP;
  if (!f32) {
    const int chunks = C / 8;
    for (int t = i; t < M * chunks; t += T) {
      const int r = t / chunks, c8 = (t - r * chunks) * 8;
      *reinterpret_cast<uint4*>(sy + r * CS + c8) =
          *reinterpret_cast<const uint4*>(static_cast<BP>(xw) + (size_t)r * C + c8);
    }
    __syncthreads();
  }
  for (int r = i; r < (MIVP_B4_SKIP & 32 ? 0 : MP); r += T) {
    if (r >= M) {
      for (int c = 0; c < C; ++c) sy[r * CS + c] = zero;
      continue;
    }
    const float* xf = static_cast<const float*>(xw) + (size_t)r * C;
    const bf16* xb = sy + r * CS;
    float sum = 0.f, sq2 = 0.f;
    for (int c = 0; c < C; c += 8) {
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = f32 ? ld2(xf, c + 2 * k) : ld2(xb, c + 2 * k);
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
      for (int k = 0; k < 4; ++k) v[k] = f32 ? ld2(xf, c + 2 * k) : ld2(xb, c + 2 * k);
      uint32_t packed[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = c + 2 * k;
        packed[k] = pack2(
            (v[k].x - mu) * rstd * __ldg(a.ln1_s + cc) + __ldg(a.ln1_b + cc),
            (v[k].y - mu) * rstd * __ldg(a.ln1_s + cc + 1) + __ldg(a.ln1_b + cc + 1));
      }
      *reinterpret_cast<uint4*>(sy + r * CS + c) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    st1[2 * r] = mu;
    st1[2 * r + 1] = rstd;
  }
  if (masked) {
    const int* lab = a.labels + (size_t)(win % a.p_windows) * N;
    for (int t = i; t < N; t += T) slab[t] = __ldg(lab + t);
  }
  for (int t = i; t < HK * a.tabw; t += T)
    stab[t] = __ldg(a.pe_tab + (size_t)h0 * a.tabw + t);
  for (int t = i; t < M; t += T) scoord[t] = __ldg(a.pe_coord + t);
  const int oc = a.ph * a.ph, od = oc + a.pw * a.pw, oe = od + a.pd * a.pd;
  // Each row's offsets into its head's R, Cw and D tables.
  for (int r = i; r < MP; r += T) {
    const int cr = r < M ? __ldg(a.pe_coord + r) : 0;
    *reinterpret_cast<int4*>(srow + 4 * r) =
        make_int4((cr & 255) * a.ph, oc + ((cr >> 8) & 255) * a.pw,
                  od + ((cr >> 16) & 255) * a.pd, 0);
  }
  // Key rows past N are zero in K and V^T.
  for (int t = N + i; t < NPAD; t += T)
    for (int d = 0; d < DHK; ++d) {
      sk[t * DS + d] = zero;
      svt[d * VTS + t] = zero;
    }

  // ---- A: attention forward of the CTA's heads and query rows ----
  // -> the attention output rows (to their owners' ao) and the softmax
  // max and 1 / sum of each (head, row) (to every CTA of the head group).
  for (int hl = 0; hl < HK; ++hl) {
    const int h = h0 + hl;
    __syncthreads();  // y, tables written; the previous head's K/V read
    if (!(MIVP_B4_SKIP & 8))
      qkv_head<DHK, true>(a, h, sy, CS, sq, sk, svt, DS, VTS, warp, nwarps,
                          lane);
    __syncthreads();
    if (CL && hl == 0) cluster_wait();   // every peer has started
    const FactoredBias bias{stab + hl * a.tabw, scoord, M, a.ph, a.pw, a.pd,
                            oc, od, oe, oe + E, a.fold, a.pe_scale};
    for (int t0 = q_lo + warp * 16; t0 < (MIVP_B4_SKIP & 8 ? 0 : q_hi);
         t0 += nwarps * 16) {
      const int ra = t0 + g, rb = t0 + g + 8;
      const AttnDrop dr{
          a.drop.seed_a, a.drop.thr_a, a.drop.keep_a,
          (((uint32_t)win * H + h) * M + ra) * (uint32_t)a.drop.drop_cols,
          (((uint32_t)win * H + h) * M + rb) * (uint32_t)a.drop.drop_cols,
          M, dgap};
      float o[DTILES][4], ml[2][2];
      attend_rows<DHK, true>(o, sq, sk, DS, svt, VTS, slab, masked, bias, t0,
                             M, N, NPAD, a.scale, dr, lane, ml);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = hf ? rb : ra;
        if (r >= q_hi) continue;
        const int owner = CL ? r / RB : 0;
        bf16* dst = sao + (r - owner * RB) * CS + h * DH + 2 * cq;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt)
          if (dt * 8 + 2 * cq < DH)   // DH is even: d < DH => d + 1 < DH
            put32(dst + dt * 8, owner, pack2(o[dt][2 * hf], o[dt][2 * hf + 1]), CL);
        if (cq == 0)
          for (int p = 0; p < QS; ++p) {
            float* st = sqr + (hl * MP + r) * 4;
            put32(st, hg * QS + p, __float_as_uint(ml[hf][0]), CL);
            put32(st + 1, hg * QS + p, __float_as_uint(1.f / ml[hf][1]), CL);
          }
      }
    }
  }
  sync_window(CL);   // every attention row and statistic has landed

  // ---- B-D: row phase on the CTA's rows [rbase, rbase + nrows) ----
  // x1 = x + (ao Wproj^T + bproj) * keep_p -> x1 (fp32)
  const int prows = MIVP_B4_SKIP & 64 ? 0 : nrows;   // probe: no row phase
  rows_gemm(sao, CS, MIVP_B4_SKIP & 8 ? 0 : prows, a.wproj, C, C, C,
                  warp, nwarps, lane, [&](int lr, int col, float v0, float v1) {
    const int r = rbase + lr;
    const float2 xv = ld_act2(xw, (size_t)r * C + col, f32);
    float p0 = v0 + __ldg(a.bproj + col);
    float p1 = v1 + __ldg(a.bproj + col + 1);
    if (a.drop.thr_p) {
      const uint32_t base = ((uint32_t)win * M + r) * C + col;
      p0 *= keep_value(a.drop.seed_p, base, a.drop.thr_p, a.drop.keep_p);
      p1 *= keep_value(a.drop.seed_p, base + 1, a.drop.thr_p, a.drop.keep_p);
    }
    sx1[lr * XS + col] = xv.x + p0;
    sx1[lr * XS + col + 1] = xv.y + p1;
  });
  // dout rows (bf16 operand copy); zero tile rows past nrows
  for (int t = i; t < R16 * C; t += T) {
    const int lr = t / C, c = t - lr * C;
    const bool in = lr < prows;
    sdo[lr * CS + c] = in ? __float2bfloat16_rn(
        ld_act(dw, (size_t)(rbase + lr) * C + c, f32)) : zero;
    if (!in) sl2[lr * CS + c] = sdp[lr * CS + c] = zero;
  }
  __syncthreads();
  // LN2 -> l2 (bf16), a warp per row
  for (int lr = warp; lr < prows; lr += nwarps) {
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
      sl2[lr * CS + c] = __float2bfloat16_rn(
          (sx1[lr * XS + c] - mu) * rstd * __ldg(a.ln2_s + c) + __ldg(a.ln2_b + c));
    if (lane == 0) {
      st2[2 * lr] = mu;
      st2[2 * lr + 1] = rstd;
    }
  }
  // d(LN2 out) = dout Wmlp (Wmlp in (in, out) layout as Bt) -> g
  rows_gemm(sdo, CS, prows, a.wmlp_io, C, C, C, warp, nwarps, lane,
                  [&](int lr, int col, float v0, float v1) {
    sg[lr * XS + col] = v0;
    sg[lr * XS + col + 1] = v1;
  });
  __syncthreads();
  // Column sums over the rows: LN2 scale and bias, the MLP bias.
  float* pvec = pc + (size_t)2 * C * C;   // dbproj, dbmlp, dln1s, dln1b, dln2s, dln2b
  for (int c = i; c < C; c += T) {
    float s_ls = 0.f, s_lb = 0.f, s_bm = 0.f;
#pragma unroll 8
#pragma unroll 8
#pragma unroll 8
    for (int lr = 0; lr < prows; ++lr) {
      const float dl = sg[lr * XS + c];
      s_ls += dl * (sx1[lr * XS + c] - st2[2 * lr]) * st2[2 * lr + 1];
      s_lb += dl;
      s_bm += ld_act(dw, (size_t)(rbase + lr) * C + c, f32);
    }
    pvec[C + c] = s_bm;
    pvec[4 * C + c] = s_ls;
    pvec[5 * C + c] = s_lb;
  }
  __syncthreads();
  // LN2 backward, a warp per row: g = d(x1) (fp32, in place), dproj =
  // g * keep_p -> dp (bf16)
  for (int lr = warp; lr < prows; lr += nwarps) {
    const int r = rbase + lr;
    const float mu = st2[2 * lr], rstd = st2[2 * lr + 1];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = sg[lr * XS + c] * __ldg(a.ln2_s + c);
      s1 += dxh;
      s2 += dxh * (sx1[lr * XS + c] - mu) * rstd;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    s1 /= C;
    s2 /= C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (sx1[lr * XS + c] - mu) * rstd;
      const float dxh = sg[lr * XS + c] * __ldg(a.ln2_s + c);
      const float gv = ld_act(dw, (size_t)r * C + c, f32) + (dxh - s1 - xh * s2) * rstd;
      sg[lr * XS + c] = gv;
      float dp = gv;
      if (a.drop.thr_p)
        dp *= keep_value(a.drop.seed_p, ((uint32_t)win * M + r) * C + c,
                         a.drop.thr_p, a.drop.keep_p);
      sdp[lr * CS + c] = __float2bfloat16_rn(dp);
    }
  }
  __syncthreads();
  // dbproj over the rows (fp32 dproj); dWmlp = l2^T dout, dWproj = ao^T dp
  for (int c = i; c < C; c += T) {
    float s_bp = 0.f;
#pragma unroll 8
    for (int lr = 0; lr < prows; ++lr) {
      float dp = sg[lr * XS + c];
      if (a.drop.thr_p)
        dp *= keep_value(a.drop.seed_p, ((uint32_t)win * M + rbase + lr) * C + c,
                         a.drop.thr_p, a.drop.keep_p);
      s_bp += dp;
    }
    pvec[c] = s_bp;
  }
  if (!(MIVP_B4_SKIP & 66)) {
    tile_tn<false>(sl2, CS, sdo, CS, R16, C, C, C, pc + (size_t)C * C, C, 0,
                   0, 1, warp, nwarps, lane);
    tile_tn<false>(sao, CS, sdp, CS, R16, C, C, C, pc, C, 0, 0, 1, warp,
                   nwarps, lane);
  }
  // d(attention output) = dproj Wproj (in, out) -> x1's space (bf16)
  bf16* sdA = reinterpret_cast<bf16*>(sx1);
  rows_gemm(sdp, CS, prows, a.wproj_io, C, C, C, warp, nwarps, lane,
                  [&](int lr, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(sdA + lr * CS + col) = pack2(v0, v1);
  });
  __syncthreads();
  // Each (row, head): dO columns and D = rowsum(dO o O) to every CTA of
  // the head's group.
  for (int t = i; t < prows * H; t += T) {
    const int lr = t / H, h = t - lr * H, r = rbase + lr;
    const int hgt = h / HK, hlt = h - hgt * HK;
    const bf16* src = sdA + lr * CS + h * DH;
    const bf16* ao = sao + lr * CS + h * DH;
    float D = 0.f;
    for (int d = 0; d < DH; ++d)
      D += __bfloat162float(src[d]) * __bfloat162float(ao[d]);
    for (int p = 0; p < QS; ++p) {
      const int dst = hgt * QS + p;
      bf16* row = sda + (hlt * MP + r) * DS;
      for (int d = 0; d < DH; d += 2)
        put32(row + d, dst, *reinterpret_cast<const uint32_t*>(src + d), CL);
      put32(sqr + (hlt * MP + r) * 4 + 2, dst, __float_as_uint(D), CL);
    }
  }
  sync_window(CL);   // dO and D of every row have landed; row buffers dead

  // ---- E: attention backward of the CTA's heads ----
  for (int t = i; t < (MP - M) * DS; t += T) sdq[M * DS + t] = zero;
  for (int t = N + i; t < NPAD; t += T)
    for (int d = 0; d < DHK; ++d) sk[t * DS + d] = sv[t * DS + d] = zero;
  for (int t = i; t < HK * MP; t += T)
    sqr[4 * t + 3] = __int_as_float(masked && t % MP < M ? slab[t % MP] : 0);
  const float scale = a.scale;
  for (int hl = 0; hl < HK; ++hl) {
    const int h = h0 + hl;
    // The partners are done with this CTA's dQ, K and V of the last head.
    if (QS > 1 && hl > 0) cluster_sync();
    __syncthreads();
    qkv_head<DHK, false>(a, h, sy, CS, sq, sk, sv, DS, 0, warp, nwarps,
                         lane);
    __syncthreads();
    const FactoredBias bias{stab + hl * a.tabw, scoord, M, a.ph, a.pw, a.pd,
                            oc, od, oe, oe + E, a.fold, a.pe_scale};
    const bf16* dah = sda + hl * MP * DS;
    const float4* qrh = reinterpret_cast<const float4*>(sqr) + hl * MP;
    const float* tabh = stab + hl * a.tabw;
    const uint32_t drow0 = ((uint32_t)win * H + h) * M;

    // E1, query-major: dS of the CTA's query rows -> the bias partial,
    // dQ = scale dS K -> dq (and the partners' dq).
    for (int t0 = q_lo + warp * 16; t0 < (MIVP_B4_SKIP & 128 ? 0 : q_hi);
         t0 += nwarps * 16) {
      uint32_t qa[KSTEPS][4], oa[KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        ldsm_x4(qa[ks], frag_a(sq, DS, t0, ks * 16, lane));
        ldsm_x4(oa[ks], frag_a(dah, DS, t0, ks * 16, lane));
      }
      const int ra = t0 + g, rb = t0 + g + 8;
      const bool va = ra < M, vb = rb < M;
      const int lab_a = (masked && va) ? slab[ra] : 0;
      const int lab_b = (masked && vb) ? slab[rb] : 0;
      const FactoredBias::Row bias_a = bias.row(va ? ra : 0);
      const FactoredBias::Row bias_b = bias.row(vb ? rb : 0);
      const uint32_t drow_a = (drow0 + ra) * (uint32_t)a.drop.drop_cols;
      const uint32_t drow_b = (drow0 + rb) * (uint32_t)a.drop.drop_cols;
      const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 qa_ = va ? qrh[ra] : zero4, qb_ = vb ? qrh[rb] : zero4;
      const float m_a = qa_.x, il_a = qa_.y, D_a = qa_.z;
      const float m_b = qb_.x, il_b = qb_.y, D_b = qb_.z;
      const int NB = bias_stride(N);
      float* bias_out_a = pbias + ((size_t)h * M + ra) * NB;
      float* bias_out_b = pbias + ((size_t)h * M + rb) * NB;
      float dq[DTILES][4];
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll 1
      for (int j0 = 0; j0 < NPAD; j0 += kKeyChunk) {
        const int ntiles = min(kKeyChunk, NPAD - j0) / 8;  // even
        float ds[kKeyChunk / 8][4];
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
          ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
          if (nt < ntiles) {
            float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
            const bf16* k0 = sk + (j0 + nt * 8 + g) * DS + 2 * cq;
            const bf16* v0 = sv + (j0 + nt * 8 + g) * DS + 2 * cq;
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              mma16816(sc, qa[ks], lds32(k0 + ks * 16), lds32(k0 + ks * 16 + 8));
              mma16816(dp, oa[ks], lds32(v0 + ks * 16), lds32(v0 + ks * 16 + 8));
            }
            const int jp = j0 + nt * 8 + 2 * cq;   // keys jp, jp + 1
            const int cj = bias.col(jp);
            float bv[4];
            bias.pair(bias_a, cj, jp, bv[0], bv[1]);
            bias.pair(bias_b, cj, jp, bv[2], bv[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = jp + (e & 1);
              const bool top = e < 2;
              if (j < N && (top ? va : vb)) {
                float s = sc[e] * scale + bv[e], mk = 1.f;
                if (masked) {
                  const int lj = slab[j];
                  if (!(lj == (top ? lab_a : lab_b) || lj < 0)) {
                    s = 0.f;
                    mk = 0.f;
                  }
                }
                const float p = __expf(s - (top ? m_a : m_b)) * (top ? il_a : il_b);
                float kp = 1.f;
                if (a.drop.thr_a)
                  kp = keep_value(a.drop.seed_a,
                                  (top ? drow_a : drow_b) + drop_col(j, M, dgap),
                                  a.drop.thr_a, a.drop.keep_a);
                ds[nt][e] = p * (dp[e] * kp - (top ? D_a : D_b)) * mk;
              }
            }
            // The bias gradient's partial, keys jp and jp + 1 of both rows.
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float* dst = (hf ? bias_out_b : bias_out_a) + jp;
              if (MIVP_B4_SKIP & 1 || !(hf ? vb : va) || jp >= N) continue;
              if (jp + 1 < N)
                *reinterpret_cast<float2*>(dst) =
                    make_float2(ds[nt][2 * hf], ds[nt][2 * hf + 1]);
              else
                *dst = ds[nt][2 * hf];
            }
          }
        }
        // dQ += dS K (A from the registers, B = K [key][dim] transposed).
#pragma unroll
        for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
          if (2 * kk < ntiles) {
            const uint32_t pa[4] = {pack2(ds[2 * kk][0], ds[2 * kk][1]),
                                    pack2(ds[2 * kk][2], ds[2 * kk][3]),
                                    pack2(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                                    pack2(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
            for (int dt = 0; dt < DTILES; dt += 2) {
              uint32_t kb[4];
              ldsm_x4_t(kb, frag_bk(sk, DS, j0 + kk * 16, dt * 8, lane));
              mma16816(dq[dt], pa, kb[0], kb[1]);
              mma16816(dq[dt + 1], pa, kb[2], kb[3]);
            }
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = hf ? rb : ra;
        if (r >= q_hi) continue;
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          const uint32_t v = pack2(dq[dt][2 * hf] * scale, dq[dt][2 * hf + 1] * scale);
          bf16* dst = sdq + r * DS + dt * 8 + 2 * cq;
          for (int p = 0; p < QS; ++p) put32(dst, hg * QS + p, v, QS > 1);
        }
      }
    }
    // K and V are read whole in E1: every partner is done with them
    // before dK and dV overwrite them.
    sync_window(QS > 1);

    // E2, key-major: a warp owns 16 keys and walks every query row;
    // dV = (P o keep)^T dO and dK = scale dS^T Q in registers, then over
    // the tile's rows of K and V (and the partners'), or to the extra-row
    // partial.
    for (int kt = kt_lo + warp; kt < (MIVP_B4_SKIP & 4 ? 0 : kt_hi); kt += nwarps) {
      const int j0 = kt * 16;
      uint32_t ka[KSTEPS][4], vb_[KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        ldsm_x4(ka[ks], frag_a(sk, DS, j0, ks * 16, lane));
        ldsm_x4(vb_[ks], frag_a(sv, DS, j0, ks * 16, lane));
      }
      // The lane's two keys: label, dropout column, bias-table indices
      // (content keys) or the extra column's value (fold: per row).
      int jk[2], labj[2], kr[2], kc[2], kd[2];
      uint32_t dcol[2];
      float kext[2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int j = j0 + g + kh * 8;
        jk[kh] = j;
        labj[kh] = (masked && j < N) ? slab[j] : 0;
        dcol[kh] = drop_col(j, M, dgap);
        const int cj = j < M ? scoord[j] : 0;
        kr[kh] = cj & 255;
        kc[kh] = (cj >> 8) & 255;
        kd[kh] = (cj >> 16) & 255;
        kext[kh] = j > M || (j == M && !a.fold) ? tabh[oe + min(j, N - 1) - M]
                                                : 0.f;
      }
      float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
#pragma unroll 1
      for (int q0 = 0; q0 < M; q0 += 16) {
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[u][e] = dpt[u][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, frag_bt(sq, DS, q0, ks * 16, lane));
          ldsm_x4(ob, frag_bt(dah, DS, q0, ks * 16, lane));
          mma16816(st[0], ka[ks], qb[0], qb[1]);
          mma16816(st[1], ka[ks], qb[2], qb[3]);
          mma16816(dpt[0], vb_[ks], ob[0], ob[1]);
          mma16816(dpt[1], vb_[ks], ob[2], ob[3]);
        }
        float pd[2][4], ds[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c1 = 0; c1 < 2; ++c1) {
            const int q = q0 + u * 8 + 2 * cq + c1;
            const bool vq = q < M;
            const float4 qd = qrh[vq ? q : 0];    // m, 1 / l, D, label
            const int4 qo = *reinterpret_cast<const int4*>(srow + 4 * q);
            const uint32_t drq = (drow0 + q) * (uint32_t)a.drop.drop_cols;
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              const int e = kh * 2 + c1, j = jk[kh];
              pd[u][e] = ds[u][e] = 0.f;
              if (vq && j < N) {
                // FactoredBias::at, with the row's and key's indices
                // computed once.
                const float b =
                    j < M ? bias.scaled(__fadd_rn(
                                __fadd_rn(tabh[qo.x + kr[kh]], tabh[qo.y + kc[kh]]),
                                tabh[qo.z + kd[kh]]))
                          : (j == M && a.fold ? tabh[oe + E + q] : kext[kh]);
                float s = st[u][e] * scale + b, mk = 1.f;
                if (masked && !(labj[kh] == __float_as_int(qd.w) || labj[kh] < 0)) {
                  s = 0.f;
                  mk = 0.f;
                }
                const float p = __expf(s - qd.x) * qd.y;
                float kp = 1.f;
                if (a.drop.thr_a)
                  kp = keep_value(a.drop.seed_a, drq + dcol[kh], a.drop.thr_a,
                                  a.drop.keep_a);
                pd[u][e] = p * kp;
                ds[u][e] = p * (dpt[u][e] * kp - qd.z) * mk;
              }
            }
          }
        const uint32_t pa[4] = {pack2(pd[0][0], pd[0][1]), pack2(pd[0][2], pd[0][3]),
                                pack2(pd[1][0], pd[1][1]), pack2(pd[1][2], pd[1][3])};
        const uint32_t sa[4] = {pack2(ds[0][0], ds[0][1]), pack2(ds[0][2], ds[0][3]),
                                pack2(ds[1][0], ds[1][1]), pack2(ds[1][2], ds[1][3])};
#pragma unroll
        for (int dt = 0; dt < DTILES; dt += 2) {
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, frag_bk(dah, DS, q0, dt * 8, lane));
          ldsm_x4_t(qb, frag_bk(sq, DS, q0, dt * 8, lane));
          mma16816(dv[dt], pa, ob[0], ob[1]);
          mma16816(dv[dt + 1], pa, ob[2], ob[3]);
          mma16816(dk[dt], sa, qb[0], qb[1]);
          mma16816(dk[dt + 1], sa, qb[2], qb[3]);
        }
      }
      // The tile's rows: content keys over K and V here and at every
      // partner (bf16), extra keys to the partial (fp32).
      __syncwarp();
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int j = jk[kh];
#pragma unroll
        for (int dt = 0; dt < DTILES; ++dt) {
          const int d = dt * 8 + 2 * cq;
          const float k0 = dk[dt][2 * kh] * scale, k1 = dk[dt][2 * kh + 1] * scale;
          const float v0 = dv[dt][2 * kh], v1 = dv[dt][2 * kh + 1];
          if (j < M) {
            for (int p = 0; p < QS; ++p) {
              put32(sk + j * DS + d, hg * QS + p, pack2(k0, k1), QS > 1);
              put32(sv + j * DS + d, hg * QS + p, pack2(v0, v1), QS > 1);
            }
          } else if (j < N && d < DH) {
            float* ek = pext + (size_t)(j - M) * C + h * DH + d;
            *reinterpret_cast<float2*>(ek) = make_float2(k0, k1);
            *reinterpret_cast<float2*>(ek + (size_t)E * C) = make_float2(v0, v1);
          }
        }
      }
    }
    sync_window(QS > 1);   // dQ, dK, dV of every row are here

    // E3: head h's columns of dWq, dWk, dWv over every row (output rows
    // split between the partners), and the CTA's query rows of dQ, dK, dV
    // to the rows' owners.
    if (!(MIVP_B4_SKIP & 2)) {
      const int KM = pad16(M);   // y's rows past M are zero
      const bf16* bs[3] = {sdq, sk, sv};
      for (int w3 = 0; w3 < 3; ++w3) {
        float* dst = pw + (size_t)w3 * C * C;
        if (a.big)
          tile_tn<true>(sy, CS, bs[w3], DS, KM, C, DHK, DH, dst, C, h * DH,
                        qi, QS, warp, nwarps, lane);
        else
          tile_tn<false>(sy, CS, bs[w3], DS, KM, C, DHK, DH, dst, C, h * DH,
                         qi, QS, warp, nwarps, lane);
      }
    }
    const int half = DH / 2;
    for (int t = i; t < (q_hi - q_lo) * 3 * half; t += T) {
      const int r = q_lo + t / (3 * half), rest = t % (3 * half);
      const int which = rest / half, d = 2 * (rest - which * half);
      const bf16* src = (which == 0 ? sdq : which == 1 ? sk : sv) + r * DS + d;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(src);
      if (a.big) {
        *reinterpret_cast<uint32_t*>(sdqkv + (size_t)r * QKS + which * C +
                                     h * DH + d) = v;
      } else {
        const int owner = CL ? r / RB : 0;
        put32(sdqkv + (r - owner * RB) * QKS + which * C + h * DH + d, owner,
              v, CL);
      }
    }
  }
  sync_window(CL);   // every row's dQ, dK, dV of every head has landed

  // ---- F: dY = [dQ dK dV] [Wq Wk Wv]^T -> x1's space, LN1 backward ----
  float* sdy = sx1;
  const int frows = MIVP_B4_SKIP & 256 ? 0 : nrows;   // probe: no phase F
  rows_gemm(a.big ? sdqkv + (size_t)rbase * QKS : sdqkv, QKS, frows,
            a.wqkv_io, 3 * C, C, 3 * C, warp,
                  nwarps, lane, [&](int lr, int col, float v0, float v1) {
    sdy[lr * XS + col] = v0;
    sdy[lr * XS + col + 1] = v1;
  });
  __syncthreads();
  void* dxw = act_at(a.dx, win * M * C, f32);
  for (int lr = warp; lr < frows; lr += nwarps) {
    const int r = rbase + lr;
    const float mu = st1[2 * r], rstd = st1[2 * r + 1];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = sdy[lr * XS + c] * __ldg(a.ln1_s + c);
      s1 += dxh;
      s2 += dxh * (ld_act(xw, (size_t)r * C + c, f32) - mu) * rstd;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    s1 /= C;
    s2 /= C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (ld_act(xw, (size_t)r * C + c, f32) - mu) * rstd;
      const float dxh = sdy[lr * XS + c] * __ldg(a.ln1_s + c);
      st_act(dxw, (size_t)r * C + c, f32,
             sg[lr * XS + c] + (dxh - s1 - xh * s2) * rstd);
    }
  }
  for (int c = i; c < C; c += T) {
    float s_ls = 0.f, s_lb = 0.f;
#pragma unroll 8
    for (int lr = 0; lr < frows; ++lr) {
      const int r = rbase + lr;
      const float dy = sdy[lr * XS + c];
      s_ls += dy * (ld_act(xw, (size_t)r * C + c, f32) - st1[2 * r]) * st1[2 * r + 1];
      s_lb += dy;
    }
    pvec[2 * C + c] = s_ls;
    pvec[3 * C + c] = s_lb;
  }
}

// out[e] = sum over the partials in order: the first n_w elements over
// the bp per-window partials, the rest over the per-CTA partials.
__global__ void bwd_reduce_kernel(const float* part_w, int bp, size_t n_w,
                                  const float* part_c, int nc, size_t n_c,
                                  float* out) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_w + n_c;
       e += (size_t)gridDim.x * blockDim.x) {
    const bool w = e < n_w;
    const float* p = w ? part_w + e : part_c + (e - n_w);
    const size_t stride = w ? n_w : n_c;
    const int count = w ? bp : nc;
    float s = 0.f;
#pragma unroll 8
    for (int t = 0; t < count; ++t) s += __ldg(p + (size_t)t * stride);
    out[e] = s;
  }
}

template <int DH, int MAXT>
cudaError_t launch_bwd(const BwdArgs& a, int bp, cudaStream_t stream,
                       int* info) {
  auto* kernel = fused_block_bwd_kernel<DH, MAXT>;
  const BwdSmem L(a.m, a.m + a.n_ext, a.c, pad16(DH), a.heads / a.hs,
                  row_block(a.m, a.ks), a.tabw, a.big);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  // Sets the kernel's dynamic shared-memory limit (first call per shape).
  if (resident_ctas(kernel, MAXT, L.total) < 1)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_clustered(kernel, a, bp, a.ks, MAXT, L.total,
                                     stream, info);
  if (err != cudaSuccess || info != nullptr || (MIVP_B4_SKIP & 16))
    return err;
  const size_t n_w = bwd_part_w(a.m, a.c, a.heads, a.n_ext);
  const size_t n_c = bwd_part_c(a.c);
  const size_t blocks = (n_w + n_c + 255) / 256;
  bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      stream>>>(a.part_w, bp, n_w, a.part_c, bp * a.ks, n_c,
                                a.out);
  return cudaGetLastError();
}

template <int MAXT>
cudaError_t launch_dh(const BwdArgs& a, int dh, int bp, cudaStream_t s,
                      int* info) {
  switch (dh) {
    case 8: return launch_bwd<8, MAXT>(a, bp, s, info);
    case 12: return launch_bwd<12, MAXT>(a, bp, s, info);
    case 16: return launch_bwd<16, MAXT>(a, bp, s, info);
    case 24: return launch_bwd<24, MAXT>(a, bp, s, info);
    case 32: return launch_bwd<32, MAXT>(a, bp, s, info);
    case 48: return launch_bwd<48, MAXT>(a, bp, s, info);
    case 64: return launch_bwd<64, MAXT>(a, bp, s, info);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The 512-thread instances are compiled in their own translation unit
// (fused_block_bwd_512.cu includes this file with MIVP_BWD_512_UNIT), so
// the two halves build in parallel.
#ifdef MIVP_BWD_512_UNIT

extern "C" cudaError_t mivp_fused_block_bwd_512(const void* args, int dh,
                                                int bp, void* stream,
                                                int* info) {
  return launch_dh<512>(*static_cast<const BwdArgs*>(args), dh, bp,
                        static_cast<cudaStream_t>(stream), info);
}

#else

extern "C" cudaError_t mivp_fused_block_bwd_512(const void* args, int dh,
                                                int bp, void* stream,
                                                int* info);

// ops: host array of 15 device pointers (ops/fused_block_bwd.py::
// _OPERANDS order); ks, hs, qs, threads: the launch plan
// (backward_plan); part_w, part_c: the workspace; out: [PW + PC] fp32,
// the summed gradients; y_ws, dqkv_ws: the device-memory form's
// workspace ([BP * ks, MP, C + 8] and [BP, MP, 3C + 8] bf16, MP = M
// rounded up to 32) when big, else null; info: null to launch, else
// int[7] receiving the launch's shape (launch_clustered) and nothing runs.
extern "C" cudaError_t mivp_fused_block_bwd(
    const void* x, const void* dout, void* dx, const void* const* ops,
    const void* labels, void* part_w, void* part_c, void* out, void* y_ws,
    void* dqkv_ws, int* info, int big,
    int bp, int m, int c, int heads, int dh, int n_ext, int p_windows,
    int ph, int pw, int pd, int fold, int ks, int hs, int qs, int threads,
    float scale,
    float pe_scale, unsigned seed_a, unsigned seed_p, unsigned thr_a,
    unsigned thr_p, float keep_a, float keep_p, int drop_cols, int x_f32,
    void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      (labels != nullptr && p_windows < 1) || drop_cols < m + n_ext ||
      ph < 1 || pw < 1 || pd < 1 || ph > 255 || pw > 255 || pd > 255 ||
      (fold != 0 && n_ext < 1) || !(ks == 1 || ks == 2 || ks == 4 || ks == 8) ||
      hs < 1 || qs < 1 || hs * qs != ks || heads % hs != 0 ||
      (ks > 1 && m < 16 * ks) || (threads != 256 && threads != 512) ||
      (big && info == nullptr && (y_ws == nullptr || dqkv_ws == nullptr)))
    return cudaErrorInvalidValue;
  BwdArgs a = {};
  a.x = x;
  a.dout = dout;
  a.dx = dx;
  a.f32 = x_f32 != 0;
  a.wqkv = static_cast<const bf16*>(ops[0]);
  a.ext_kv = static_cast<const bf16*>(ops[1]);
  a.pe_tab = static_cast<const float*>(ops[2]);
  a.pe_coord = static_cast<const int*>(ops[3]);
  a.ln1_s = static_cast<const float*>(ops[4]);
  a.ln1_b = static_cast<const float*>(ops[5]);
  a.wproj = static_cast<const bf16*>(ops[6]);
  a.wproj_io = static_cast<const bf16*>(ops[7]);
  a.bproj = static_cast<const float*>(ops[8]);
  a.ln2_s = static_cast<const float*>(ops[9]);
  a.ln2_b = static_cast<const float*>(ops[10]);
  a.wmlp = static_cast<const bf16*>(ops[11]);
  a.wmlp_io = static_cast<const bf16*>(ops[12]);
  a.bmlp = static_cast<const float*>(ops[13]);
  a.wqkv_io = static_cast<const bf16*>(ops[14]);
  a.labels = static_cast<const int*>(labels);
  a.part_w = static_cast<float*>(part_w);
  a.part_c = static_cast<float*>(part_c);
  a.out = static_cast<float*>(out);
  a.big = big != 0;
  a.yg = static_cast<bf16*>(y_ws);
  a.dqkvg = static_cast<bf16*>(dqkv_ws);
  a.m = m;
  a.c = c;
  a.heads = heads;
  a.n_ext = n_ext;
  a.p_windows = p_windows;
  a.ph = ph;
  a.pw = pw;
  a.pd = pd;
  a.fold = fold != 0;
  a.tabw = bias_table_floats(ph, pw, pd, m, n_ext, a.fold);
  a.scale = scale;
  a.pe_scale = pe_scale;
  a.drop = DropArgs{seed_a, seed_p, thr_a, thr_p, keep_a, keep_p, drop_cols};
  a.ks = ks;
  a.hs = hs;
  a.qs = qs;
  if (threads == 512)
    return mivp_fused_block_bwd_512(&a, dh, bp, stream, info);
  return launch_dh<256>(a, dh, bp, static_cast<cudaStream_t>(stream), info);
}

#endif  // MIVP_BWD_512_UNIT
