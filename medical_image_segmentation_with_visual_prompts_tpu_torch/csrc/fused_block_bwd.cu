// Fused Swin transformer block BACKWARD for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/fused_block_bwd.py,
// launched by `block_backward`).  For one window per CTA it recomputes
// the forward of csrc/fused_block.cu (same bf16 casts, same dropout
// masks) and chains the gradients
//
//   mlp -> LN2 -> proj (dropout) -> P.V -> softmax
//   (dS = P o (dP - rowsum(dO o O)), dropout mask inside dP)
//   -> multiplicative label mask -> scores -> q/k/v -> LN1 -> residuals
//
// Outputs: dx (bf16, per window) and fp32 gradients of every operand:
// the five weights in (in, out) layout, the six LayerNorm/bias vectors,
// the assembled bias [H, M, N] and the [E, C] extra K and V rows.  The
// wrapper (ops/fused_block_bwd.py) maps the row and bias gradients back
// to the prompt tokens and the positional-bias parameters by autograd.
//
// The TPU grid ran windows in order and carried the weight gradients in
// VMEM from step to step; here CTAs run in parallel, so every cross-
// window sum is an fp32 atomicAdd into an L2-resident output: C x C per
// weight, H x M x N for the bias (1.3 MB at the flagship's first stage).
// Atomics keep the kernel one pass; their order changes from run to run,
// so sums differ by fp32 rounding between runs (relative ~1e-6).
//
// What bounds it on the H100: the matrix products (three times the
// forward's) and, at the C = 48 stages, the bias-gradient atomics.
// Design: the forward's warp layout (each warp owns 32 rows, mma.sync
// m16n8k16 with bf16 operands and fp32 sums); the window's row
// activations (LN1 and LN2 outputs, attention output, x1 and the row
// gradients) live in a global workspace the CTA reuses from L2, and the
// head being differentiated lives in shared memory: Q, K, V, dO and dQ as
// bf16 padded to 16 columns per head, dK and dV as fp32 accumulators fed
// by shared-memory atomics.  P is recomputed per 64-key chunk from the
// forward's saved row max and sum, never stored.  Products that reduce
// over rows (dV = P^T dO, dK = dS^T Q, the weight gradients) read their
// operands transposed with paired scalar loads.

#include "fused_block_common.cuh"

namespace {

struct BwdArgs {
  const bf16* x;        // [BP, M, C]
  const bf16* dout;     // [BP, M, C]
  bf16* dx;             // [BP, M, C]
  const bf16* wqkv;     // [H, 3, DHK, C]: Wq|Wk|Wv of head h, (out, in)
  const bf16* wqkv_t;   // [H, 3, C, DHK]: the same, (in, out)
  const bf16* ext_kv;   // [H, 2, E, DHK]: extra K rows, then extra V rows
  const float* bias;    // [H, M, N]
  const int* labels;    // [P, N] shift-region labels, or null
  const float* ln1_s;
  const float* ln1_b;
  const bf16* wproj;    // [C, C] (out, in)
  const bf16* wproj_io; // [C, C] (in, out)
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* wmlp;     // [C, C] (out, in)
  const bf16* wmlp_io;  // [C, C] (in, out)
  const float* bmlp;
  bf16* ws_h;    // [BP, 6, MP, C]: y, a, l2, dout, dproj, dattn
  float* ws_f;   // [BP, 4, MP, C]: x1, dx1, dl2, dy
  float* ws_s;   // [BP, MP, 4]: mu1, rstd1, mu2, rstd2
  float* ws_sm;  // [BP, H, MP, 2]: softmax row max and sum per head
  float* dwq;    // [C, C] (in, out), and the other weights alike
  float* dwk;
  float* dwv;
  float* dwproj;
  float* dwmlp;
  float* dbproj;  // [C], and the other vectors alike
  float* dbmlp;
  float* dln1s;
  float* dln1b;
  float* dln2s;
  float* dln2b;
  float* dbias;   // [H, M, N]
  float* dext;    // [2, E, C]: extra K rows, then extra V rows
  int m, c, heads, n_ext, p_windows, mp;
  float scale;
  DropArgs drop;
};

// Shared-memory layout, in bytes: Q, dO and dQ rows for the CTA's MP rows,
// K and V rows for max(NPAD, MP) keys (bf16, stride DHK + 8), dK and dV
// accumulators (fp32, stride DHK + 4), the key labels, and per warp two
// 16 x 64 bf16 tiles (dropped P and masked dS of one key chunk) that the
// row-reducing products read transposed.
struct BSmem {
  int npad, nk, qs, ds, ss;
  size_t q, k, v, dO, dq, dk, dv, lab, scr, total;
  __host__ __device__ BSmem(int n, int dhk, int mp, int warps) {
    npad = pad16(n);
    nk = npad > mp ? npad : mp;
    qs = dhk + 8;
    ds = dhk + 4;
    ss = kKeyChunk + 8;
    q = 0;
    k = align16(q + (size_t)mp * qs * 2);
    v = align16(k + (size_t)nk * qs * 2);
    dO = align16(v + (size_t)nk * qs * 2);
    dq = align16(dO + (size_t)mp * qs * 2);
    dk = align16(dq + (size_t)mp * qs * 2);
    dv = align16(dk + (size_t)nk * ds * 4);
    lab = align16(dv + (size_t)nk * ds * 4);
    scr = align16(lab + (size_t)npad * 4);
    total = align16(scr + (size_t)warps * 2 * 16 * ss * 2);
  }
};

// Logit of one (row, key) pair as the forward computes it; `mk` is the
// multiplicative mask value (1, or 0 where the labels differ).
__device__ __forceinline__ float logit(float qk, float scale,
                                       const float* bias_row, int j,
                                       bool masked, const int* slab,
                                       int lab_row, float& mk) {
  float v = qk * scale + __ldg(bias_row + j);
  mk = 1.f;
  if (masked) {
    const int lj = slab[j];
    if (!(lj == lab_row || lj < 0)) {
      v = 0.f;
      mk = 0.f;
    }
  }
  return v;
}

// out[r][col0 + c] += sum_k A(r, k) B(k, c) for r < Mr, c < n_valid, as
// fp32 atomics; A(r, k) = A[r * ars + k * aks], B(k, c) = B[k * brs +
// c * bcs].  Mr and K are multiples of 16, Nc of 8.  The CTA's warps
// share the 16 x 32 output tiles.
__device__ void tile_gemm_atomic(const bf16* A, int ars, int aks,
                                 const bf16* B, int brs, int bcs, int Mr,
                                 int Nc, int n_valid, int K, float* out,
                                 int ldo, int col0, int warp, int nwarps,
                                 int lane) {
  const int g = lane / 4, cq = lane % 4;
  const int ncl = (Nc + 31) / 32;
  for (int task = warp; task < (Mr / 16) * ncl; task += nwarps) {
    const int rt = task / ncl, c0 = (task % ncl) * 32;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const bf16* ap = A + (size_t)(rt * 16 + g) * ars + (size_t)(k0 + 2 * cq) * aks;
      const uint32_t af[4] = {ld_pair(ap, aks), ld_pair(ap + 8 * ars, aks),
                              ld_pair(ap + 8 * aks, aks),
                              ld_pair(ap + 8 * ars + 8 * aks, aks)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cc = c0 + nt * 8;
        if (cc < Nc) {
          const bf16* bp = B + (size_t)(k0 + 2 * cq) * brs + (size_t)(cc + g) * bcs;
          mma16816(acc[nt], af, ld_pair(bp, brs), ld_pair(bp + 8 * brs, brs));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rt * 16 + g + (e >= 2 ? 8 : 0);
        const int cc = c0 + nt * 8 + 2 * cq + (e & 1);
        if (c0 + nt * 8 < Nc && cc < n_valid)
          atomicAdd(out + (size_t)r * ldo + col0 + cc, acc[nt][e]);
      }
  }
}

// Q, K and V of head h for the CTA: Q of the warp's rows, K and V of the
// content rows (row-major, stride qs), then the extra K/V rows.
template <int DHK>
__device__ void load_head(const BwdArgs& a, int h, const bf16* Y, bf16* sq,
                          bf16* sk, bf16* sv, int qs, int r0, int mtiles,
                          int lane, int tid, int nthreads) {
  constexpr int DTILES = DHK / 8;
  const int M = a.m, C = a.c, E = a.n_ext;
  const int g = lane / 4, cq = lane % 4;
  float acc[2][kNT][4];
  const bf16* wh = a.wqkv + (size_t)h * 3 * DHK * C;
#pragma unroll 1
  for (int which = 0; which < 3; ++which) {
    warp_gemm(acc, Y, C, r0, mtiles, wh + (size_t)which * DHK * C, C, 0,
              DTILES, C, lane);
    bf16* dst = which == 0 ? sq : (which == 1 ? sk : sv);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < DTILES; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mt * 16 + g + hf * 8;
          const int d = nt * 8 + 2 * cq;
          if (mt < mtiles && (which == 0 || r < M))
            *reinterpret_cast<uint32_t*>(dst + r * qs + d) =
                pack2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
        }
  }
  const bf16* ek = a.ext_kv + (size_t)h * 2 * E * DHK;
  const bf16* ev = ek + (size_t)E * DHK;
  for (int t = tid; t < E * (DHK / 8); t += nthreads) {
    const int r = t / (DHK / 8), d0 = (t % (DHK / 8)) * 8;
    *reinterpret_cast<uint4*>(sk + (M + r) * qs + d0) =
        __ldg(reinterpret_cast<const uint4*>(ek + (size_t)r * DHK + d0));
    *reinterpret_cast<uint4*>(sv + (M + r) * qs + d0) =
        __ldg(reinterpret_cast<const uint4*>(ev + (size_t)r * DHK + d0));
  }
}

template <int DH>
__global__ void fused_block_bwd_kernel(const BwdArgs a) {
  constexpr int DHK = pad16(DH);
  constexpr int KSTEPS = DHK / 16;   // k-steps of QK^T and dO V^T
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's q/k/v
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.m, C = a.c, E = a.n_ext, N = a.m + a.n_ext, H = a.heads;
  const int MP = a.mp, T = blockDim.x, nwarps = T / 32;
  const BSmem L(N, DHK, MP, nwarps);
  const int QS = L.qs, DS = L.ds, SS = L.ss, NPAD = L.npad, NK = L.nk;
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L.v);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L.dO);
  bf16* sdq = reinterpret_cast<bf16*>(smem + L.dq);
  float* sdk = reinterpret_cast<float*>(smem + L.dk);
  float* sdv = reinterpret_cast<float*>(smem + L.dv);
  int* slab = reinterpret_cast<int*>(smem + L.lab);

  const int i = threadIdx.x;
  const size_t win = blockIdx.x;
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const int r0 = warp * 32;
  const int mtiles = r0 + 16 < M ? 2 : 1;
  const int dgap = a.drop.drop_cols - N;
  bf16* scrP = reinterpret_cast<bf16*>(smem + L.scr) + warp * 2 * 16 * SS;
  bf16* scrS = scrP + 16 * SS;
  const size_t MC = (size_t)MP * C;
  bf16* Y = a.ws_h + win * 6 * MC;
  bf16* AO = Y + MC;       // attention output (all heads)
  bf16* L2 = Y + 2 * MC;
  bf16* DO = Y + 3 * MC;   // dout, rows padded to MP
  bf16* DP = Y + 4 * MC;   // d(proj), after the dropout mask
  bf16* DA = Y + 5 * MC;   // d(attention output)
  float* X1 = a.ws_f + win * 4 * MC;
  float* G = X1 + MC;      // d(x1)
  float* DL = X1 + 2 * MC; // d(LN2 output)
  float* DY = X1 + 3 * MC; // d(LN1 output)
  float* ST = a.ws_s + win * MP * 4;
  float* SM = a.ws_sm + win * H * MP * 2;
  const bf16* xw = a.x + win * M * C;
  const bf16* dw = a.dout + win * M * C;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const bool masked = a.labels != nullptr;
  float acc[2][kNT][4];

  // ---- 0: LN1 of the thread's row (as the forward), dout copy ----
  if (i < M) {
    const bf16* xr = xw + (size_t)i * C;
    float sum = 0.f, sq2 = 0.f;
    for (int c = 0; c < C; c += 2) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
      sum += v.x + v.y;
      sq2 += v.x * v.x + v.y * v.y;
    }
    const float mu = sum / C;
    const float rstd = rsqrtf(sq2 / C - mu * mu + kEps);
    for (int c = 0; c < C; c += 2) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
      *reinterpret_cast<uint32_t*>(Y + i * C + c) = pack2(
          (v.x - mu) * rstd * __ldg(a.ln1_s + c) + __ldg(a.ln1_b + c),
          (v.y - mu) * rstd * __ldg(a.ln1_s + c + 1) + __ldg(a.ln1_b + c + 1));
      *reinterpret_cast<uint32_t*>(DO + i * C + c) =
          *reinterpret_cast<const uint32_t*>(dw + (size_t)i * C + c);
    }
    ST[i * 4] = mu;
    ST[i * 4 + 1] = rstd;
  } else {
    // Padded rows stay zero in every bf16 row buffer: the products that
    // reduce over rows read them.
    for (int c = 0; c < C; ++c)
      Y[i * C + c] = AO[i * C + c] = L2[i * C + c] = DO[i * C + c] =
          DP[i * C + c] = DA[i * C + c] = zero;
  }
  for (int c = 0; c < C; ++c) DY[i * C + c] = 0.f;
  // Key rows past N are zero in K and V for every head.
  for (int t = N + i; t < NK; t += T)
    for (int d = 0; d < DHK; ++d) sk[t * QS + d] = sv[t * QS + d] = zero;
  if (masked) {
    const int* lab = a.labels + (size_t)(win % a.p_windows) * N;
    for (int t = i; t < N; t += T) slab[t] = __ldg(lab + t);
  }

  // ---- A: attention forward recompute, all heads -> AO, softmax stats ----
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // Y and pads written; the previous head's K/V read
    load_head<DHK>(a, h, Y, sq, sk, sv, QS, r0, mtiles, lane, i, T);
    __syncthreads();
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      const int t0 = r0 + mt * 16;
      uint32_t qa[KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const bf16* q0 = sq + (t0 + g) * QS + ks * 16 + 2 * cq;
        qa[ks][0] = lds32(q0);
        qa[ks][1] = lds32(q0 + 8 * QS);
        qa[ks][2] = lds32(q0 + 8);
        qa[ks][3] = lds32(q0 + 8 * QS + 8);
      }
      const int ra = t0 + g, rb = t0 + g + 8;
      const bool va = ra < M, vb = rb < M;
      const int lab_a = (masked && va) ? slab[ra] : 0;
      const int lab_b = (masked && vb) ? slab[rb] : 0;
      const float* bias_a = a.bias + ((size_t)h * M + (va ? ra : 0)) * N;
      const float* bias_b = a.bias + ((size_t)h * M + (vb ? rb : 0)) * N;
      const uint32_t drow_a = (((uint32_t)win * H + h) * M + ra) * (uint32_t)a.drop.drop_cols;
      const uint32_t drow_b = (((uint32_t)win * H + h) * M + rb) * (uint32_t)a.drop.drop_cols;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float o[DTILES][4];
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll 1
      for (int j0 = 0; j0 < NPAD; j0 += kKeyChunk) {
        const int ntiles = min(kKeyChunk, NPAD - j0) / 8;  // even
        float s[kKeyChunk / 8][4];
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
          if (nt < ntiles) {
            float sc[4] = {0.f, 0.f, 0.f, 0.f};
            const bf16* k0 = sk + (j0 + nt * 8 + g) * QS + 2 * cq;
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks)
              mma16816(sc, qa[ks], lds32(k0 + ks * 16), lds32(k0 + ks * 16 + 8));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = j0 + nt * 8 + 2 * cq + (e & 1);
              float mk;
              if (j < N)
                s[nt][e] = logit(sc[e], a.scale, e < 2 ? bias_a : bias_b, j,
                                 masked, slab, e < 2 ? lab_a : lab_b, mk);
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
            if (a.drop.thr_a) {
#pragma unroll
              for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int j = j0 + kk * 16 + u * 8 + 2 * cq + (e & 1);
                  p[u][e] *= keep_value(a.drop.seed_a,
                                        (e < 2 ? drow_a : drow_b) + drop_col(j, M, dgap),
                                        a.drop.thr_a, a.drop.keep_a);
                }
            }
            const uint32_t pa[4] = {pack2(p[0][0], p[0][1]), pack2(p[0][2], p[0][3]),
                                    pack2(p[1][0], p[1][1]), pack2(p[1][2], p[1][3])};
            const int jk = j0 + kk * 16 + 2 * cq;
#pragma unroll
            for (int dt = 0; dt < DTILES; ++dt) {
              const bf16* v0 = sv + jk * QS + dt * 8 + g;
              mma16816(o[dt], pa, ld_pair(v0, QS), ld_pair(v0 + 8 * QS, QS));
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
        const int d = dt * 8 + 2 * cq;   // DH is even: d < DH => d + 1 < DH
        if (d < DH) {
          if (va)
            *reinterpret_cast<uint32_t*>(AO + ra * C + h * DH + d) =
                pack2(o[dt][0] * inv_a, o[dt][1] * inv_a);
          if (vb)
            *reinterpret_cast<uint32_t*>(AO + rb * C + h * DH + d) =
                pack2(o[dt][2] * inv_b, o[dt][3] * inv_b);
        }
      }
      if (cq == 0) {
        if (va) {
          SM[(h * MP + ra) * 2] = m_a;
          SM[(h * MP + ra) * 2 + 1] = l_a;
        }
        if (vb) {
          SM[(h * MP + rb) * 2] = m_b;
          SM[(h * MP + rb) * 2 + 1] = l_b;
        }
      }
    }
  }
  __syncthreads();

  // ---- B: x1 = x + (AO Wproj^T + bproj) * keep_p, LN2 (warp's rows) ----
  for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
    const int ntiles = min(kNT, (C - n0) / 8);
    warp_gemm(acc, AO, C, r0, mtiles, a.wproj, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < mtiles && nt < ntiles && r < M) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xw + (size_t)r * C + col));
            float p0 = acc[mt][nt][2 * hf] + __ldg(a.bproj + col);
            float p1 = acc[mt][nt][2 * hf + 1] + __ldg(a.bproj + col + 1);
            if (a.drop.thr_p) {
              const uint32_t base = ((uint32_t)win * M + r) * C + col;
              p0 *= keep_value(a.drop.seed_p, base, a.drop.thr_p, a.drop.keep_p);
              p1 *= keep_value(a.drop.seed_p, base + 1, a.drop.thr_p, a.drop.keep_p);
            }
            X1[r * C + col] = xv.x + p0;
            X1[r * C + col + 1] = xv.y + p1;
          }
        }
  }
  __syncwarp();
  for (int rr = 0; rr < 32; ++rr) {
    const int r = r0 + rr;
    if (r >= M) break;
    float sum = 0.f, sq2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = X1[r * C + c];
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
      L2[r * C + c] = __float2bfloat16_rn(
          (X1[r * C + c] - mu) * rstd * __ldg(a.ln2_s + c) + __ldg(a.ln2_b + c));
    if (lane == 0) {
      ST[r * 4 + 2] = mu;
      ST[r * 4 + 3] = rstd;
    }
  }
  __syncwarp();

  // ---- C: MLP and LN2 backward (warp's rows) ----
  // dl2 = dout Wmlp^T  (B operand: Wmlp in (in, out) layout)
  for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
    const int ntiles = min(kNT, (C - n0) / 8);
    warp_gemm(acc, DO, C, r0, mtiles, a.wmlp_io, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < mtiles && nt < ntiles && r < M) {
            DL[r * C + col] = acc[mt][nt][2 * hf];
            DL[r * C + col + 1] = acc[mt][nt][2 * hf + 1];
          }
        }
  }
  __syncwarp();
  for (int rr = 0; rr < 32; ++rr) {
    const int r = r0 + rr;
    if (r >= M) break;
    const float mu = ST[r * 4 + 2], rstd = ST[r * 4 + 3];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = DL[r * C + c] * __ldg(a.ln2_s + c);
      s1 += dxh;
      s2 += dxh * (X1[r * C + c] - mu) * rstd;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    s1 /= C;
    s2 /= C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (X1[r * C + c] - mu) * rstd;
      const float dxh = DL[r * C + c] * __ldg(a.ln2_s + c);
      const float gv = __bfloat162float(DO[r * C + c]) + (dxh - s1 - xh * s2) * rstd;
      G[r * C + c] = gv;
      float dp = gv;
      if (a.drop.thr_p)
        dp *= keep_value(a.drop.seed_p, ((uint32_t)win * M + r) * C + c,
                         a.drop.thr_p, a.drop.keep_p);
      DP[r * C + c] = __float2bfloat16_rn(dp);
    }
  }
  __syncthreads();
  // Column sums of this window: LN2 scale/bias, MLP bias, projection bias.
  for (int c = i; c < C; c += T) {
    float s_ls = 0.f, s_lb = 0.f, s_bm = 0.f, s_bp = 0.f;
    for (int r = 0; r < M; ++r) {
      const float dl = DL[r * C + c];
      s_ls += dl * (X1[r * C + c] - ST[r * 4 + 2]) * ST[r * 4 + 3];
      s_lb += dl;
      s_bm += __bfloat162float(DO[r * C + c]);
      float dp = G[r * C + c];
      if (a.drop.thr_p)
        dp *= keep_value(a.drop.seed_p, ((uint32_t)win * M + r) * C + c,
                         a.drop.thr_p, a.drop.keep_p);
      s_bp += dp;
    }
    atomicAdd(a.dln2s + c, s_ls);
    atomicAdd(a.dln2b + c, s_lb);
    atomicAdd(a.dbmlp + c, s_bm);
    atomicAdd(a.dbproj + c, s_bp);
  }
  // dWmlp[i][o] += sum_r L2[r][i] dout[r][o]; dWproj alike with AO, DP.
  tile_gemm_atomic(L2, 1, C, DO, C, 1, C, C, C, MP, a.dwmlp, C, 0, warp,
                   nwarps, lane);
  tile_gemm_atomic(AO, 1, C, DP, C, 1, C, C, C, MP, a.dwproj, C, 0, warp,
                   nwarps, lane);
  // ---- D: d(attention output) = dproj Wproj^T (warp's rows) ----
  for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
    const int ntiles = min(kNT, (C - n0) / 8);
    warp_gemm(acc, DP, C, r0, mtiles, a.wproj_io, C, n0, ntiles, C, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
          if (mt < mtiles && nt < ntiles && r < M)
            *reinterpret_cast<uint32_t*>(DA + r * C + col) =
                pack2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
        }
  }

  // ---- E: attention backward, one head at a time ----
  const float scale = a.scale;
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // DA complete; the previous head's tiles read
    load_head<DHK>(a, h, Y, sq, sk, sv, QS, r0, mtiles, lane, i, T);
    for (int t = i; t < MP * DHK; t += T) {
      const int r = t / DHK, d = t % DHK;
      sdo[r * QS + d] = d < DH ? DA[r * C + h * DH + d] : zero;
      sdq[r * QS + d] = zero;
    }
    for (int t = i; t < NK * DHK; t += T) {
      const int r = t / DHK, d = t % DHK;
      sdk[r * DS + d] = 0.f;
      sdv[r * DS + d] = 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      const int t0 = r0 + mt * 16;
      uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const bf16* q0 = sq + (t0 + g) * QS + ks * 16 + 2 * cq;
        qa[ks][0] = lds32(q0);
        qa[ks][1] = lds32(q0 + 8 * QS);
        qa[ks][2] = lds32(q0 + 8);
        qa[ks][3] = lds32(q0 + 8 * QS + 8);
        const bf16* o0 = sdo + (t0 + g) * QS + ks * 16 + 2 * cq;
        da[ks][0] = lds32(o0);
        da[ks][1] = lds32(o0 + 8 * QS);
        da[ks][2] = lds32(o0 + 8);
        da[ks][3] = lds32(o0 + 8 * QS + 8);
      }
      const int ra = t0 + g, rb = t0 + g + 8;
      const bool va = ra < M, vb = rb < M;
      const int lab_a = (masked && va) ? slab[ra] : 0;
      const int lab_b = (masked && vb) ? slab[rb] : 0;
      const float* bias_a = a.bias + ((size_t)h * M + (va ? ra : 0)) * N;
      const float* bias_b = a.bias + ((size_t)h * M + (vb ? rb : 0)) * N;
      const uint32_t drow_a = (((uint32_t)win * H + h) * M + ra) * (uint32_t)a.drop.drop_cols;
      const uint32_t drow_b = (((uint32_t)win * H + h) * M + rb) * (uint32_t)a.drop.drop_cols;
      const float m_a = va ? SM[(h * MP + ra) * 2] : 0.f;
      const float il_a = va ? 1.f / SM[(h * MP + ra) * 2 + 1] : 0.f;
      const float m_b = vb ? SM[(h * MP + rb) * 2] : 0.f;
      const float il_b = vb ? 1.f / SM[(h * MP + rb) * 2 + 1] : 0.f;
      // rowsum(dO o O) = rowsum(dP o P): O is the stored attention output.
      float D_a = 0.f, D_b = 0.f;
      for (int d = cq; d < DH; d += 4) {
        D_a += __bfloat162float(sdo[ra * QS + d]) * __bfloat162float(AO[ra * C + h * DH + d]);
        D_b += __bfloat162float(sdo[rb * QS + d]) * __bfloat162float(AO[rb * C + h * DH + d]);
      }
      D_a += __shfl_xor_sync(0xffffffffu, D_a, 1);
      D_a += __shfl_xor_sync(0xffffffffu, D_a, 2);
      D_b += __shfl_xor_sync(0xffffffffu, D_b, 1);
      D_b += __shfl_xor_sync(0xffffffffu, D_b, 2);
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
            const bf16* k0 = sk + (j0 + nt * 8 + g) * QS + 2 * cq;
            const bf16* v0 = sv + (j0 + nt * 8 + g) * QS + 2 * cq;
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              mma16816(sc, qa[ks], lds32(k0 + ks * 16), lds32(k0 + ks * 16 + 8));
              mma16816(dp, da[ks], lds32(v0 + ks * 16), lds32(v0 + ks * 16 + 8));
            }
            float pd[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = j0 + nt * 8 + 2 * cq + (e & 1);
              const bool top = e < 2;
              pd[e] = 0.f;
              if (j < N && (top ? va : vb)) {
                float mk;
                const float s = logit(sc[e], scale, top ? bias_a : bias_b, j,
                                      masked, slab, top ? lab_a : lab_b, mk);
                const float p = __expf(s - (top ? m_a : m_b)) * (top ? il_a : il_b);
                float kp = 1.f;
                if (a.drop.thr_a)
                  kp = keep_value(a.drop.seed_a,
                                  (top ? drow_a : drow_b) + drop_col(j, M, dgap),
                                  a.drop.thr_a, a.drop.keep_a);
                pd[e] = p * kp;
                ds[nt][e] = p * (dp[e] * kp - (top ? D_a : D_b)) * mk;
                atomicAdd(a.dbias + ((size_t)h * M + (top ? ra : rb)) * N + j,
                          ds[nt][e]);
              }
            }
            const int cc = nt * 8 + 2 * cq;
            *reinterpret_cast<uint32_t*>(scrP + g * SS + cc) = pack2(pd[0], pd[1]);
            *reinterpret_cast<uint32_t*>(scrP + (g + 8) * SS + cc) = pack2(pd[2], pd[3]);
            *reinterpret_cast<uint32_t*>(scrS + g * SS + cc) = pack2(ds[nt][0], ds[nt][1]);
            *reinterpret_cast<uint32_t*>(scrS + (g + 8) * SS + cc) = pack2(ds[nt][2], ds[nt][3]);
          }
        }
        // dQ += dS K (A operand straight from the registers).
#pragma unroll
        for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
          if (2 * kk < ntiles) {
            const uint32_t pa[4] = {pack2(ds[2 * kk][0], ds[2 * kk][1]),
                                    pack2(ds[2 * kk][2], ds[2 * kk][3]),
                                    pack2(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                                    pack2(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
            const int jk = j0 + kk * 16 + 2 * cq;
#pragma unroll
            for (int dt = 0; dt < DTILES; ++dt) {
              const bf16* kp0 = sk + jk * QS + dt * 8 + g;
              mma16816(dq[dt], pa, ld_pair(kp0, QS), ld_pair(kp0 + 8 * QS, QS));
            }
          }
        }
        __syncwarp();
        // dV += P^T dO and dK += scale dS^T Q over the tile's 16 rows.
#pragma unroll 1
        for (int kt = 0; kt < ntiles / 2; ++kt) {
          const bf16* pp = scrP + 2 * cq * SS + kt * 16 + g;
          const bf16* sp = scrS + 2 * cq * SS + kt * 16 + g;
          const uint32_t ap[4] = {ld_pair(pp, SS), ld_pair(pp + 8, SS),
                                  ld_pair(pp + 8 * SS, SS), ld_pair(pp + 8 * SS + 8, SS)};
          const uint32_t as[4] = {ld_pair(sp, SS), ld_pair(sp + 8, SS),
                                  ld_pair(sp + 8 * SS, SS), ld_pair(sp + 8 * SS + 8, SS)};
          const int jr = j0 + kt * 16 + g;
#pragma unroll
          for (int dt = 0; dt < DTILES; ++dt) {
            const bf16* ob = sdo + (t0 + 2 * cq) * QS + dt * 8 + g;
            const bf16* qb = sq + (t0 + 2 * cq) * QS + dt * 8 + g;
            float av[4] = {0.f, 0.f, 0.f, 0.f}, ak[4] = {0.f, 0.f, 0.f, 0.f};
            mma16816(av, ap, ld_pair(ob, QS), ld_pair(ob + 8 * QS, QS));
            mma16816(ak, as, ld_pair(qb, QS), ld_pair(qb + 8 * QS, QS));
            const int d = dt * 8 + 2 * cq;
            atomicAdd(sdv + jr * DS + d, av[0]);
            atomicAdd(sdv + jr * DS + d + 1, av[1]);
            atomicAdd(sdv + (jr + 8) * DS + d, av[2]);
            atomicAdd(sdv + (jr + 8) * DS + d + 1, av[3]);
            atomicAdd(sdk + jr * DS + d, ak[0] * scale);
            atomicAdd(sdk + jr * DS + d + 1, ak[1] * scale);
            atomicAdd(sdk + (jr + 8) * DS + d, ak[2] * scale);
            atomicAdd(sdk + (jr + 8) * DS + d + 1, ak[3] * scale);
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const int d = dt * 8 + 2 * cq;
        if (va)
          *reinterpret_cast<uint32_t*>(sdq + ra * QS + d) =
              pack2(dq[dt][0] * scale, dq[dt][1] * scale);
        if (vb)
          *reinterpret_cast<uint32_t*>(sdq + rb * QS + d) =
              pack2(dq[dt][2] * scale, dq[dt][3] * scale);
      }
    }
    __syncthreads();  // dK, dV, dQ of head h complete
    for (int t = i; t < E * DH; t += T) {
      const int e = t / DH, d = t % DH;
      atomicAdd(a.dext + (size_t)e * C + h * DH + d, sdk[(M + e) * DS + d]);
      atomicAdd(a.dext + (size_t)(E + e) * C + h * DH + d, sdv[(M + e) * DS + d]);
    }
    // Content rows of dK and dV as bf16 operands (over K and V).
    for (int t = i; t < NK * DHK; t += T) {
      const int r = t / DHK, d = t % DHK;
      sk[r * QS + d] = r < M ? __float2bfloat16_rn(sdk[r * DS + d]) : zero;
      sv[r * QS + d] = r < M ? __float2bfloat16_rn(sdv[r * DS + d]) : zero;
    }
    __syncthreads();
    // dY += dQ Wq_h^T + dK Wk_h^T + dV Wv_h^T (warp's rows).
    const bf16* wt = a.wqkv_t + (size_t)h * 3 * C * DHK;
    for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
      const int ntiles = min(kNT, (C - n0) / 8);
      zero_acc(acc);
      warp_gemm_acc(acc, sdq, QS, r0, mtiles, wt, DHK, n0, ntiles, DHK, lane);
      warp_gemm_acc(acc, sk, QS, r0, mtiles, wt + (size_t)C * DHK, DHK, n0, ntiles, DHK, lane);
      warp_gemm_acc(acc, sv, QS, r0, mtiles, wt + (size_t)2 * C * DHK, DHK, n0, ntiles, DHK, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + mt * 16 + g + hf * 8, col = n0 + nt * 8 + 2 * cq;
            if (mt < mtiles && nt < ntiles && r < M) {
              DY[r * C + col] += acc[mt][nt][2 * hf];
              DY[r * C + col + 1] += acc[mt][nt][2 * hf + 1];
            }
          }
    }
    // Head h's columns of dWq, dWk, dWv: Y^T dQ, Y^T dK, Y^T dV.
    tile_gemm_atomic(Y, 1, C, sdq, QS, 1, C, DHK, DH, MP, a.dwq, C, h * DH,
                     warp, nwarps, lane);
    tile_gemm_atomic(Y, 1, C, sk, QS, 1, C, DHK, DH, MP, a.dwk, C, h * DH,
                     warp, nwarps, lane);
    tile_gemm_atomic(Y, 1, C, sv, QS, 1, C, DHK, DH, MP, a.dwv, C, h * DH,
                     warp, nwarps, lane);
  }
  __syncthreads();

  // ---- F: LN1 backward and the residual (warp's rows) ----
  bf16* dxw = a.dx + win * M * C;
  for (int rr = 0; rr < 32; ++rr) {
    const int r = r0 + rr;
    if (r >= M) break;
    const float mu = ST[r * 4], rstd = ST[r * 4 + 1];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = DY[r * C + c] * __ldg(a.ln1_s + c);
      s1 += dxh;
      s2 += dxh * (__bfloat162float(xw[(size_t)r * C + c]) - mu) * rstd;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    s1 /= C;
    s2 /= C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (__bfloat162float(xw[(size_t)r * C + c]) - mu) * rstd;
      const float dxh = DY[r * C + c] * __ldg(a.ln1_s + c);
      dxw[(size_t)r * C + c] =
          __float2bfloat16_rn(G[r * C + c] + (dxh - s1 - xh * s2) * rstd);
    }
  }
  for (int c = i; c < C; c += T) {
    float s_ls = 0.f, s_lb = 0.f;
    for (int r = 0; r < M; ++r) {
      const float dy = DY[r * C + c];
      s_ls += dy * (__bfloat162float(xw[(size_t)r * C + c]) - ST[r * 4]) * ST[r * 4 + 1];
      s_lb += dy;
    }
    atomicAdd(a.dln1s + c, s_ls);
    atomicAdd(a.dln1b + c, s_lb);
  }
}

template <int DH>
cudaError_t launch_bwd(const BwdArgs& a, int bp, cudaStream_t stream) {
  const int threads = a.mp;
  const BSmem L(a.m + a.n_ext, pad16(DH), a.mp, threads / 32);
  if (L.total > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return err;
  fused_block_bwd_kernel<DH><<<bp, threads, L.total, stream>>>(a);
  return cudaGetLastError();
}



}  // namespace

extern "C" cudaError_t mivp_fused_block_bwd(
    const void* x, const void* dout, void* dx, const void* wqkv,
    const void* wqkv_t, const void* ext_kv, const void* bias,
    const void* labels, const void* ln1_s, const void* ln1_b,
    const void* wproj, const void* wproj_io, const void* bproj,
    const void* ln2_s, const void* ln2_b, const void* wmlp,
    const void* wmlp_io, const void* bmlp, void* ws_h, void* ws_f,
    void* ws_s, void* ws_sm, void* dwq, void* dwk, void* dwv, void* dwproj,
    void* dwmlp, void* dbproj, void* dbmlp, void* dln1s, void* dln1b,
    void* dln2s, void* dln2b, void* dbias, void* dext, int bp, int m,
    int c, int heads, int dh, int n_ext, int p_windows, float scale,
    unsigned seed_a, unsigned seed_p, unsigned thr_a, unsigned thr_p,
    float keep_a, float keep_p, int drop_cols, void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      (labels != nullptr && p_windows < 1) || drop_cols < m + n_ext)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.dout = static_cast<const bf16*>(dout);
  a.dx = static_cast<bf16*>(dx);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.wqkv_t = static_cast<const bf16*>(wqkv_t);
  a.ext_kv = static_cast<const bf16*>(ext_kv);
  a.bias = static_cast<const float*>(bias);
  a.labels = static_cast<const int*>(labels);
  a.ln1_s = static_cast<const float*>(ln1_s);
  a.ln1_b = static_cast<const float*>(ln1_b);
  a.wproj = static_cast<const bf16*>(wproj);
  a.wproj_io = static_cast<const bf16*>(wproj_io);
  a.bproj = static_cast<const float*>(bproj);
  a.ln2_s = static_cast<const float*>(ln2_s);
  a.ln2_b = static_cast<const float*>(ln2_b);
  a.wmlp = static_cast<const bf16*>(wmlp);
  a.wmlp_io = static_cast<const bf16*>(wmlp_io);
  a.bmlp = static_cast<const float*>(bmlp);
  a.ws_h = static_cast<bf16*>(ws_h);
  a.ws_f = static_cast<float*>(ws_f);
  a.ws_s = static_cast<float*>(ws_s);
  a.ws_sm = static_cast<float*>(ws_sm);
  a.dwq = static_cast<float*>(dwq);
  a.dwk = static_cast<float*>(dwk);
  a.dwv = static_cast<float*>(dwv);
  a.dwproj = static_cast<float*>(dwproj);
  a.dwmlp = static_cast<float*>(dwmlp);
  a.dbproj = static_cast<float*>(dbproj);
  a.dbmlp = static_cast<float*>(dbmlp);
  a.dln1s = static_cast<float*>(dln1s);
  a.dln1b = static_cast<float*>(dln1b);
  a.dln2s = static_cast<float*>(dln2s);
  a.dln2b = static_cast<float*>(dln2b);
  a.dbias = static_cast<float*>(dbias);
  a.dext = static_cast<float*>(dext);
  a.m = m;
  a.c = c;
  a.heads = heads;
  a.n_ext = n_ext;
  a.p_windows = p_windows;
  a.mp = (m + 31) / 32 * 32;
  a.scale = scale;
  a.drop = DropArgs{seed_a, seed_p, thr_a, thr_p, keep_a, keep_p, drop_cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch_bwd<8>(a, bp, s);
    case 12: return launch_bwd<12>(a, bp, s);
    case 16: return launch_bwd<16>(a, bp, s);
    case 24: return launch_bwd<24>(a, bp, s);
    case 32: return launch_bwd<32>(a, bp, s);
    case 48: return launch_bwd<48>(a, bp, s);
    case 64: return launch_bwd<64>(a, bp, s);
    default: return cudaErrorInvalidValue;
  }
}
