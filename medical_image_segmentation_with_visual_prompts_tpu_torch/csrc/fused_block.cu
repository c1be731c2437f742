// Fused Swin transformer block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_kernel` of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/fused_block.py,
// launched by `_forward`).  For one window per CTA it computes
//
//   y   = LN1(x)                               fp32 statistics, eps 1e-6
//   q   = y Wq            (content rows only)  bf16 operands, fp32 sums
//   k|v = [y Wk | y Wv ; extra K/V rows]       extra rows: fold row and
//                                              prompt tokens, projected
//                                              by the wrapper
//   s   = (q.k * scale + bias[h, i, j]) * (lab_i == lab_j || lab_j < 0)
//   a   = (softmax(s) * keep_a) v              max-subtracted, fp32 stats
//   x1  = x + (a Wproj + bproj) * keep_p
//   out = x1 + LN2(x1) Wmlp + bmlp             stored as bf16
//
// keep_a and keep_p are the counter-based dropout masks of ops/prng.py
// (fused_block_common.cuh), hashed from the element index as the JAX
// kernel hashes it; with zero rates the dropout code never runs.
//
// What bounds it on the H100: the matrix products (five C-wide GEMMs per
// row plus heads x N x head_dim twice for attention) and how many windows
// are in flight per SM.  Design: one CTA per window; each warp owns 32
// rows (two 16-row tiles) and runs every product of those rows on tensor
// cores with mma.sync m16n8k16 (bf16 operands, fp32 sums).  The A operand
// comes from shared memory (LN1 output, attention output, LN2 output, all
// row-major bf16), the B operand from the weights, stored transposed
// ([out, in]) in device memory where every CTA finds them in L1/L2.  Each
// head's q/k/v width is padded to a multiple of 16 (the k-step), which
// answers the head-dim-12 question by padding rather than head packing.
// Attention keeps an online max-subtracted softmax over 64-key chunks in
// registers and feeds P to P.V as bf16 (attend_tile in
// fused_block_common.cuh, shared with window_attention.cu).  Row strides are padded so the
// fragment loads are free of bank conflicts.

#include "fused_block_common.cuh"

namespace {

struct BlockArgs {
  const bf16* x;        // [BP, M, C]
  bf16* out;            // [BP, M, C]
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
};

// Shared-memory layout, in bytes.  Region 1 holds LN1(x), the head's Q,
// K and V^T tiles and the key labels during the projections and
// attention, and x1 (fp32) afterwards; region 2 holds the attention
// output, then LN2(x1).  All row-major over the CTA's rows (mp = rows
// rounded up to the warps' 32).  Strides: bf16 rows of C + 8, Q/K rows of
// dhk + 8, V^T rows of npad + 8, x1 rows of C + 4 floats.
struct Smem {
  int npad, mp, cs, qks, vts, xs;
  size_t y, q, k, vt, lab, x1, a, total;
  __host__ __device__ Smem(int m, int c, int n, int dhk, int threads) {
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
    a = attn_end > x1_end ? attn_end : x1_end;
    total = a + align16((size_t)mp * cs * 2);
  }
};

// DROP: the dropout code is compiled in only for calls with a nonzero
// rate.  MAXT: the largest CTA the instantiation takes.  At 256 threads
// (M <= 256, the flagship's windows) the compiler is held to 128
// registers so that two CTAs fit on an SM: at 130 registers one CTA of
// the 64x64x4 stages runs per SM and the launch takes twice as long.
template <int DH, bool DROP, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT <= 256 ? 2 : 1)
    fused_swin_block_kernel(const BlockArgs a) {
  constexpr int DHK = pad16(DH);
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's q/k/v and P.V
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.m, C = a.c, E = a.n_ext, N = a.m + a.n_ext;
  const Smem L(M, C, N, DHK, blockDim.x);
  const int CS = L.cs, QS = L.qks, VS = L.vts, XS = L.xs, NPAD = L.npad;
  bf16* sy = reinterpret_cast<bf16*>(smem + L.y);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* svt = reinterpret_cast<bf16*>(smem + L.vt);
  int* slab = reinterpret_cast<int*>(smem + L.lab);
  float* sx1 = reinterpret_cast<float*>(smem + L.x1);
  bf16* sa = reinterpret_cast<bf16*>(smem + L.a);

  const int i = threadIdx.x;
  const size_t win = blockIdx.x;
  const bf16* xw = a.x + win * M * C;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const int r0 = warp * 32;                       // the warp's first row
  const int dgap = a.drop.drop_cols - N;          // JAX alignment columns
  const int mtiles = r0 + 16 < M ? 2 : 1;         // its 16-row tiles

  // ---- LN1 of the thread's row -> y (bf16, row-major) ----
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
  const bool masked = a.labels != nullptr;
  if (masked) {
    const int* lab = a.labels + (size_t)(win % a.p_windows) * N;
    for (int t = i; t < N; t += blockDim.x) slab[t] = __ldg(lab + t);
  }

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
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xw + (size_t)r * C + col));
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
  bf16* ow = a.out + win * M * C;
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
            *reinterpret_cast<uint32_t*>(ow + (size_t)r * C + col) = pack2(
                sx1[r * XS + col] + (acc[mt][nt][2 * hf] + __ldg(a.bmlp + col)),
                sx1[r * XS + col + 1] + (acc[mt][nt][2 * hf + 1] + __ldg(a.bmlp + col + 1)));
        }
  }
}

template <int DH, bool DROP, int MAXT>
cudaError_t launch_as(const BlockArgs& a, int bp, cudaStream_t stream) {
  const int threads = (a.m + 31) / 32 * 32;
  const Smem L(a.m, a.c, a.m + a.n_ext, pad16(DH), threads);
  if (L.total > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_swin_block_kernel<DH, DROP, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  fused_swin_block_kernel<DH, DROP, MAXT><<<bp, threads, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const BlockArgs& a, int bp, cudaStream_t stream) {
  const bool drop = a.drop.thr_a || a.drop.thr_p;
  if (a.m <= 256)
    return drop ? launch_as<DH, true, 256>(a, bp, stream)
                : launch_as<DH, false, 256>(a, bp, stream);
  return drop ? launch_as<DH, true, 1024>(a, bp, stream)
              : launch_as<DH, false, 1024>(a, bp, stream);
}

}  // namespace

extern "C" cudaError_t mivp_fused_swin_block(
    const void* x, void* out, const void* wqkv, const void* ext_kv,
    const void* bias, const void* labels, const void* ln1_s,
    const void* ln1_b, const void* wproj, const void* bproj,
    const void* ln2_s, const void* ln2_b, const void* wmlp, const void* bmlp,
    int bp, int m, int c, int heads, int dh, int n_ext, int p_windows,
    float scale, unsigned seed_a, unsigned seed_p, unsigned thr_a,
    unsigned thr_p, float keep_a, float keep_p, int drop_cols,
    void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      (labels != nullptr && p_windows < 1) || drop_cols < m + n_ext)
    return cudaErrorInvalidValue;
  BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.ext_kv = static_cast<const bf16*>(ext_kv);
  a.bias = static_cast<const float*>(bias);
  a.labels = static_cast<const int*>(labels);
  a.ln1_s = static_cast<const float*>(ln1_s);
  a.ln1_b = static_cast<const float*>(ln1_b);
  a.wproj = static_cast<const bf16*>(wproj);
  a.bproj = static_cast<const float*>(bproj);
  a.ln2_s = static_cast<const float*>(ln2_s);
  a.ln2_b = static_cast<const float*>(ln2_b);
  a.wmlp = static_cast<const bf16*>(wmlp);
  a.bmlp = static_cast<const float*>(bmlp);
  a.m = m;
  a.c = c;
  a.heads = heads;
  a.n_ext = n_ext;
  a.p_windows = p_windows;
  a.scale = scale;
  a.drop = DropArgs{seed_a, seed_p, thr_a, thr_p, keep_a, keep_p, drop_cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch<8>(a, bp, s);
    case 12: return launch<12>(a, bp, s);
    case 16: return launch<16>(a, bp, s);
    case 24: return launch<24>(a, bp, s);
    case 32: return launch<32>(a, bp, s);
    case 48: return launch<48>(a, bp, s);
    case 64: return launch<64>(a, bp, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mivp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
