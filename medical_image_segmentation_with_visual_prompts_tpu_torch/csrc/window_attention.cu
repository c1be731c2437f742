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
// dim 12-48) the tensor-core work is a few MFLOP per (window, head) and
// the fp32 bias rows are the largest read (320 KB per head, from L2), so
// the time is latency: how many (window, head) tiles are in flight.
// Design: one CTA of 8 warps per (window, head) -- the grid is BP x H, so
// even the 108-window stages launch 432-1728 CTAs on 132 SMs, where one CTA
// per window would leave SMs idle and run the heads in turn.  B6 stages
// the window's y rows in shared memory and projects only head h's q/k/v
// columns (y @ W[:, h*Dh:(h+1)*Dh]: no extra arithmetic; y is re-read
// from L2 once per head).  Each warp owns 32-row groups of the
// projections and of the queries; the attention of a 16-row tile is B1's
// (attend_tile in fused_block_common.cuh: mma.sync m16n8k16, the
// label-equality mask, an online max-subtracted fp32 softmax over 64-key
// chunks).  Each output element is written once.
//
// y, q, k, v and the output are fp32 or bf16 (one run-time flag, the
// inputs' dtype, which the output takes as the JAX kernels' out_shape
// does); they are rounded to bf16 where the JAX kernels round them: y, k
// and v on the load, q after the fp32 scale.

#include "fused_block_common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRowStep = kThreads;  // rows per pass of all warps (32 each)

struct AttnArgs {
  const void* y;        // B6: [BP, N, C] LN1 output, content rows first
  const bf16* wqkv;     // B6: [H, 3, DHK, C] Wq|Wk|Wv of head h, transposed
  const void* q;        // B7/B8: [BP, M, C]
  const void* k;        // B7/B8: [BP, N, C]
  const void* v;        // B7/B8: [BP, N, C]
  const float* bias;    // [H, M, N]
  const int* labels;    // [P, N] shift-region labels, or null
  void* out;            // [BP, M, C]
  int m, n, c, p_windows;
  float scale;
  bool f32;             // y, q, k, v and out are fp32 (else bf16)
};

// Shared-memory layout, in bytes: y (B6 only; rows N rounded up to the
// warps' 32, zero past N), Q [mp][dhk + 8], K [npad][dhk + 8],
// V^T [dhk][npad + 8] (bf16) and the key labels [npad] (int32).  Row
// strides are padded by 8 elements so the fragment loads are free of bank
// conflicts.  Per CTA at the flagship shapes (M 256, N 320):
//   B6, C 48, dh 12:  y 35,840 + Q 12,288 + K 15,360 + V^T 10,496
//                     + labels 1,280 = 75,264 B
//   B6, C 96, dh 12:  y 66,560 + the same  = 105,984 B
//   B6, C 96, dh 24:  y 66,560 + Q 20,480 + K 25,600 + V^T 20,992
//                     + labels 1,280 = 134,912 B (one CTA per SM)
//   B8, C 192, dh 12: Q 12,288 + K 15,360 + V^T 10,496 + 1,280 = 39,424 B
//   B8, C 192, dh 48: Q 28,672 + K 35,840 + V^T 31,488 + 1,280 = 97,280 B
// Registers are held to 128 (__launch_bounds__(256, 2)), so at most two
// CTAs share an SM whatever the shared memory.
struct Smem {
  int npad, mp, yrows, cs, qks, vts;
  size_t y, q, k, vt, lab, total;
  __host__ __device__ Smem(int m, int n, int c, int dhk, bool proj) {
    npad = pad16(n);
    mp = (m + 31) / 32 * 32;
    yrows = proj ? (n + 31) / 32 * 32 : 0;
    cs = c + 8;
    qks = dhk + 8;
    vts = npad + 8;
    y = 0;
    q = align16(y + (size_t)yrows * cs * 2);
    k = align16(q + (size_t)mp * qks * 2);
    vt = align16(k + (size_t)npad * qks * 2);
    lab = align16(vt + (size_t)dhk * vts * 2);
    total = align16(lab + (size_t)npad * 4);
  }
};

// PROJ: the B6 prologue (q/k/v projected in the kernel) or B7/B8 (q/k/v
// read from device memory, scale folded into q).
template <int DH, bool PROJ>
__global__ void __launch_bounds__(kThreads, 2)
    window_attention_kernel(const AttnArgs a) {
  constexpr int DHK = pad16(DH);
  constexpr int DTILES = DHK / 8;    // n-tiles of a head's q/k/v and P.V
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.m, N = a.n, C = a.c;
  const Smem L(M, N, C, DHK, PROJ);
  bf16* sy = reinterpret_cast<bf16*>(smem + L.y);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* svt = reinterpret_cast<bf16*>(smem + L.vt);
  int* slab = reinterpret_cast<int*>(smem + L.lab);

  const int i = threadIdx.x;
  const int warp = i / 32, lane = i % 32, g = lane / 4, cq = lane % 4;
  const size_t win = blockIdx.x;
  const int h = blockIdx.y;
  const bool f32 = a.f32;

  if (PROJ) {
    // The window's y rows -> shared memory (16-byte loads), zero rows
    // past N.
    const size_t yw = win * N * C;
    const int c8 = C / 8;
    for (int t = i; t < L.yrows * c8; t += kThreads) {
      const int r = t / c8, c0 = (t % c8) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < N && !f32) {
        u = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(a.y) + yw + (size_t)r * C + c0));
      } else if (r < N) {
        const float4* src = reinterpret_cast<const float4*>(
            static_cast<const float*>(a.y) + yw + (size_t)r * C + c0);
        const float4 lo = __ldg(src), hi = __ldg(src + 1);
        u = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w),
                       pack2(hi.x, hi.y), pack2(hi.z, hi.w));
      }
      *reinterpret_cast<uint4*>(sy + r * L.cs + c0) = u;
    }
  } else {
    // Head h's columns of q (times scale, rounded to bf16), k and v^T;
    // columns DH..DHK and rows past M (q) or N (k, v) zero.
    const size_t qw = win * M * C + h * DH;
    const size_t kw = win * N * C + h * DH;
    for (int t = i; t < L.mp * (DHK / 2); t += kThreads) {
      const int r = t / (DHK / 2), d = (t % (DHK / 2)) * 2;
      uint32_t val = 0u;
      if (r < M && d < DH) {
        const float2 f = ld_act2(a.q, qw + (size_t)r * C + d, f32);
        val = pack2(f.x * a.scale, f.y * a.scale);
      }
      *reinterpret_cast<uint32_t*>(sq + r * L.qks + d) = val;
    }
    for (int t = i; t < L.npad * (DHK / 2); t += kThreads) {
      const int r = t / (DHK / 2), d = (t % (DHK / 2)) * 2;
      uint32_t ku = 0u, vu = 0u;
      if (r < N && d < DH && !f32) {
        ku = ldg32(static_cast<const bf16*>(a.k) + kw + (size_t)r * C + d);
        vu = ldg32(static_cast<const bf16*>(a.v) + kw + (size_t)r * C + d);
      } else if (r < N && d < DH) {
        const float2 kf = ld_act2(a.k, kw + (size_t)r * C + d, true);
        const float2 vf = ld_act2(a.v, kw + (size_t)r * C + d, true);
        ku = pack2(kf.x, kf.y);
        vu = pack2(vf.x, vf.y);
      }
      *reinterpret_cast<uint32_t*>(sk + r * L.qks + d) = ku;
      const bf16* hv = reinterpret_cast<const bf16*>(&vu);
      svt[d * L.vts + r] = hv[0];
      svt[(d + 1) * L.vts + r] = hv[1];
    }
  }
  const bool masked = a.labels != nullptr;
  if (masked) {
    const int* lab = a.labels + (size_t)(win % a.p_windows) * N;
    for (int t = i; t < N; t += kThreads) slab[t] = __ldg(lab + t);
  }
  __syncthreads();

  if (PROJ) {
    // ---- q/k/v of head h (tensor cores), 32 rows per warp pass ----
    const bf16* wh = a.wqkv + (size_t)h * 3 * DHK * C;
    float acc[2][kNT][4];
    for (int r0 = warp * 32; r0 < L.yrows; r0 += kRowStep) {
#pragma unroll 1
      for (int which = 0; which < 3; ++which) {
        if (which == 0 && r0 >= M) continue;     // q of content rows only
        warp_gemm(acc, sy, L.cs, r0, 2, wh + (size_t)which * DHK * C, C, 0,
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
              if (which == 0) {        // r < mp: r0 < M and mp % 32 == 0
                *reinterpret_cast<uint32_t*>(sq + r * L.qks + d) = pack2(v0, v1);
              } else if (r < L.npad) { // rows past N come from zero y rows
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
  const float* bias_h = a.bias + (size_t)h * M * N;
  const float scale = PROJ ? a.scale : 1.f;   // B7/B8: folded into q
  const size_t ow = win * M * C + h * DH;
  const AttnDrop nodrop{};
  for (int r0 = warp * 32; r0 < M; r0 += kRowStep) {
    const int mtiles = r0 + 16 < M ? 2 : 1;
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      const int t0 = r0 + mt * 16;
      float o[DTILES][4];
      attend_tile<DHK, false>(o, sq, sk, L.qks, svt, L.vts, slab, masked,
                              bias_h, t0, M, N, L.npad, scale, nodrop, lane);
      const int ra = t0 + g, rb = t0 + g + 8;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const int d = dt * 8 + 2 * cq;   // DH is even: d < DH => d + 1 < DH
        if (d < DH) {
          if (ra < M)
            st_act2(a.out, ow + (size_t)ra * C + d, f32, o[dt][0], o[dt][1]);
          if (rb < M)
            st_act2(a.out, ow + (size_t)rb * C + d, f32, o[dt][2], o[dt][3]);
        }
      }
    }
  }
}

template <int DH, bool PROJ>
cudaError_t launch_as(const AttnArgs& a, int bp, int heads,
                      cudaStream_t stream) {
  // Shared memory per CTA: see Smem above (at most 134,912 B at the
  // flagship shapes; refused above the 227 KB a CTA may use).
  const Smem L(a.m, a.n, a.c, pad16(DH), PROJ);
  if (L.total > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<DH, PROJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  window_attention_kernel<DH, PROJ>
      <<<dim3(bp, heads), kThreads, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const AttnArgs& a, int bp, int heads, cudaStream_t s) {
  return a.y != nullptr ? launch_as<DH, true>(a, bp, heads, s)
                        : launch_as<DH, false>(a, bp, heads, s);
}

}  // namespace

// B6 when y is given (wqkv: its per-head weights; q, k, v null), else B7/B8
// on q, k, v.  out: [bp, m, c]; y, q, k, v and out fp32 when act_f32,
// else bf16.
extern "C" cudaError_t mivp_window_attention(
    const void* y, const void* wqkv, const void* q, const void* k,
    const void* v, const void* bias, const void* labels, void* out, int bp,
    int m, int n, int c, int heads, int p_windows, float scale, int act_f32,
    void* stream) {
  const bool proj = y != nullptr;
  if (bp < 1 || m < 1 || n < 1 || heads < 1 || c % heads != 0 ||
      (proj && (m > n || c % 16 != 0 || wqkv == nullptr)) ||
      (!proj && (q == nullptr || k == nullptr || v == nullptr)) ||
      (labels != nullptr && (p_windows < 1 || bp % p_windows != 0)) ||
      bias == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  AttnArgs a;
  a.y = y;
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.labels = static_cast<const int*>(labels);
  a.out = out;
  a.f32 = act_f32 != 0;
  a.m = m;
  a.n = n;
  a.c = c;
  a.p_windows = p_windows;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c / heads) {
    case 8: return launch<8>(a, bp, heads, s);
    case 12: return launch<12>(a, bp, heads, s);
    case 16: return launch<16>(a, bp, heads, s);
    case 24: return launch<24>(a, bp, heads, s);
    case 32: return launch<32>(a, bp, heads, s);
    case 48: return launch<48>(a, bp, heads, s);
    case 64: return launch<64>(a, bp, heads, s);
    default: return cudaErrorInvalidValue;
  }
}
