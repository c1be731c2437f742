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
//   out = x1 + LN2(x1) Wmlp + bmlp             stored in x's dtype
//
// x is fp32 or bf16, as the JAX kernel takes either (a template parameter
// chosen per launch; the fp32 instances build in fused_block_f32.cu): LN,
// softmax and the residuals are fp32 in registers, and only the matmul
// operands are rounded to bf16.
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
// fused_block_common.cuh, shared with window_attention.cu).  Row strides
// are padded so the fragment loads are free of bank conflicts.  The body
// is swin_block_window in fused_block_common.cuh, which the block pair
// (fused_pair.cu) runs twice per CTA.

#include "fused_block_common.cuh"

namespace {

// DROP: the dropout code is compiled in only for calls with a nonzero
// rate.  MAXT: the largest CTA the instantiation takes.  At 256 threads
// (M <= 256, the flagship's windows) the compiler is held to 128
// registers so that two CTAs fit on an SM: at 130 registers one CTA of
// the 64x64x4 stages runs per SM and the launch takes twice as long.
// SPILL: x1 and the attention output in a.scratch (windows whose layout
// exceeds a CTA's shared memory, such as M 256 at C 192 under the
// reference padding; 256-thread CTAs only).  F32: x and out are fp32.
template <int DH, bool DROP, int MAXT, bool SPILL, bool F32>
__global__ void __launch_bounds__(MAXT, MAXT <= 256 ? 2 : 1)
    fused_swin_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t win = blockIdx.x;
  const size_t rows = (size_t)a.m * a.c;
  swin_block_window<DH, DROP, false, SPILL, F32>(
      a, act_at(a.x, win * rows, F32), act_at(a.out, win * rows, F32),
      nullptr, (uint32_t)win,
      a.labels == nullptr ? nullptr
                          : a.labels + (win % a.p_windows) * (a.m + a.n_ext),
      smem);
}

constexpr size_t kMaxSmem = 227 * 1024;

template <int DH, bool DROP, int MAXT, bool SPILL, bool F32>
cudaError_t launch_kernel(const BlockArgs& a, int bp, cudaStream_t stream,
                          int* ctas, int threads, size_t bytes) {
  auto* kernel = fused_swin_block_kernel<DH, DROP, MAXT, SPILL, F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (ctas != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                         threads, bytes);
  kernel<<<bp, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Launches the kernel, or (ctas not null) writes how many of its CTAs fit
// on one SM instead.  A window whose layout exceeds the shared memory of
// a CTA runs the SPILL form (256 threads at most, a.scratch given).
template <int DH, bool DROP, int MAXT, bool F32>
cudaError_t launch_as(const BlockArgs& a, int bp, cudaStream_t stream,
                      int* ctas) {
  const int threads = (a.m + 31) / 32 * 32;
  const BlockSmem L(a.m, a.c, a.m + a.n_ext, pad16(DH), threads);
  if (L.total <= kMaxSmem)
    return launch_kernel<DH, DROP, MAXT, false, F32>(a, bp, stream, ctas,
                                                     threads, L.total);
  const BlockSmem S(a.m, a.c, a.m + a.n_ext, pad16(DH), threads, true);
  if (MAXT > 256 || S.total > kMaxSmem ||
      (ctas == nullptr && a.scratch == nullptr))
    return cudaErrorInvalidValue;
  return launch_kernel<DH, DROP, 256, true, F32>(a, bp, stream, ctas,
                                                 threads, S.total);
}

template <int DH, bool F32>
cudaError_t launch(const BlockArgs& a, int bp, cudaStream_t stream,
                   int* ctas) {
  const bool drop = a.drop.thr_a || a.drop.thr_p;
  if (a.m <= 256)
    return drop ? launch_as<DH, true, 256, F32>(a, bp, stream, ctas)
                : launch_as<DH, false, 256, F32>(a, bp, stream, ctas);
  return drop ? launch_as<DH, true, 1024, F32>(a, bp, stream, ctas)
              : launch_as<DH, false, 1024, F32>(a, bp, stream, ctas);
}

template <bool F32>
cudaError_t launch_dh(const BlockArgs& a, int dh, int bp, cudaStream_t s,
                      int* ctas) {
  switch (dh) {
    case 8: return launch<8, F32>(a, bp, s, ctas);
    case 12: return launch<12, F32>(a, bp, s, ctas);
    case 16: return launch<16, F32>(a, bp, s, ctas);
    case 24: return launch<24, F32>(a, bp, s, ctas);
    case 32: return launch<32, F32>(a, bp, s, ctas);
    case 48: return launch<48, F32>(a, bp, s, ctas);
    case 64: return launch<64, F32>(a, bp, s, ctas);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The fp32 instances are compiled in their own translation unit
// (fused_block_f32.cu includes this file with MIVP_F32_UNIT), so the two
// halves of the library build in parallel.
#ifdef MIVP_F32_UNIT

extern "C" cudaError_t mivp_fused_swin_block_f32(const void* args, int dh,
                                                 int bp, void* stream,
                                                 int* ctas) {
  return launch_dh<true>(*static_cast<const BlockArgs*>(args), dh, bp,
                         static_cast<cudaStream_t>(stream), ctas);
}

#else

extern "C" cudaError_t mivp_fused_swin_block_f32(const void* args, int dh,
                                                 int bp, void* stream,
                                                 int* ctas);

// scratch: mivp_fused_swin_block_scratch bytes per window (times bp), or
// null when that is 0.
extern "C" cudaError_t mivp_fused_swin_block(
    const void* x, void* out, const void* wqkv, const void* ext_kv,
    const void* bias, const void* labels, const void* ln1_s,
    const void* ln1_b, const void* wproj, const void* bproj,
    const void* ln2_s, const void* ln2_b, const void* wmlp, const void* bmlp,
    void* scratch, int bp, int m, int c, int heads, int dh, int n_ext, int p_windows,
    float scale, unsigned seed_a, unsigned seed_p, unsigned thr_a,
    unsigned thr_p, float keep_a, float keep_p, int drop_cols, int x_f32,
    void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      (labels != nullptr && p_windows < 1) || drop_cols < m + n_ext)
    return cudaErrorInvalidValue;
  BlockArgs a;
  a.x = x;
  a.out = out;
  a.f32 = x_f32 != 0;
  a.scratch = static_cast<unsigned char*>(scratch);
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
  if (a.f32) return mivp_fused_swin_block_f32(&a, dh, bp, stream, nullptr);
  return launch_dh<false>(a, dh, bp, static_cast<cudaStream_t>(stream),
                          nullptr);
}

// Device scratch per window that B1 needs at this geometry: 0 when the
// window fits in a CTA's shared memory, else x1 and the attention output
// (the SPILL form).
extern "C" cudaError_t mivp_fused_swin_block_scratch(int m, int c, int dh,
                                                     int n_ext,
                                                     long long* bytes) {
  if (m < 1 || m > 1024 || c % 16 != 0 || dh < 1)
    return cudaErrorInvalidValue;
  const int threads = (m + 31) / 32 * 32;
  const BlockSmem L(m, c, m + n_ext, pad16(dh), threads);
  *bytes = L.total <= kMaxSmem ? 0
           : (long long)BlockSmem(m, c, m + n_ext, pad16(dh), threads, true)
                 .spill_bytes;
  return cudaSuccess;
}

// CTAs of B1 that fit on one SM at this geometry (dropout on or off).
extern "C" cudaError_t mivp_fused_swin_block_ctas_per_sm(
    int m, int c, int heads, int dh, int n_ext, int drop, int* ctas) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c)
    return cudaErrorInvalidValue;
  BlockArgs a = {};
  a.m = m;
  a.c = c;
  a.heads = heads;
  a.n_ext = n_ext;
  a.drop.thr_a = drop ? 1u : 0u;
  return launch_dh<false>(a, dh, 1, nullptr, ctas);
}

extern "C" const char* mivp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // MIVP_F32_UNIT
