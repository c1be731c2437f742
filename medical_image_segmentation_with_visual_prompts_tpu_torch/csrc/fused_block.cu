// Fused Swin transformer block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_kernel` of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/fused_block.py,
// launched by `_forward`).  For each window it computes
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
// row plus heads x N x head_dim twice for attention) and how many warps
// are in flight per SM.  Design: a window runs on a thread block cluster
// of 1, 2, 4 or 8 CTAs (cluster_size in fused_block_common.cuh: the
// fewest CTAs per window that reach the most resident CTAs per SM, then
// more while the grid is under one wave, so the 16x16x2 stages' 108
// windows fill the SMs and their heads run side by side).  Each CTA
// takes LN1 of all rows, then q|k|v (one GEMM
// per head) and attention for its share of the heads on all rows, sends
// each attention output row to the CTA that owns the row through
// distributed shared memory, and after one cluster barrier runs proj,
// LN2 and the MLP on its own rows.  Each warp owns 32 rows in the head
// phase; every product runs on tensor cores with mma.sync m16n8k16 (bf16
// operands, fp32 sums), A from shared memory and B from the transposed
// ([out, in]) weights in device memory, k-packed so a lane's fragment is
// one 8-byte load, where every CTA finds them in L1/L2.  The attention
// bias is built in shared memory from its factors (three per-axis
// tables, the rows' window coordinates, the fold and prompt columns: a
// few KB per CTA against 0.8-1.6 MB per window for the [H, M, N] array).
// Each head's q/k/v width is padded to
// a multiple of 16 (the k-step).  Attention keeps an online max-subtracted
// softmax over 64-key chunks in registers and feeds P to P.V as bf16
// (attend_rows in fused_block_common.cuh, shared with window_attention.cu).
// Row strides are padded so the fragment loads are free of bank
// conflicts.  Every output element takes the same arithmetic whatever the
// cluster size.  The body is swin_block_window in fused_block_common.cuh,
// which the block pair (fused_pair.cu) runs twice per cluster.

#include "fused_block_common.cuh"

namespace {

// DROP: the dropout code is compiled in only for calls with a nonzero
// rate.  MAXT: the largest CTA the instantiation takes.  At 256 threads
// (M <= 256, the flagship's windows) the compiler is held to 128
// registers so that two CTAs fit on an SM.  F32: x and out are fp32.
template <int DH, bool DROP, int MAXT, bool F32>
__global__ void __launch_bounds__(MAXT, MAXT <= 256 ? 2 : 1)
    fused_swin_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t win = blockIdx.x / a.ks;
  const size_t rows = (size_t)a.m * a.c;
  swin_block_window<DH, DROP, false, F32>(
      a, act_at(a.x, win * rows, F32), act_at(a.out, win * rows, F32),
      nullptr, (uint32_t)win,
      a.labels == nullptr ? nullptr
                          : a.labels + (win % a.p_windows) * (a.m + a.n_ext),
      smem);
}

// Launches the kernel over bp windows, or (info not null) writes the
// launch's shape instead (launch_clustered).
template <int DH, bool DROP, int MAXT, bool F32>
cudaError_t launch_as(BlockArgs a, int bp, cudaStream_t stream, int* info) {
  auto* kernel = fused_swin_block_kernel<DH, DROP, MAXT, F32>;
  size_t bytes = 0;
  a.ks = cluster_size(kernel, a, bp, pad16(DH), 0, &bytes);
  if (a.ks == 0) return cudaErrorInvalidValue;
  return launch_clustered(kernel, a, bp, a.ks, (a.m + 31) / 32 * 32, bytes,
                          stream, info);
}

template <int DH, bool F32>
cudaError_t launch(const BlockArgs& a, int bp, cudaStream_t stream,
                   int* info) {
  const bool drop = a.drop.thr_a || a.drop.thr_p;
  if (a.m <= 256)
    return drop ? launch_as<DH, true, 256, F32>(a, bp, stream, info)
                : launch_as<DH, false, 256, F32>(a, bp, stream, info);
  return drop ? launch_as<DH, true, 1024, F32>(a, bp, stream, info)
              : launch_as<DH, false, 1024, F32>(a, bp, stream, info);
}

template <bool F32>
cudaError_t launch_dh(const BlockArgs& a, int dh, int bp, cudaStream_t s,
                      int* info) {
  switch (dh) {
    case 8: return launch<8, F32>(a, bp, s, info);
    case 12: return launch<12, F32>(a, bp, s, info);
    case 16: return launch<16, F32>(a, bp, s, info);
    case 24: return launch<24, F32>(a, bp, s, info);
    case 32: return launch<32, F32>(a, bp, s, info);
    case 48: return launch<48, F32>(a, bp, s, info);
    case 64: return launch<64, F32>(a, bp, s, info);
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
                                                 int* info) {
  return launch_dh<true>(*static_cast<const BlockArgs*>(args), dh, bp,
                         static_cast<cudaStream_t>(stream), info);
}

#else

extern "C" cudaError_t mivp_fused_swin_block_f32(const void* args, int dh,
                                                 int bp, void* stream,
                                                 int* info);

// pe_tab, pe_coord, ph/pw/pd, fold and pe_scale: the bias factors
// (FactoredBias).  info: null to launch, else int[7] that receives the
// launch's shape (launch_clustered) and nothing runs.
extern "C" cudaError_t mivp_fused_swin_block(
    const void* x, void* out, const void* wqkv, const void* ext_kv,
    const void* pe_tab, const void* pe_coord, const void* labels,
    const void* ln1_s, const void* ln1_b, const void* wproj,
    const void* bproj, const void* ln2_s, const void* ln2_b,
    const void* wmlp, const void* bmlp, int* info, int bp, int m, int c,
    int heads, int dh, int n_ext, int p_windows, int ph, int pw, int pd,
    int fold, float scale, float pe_scale, unsigned seed_a, unsigned seed_p,
    unsigned thr_a, unsigned thr_p, float keep_a, float keep_p,
    int drop_cols, int x_f32, void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      (labels != nullptr && p_windows < 1) || drop_cols < m + n_ext ||
      ph < 1 || pw < 1 || pd < 1 || ph > 255 || pw > 255 || pd > 255 ||
      (fold != 0 && n_ext < 1))
    return cudaErrorInvalidValue;
  BlockArgs a = {};
  a.x = x;
  a.out = out;
  a.f32 = x_f32 != 0;
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.ext_kv = static_cast<const bf16*>(ext_kv);
  a.pe_tab = static_cast<const float*>(pe_tab);
  a.pe_coord = static_cast<const int*>(pe_coord);
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
  a.ph = ph;
  a.pw = pw;
  a.pd = pd;
  a.fold = fold != 0;
  a.tabw = bias_table_floats(ph, pw, pd, m, n_ext, a.fold);
  a.scale = scale;
  a.pe_scale = pe_scale;
  a.drop = DropArgs{seed_a, seed_p, thr_a, thr_p, keep_a, keep_p, drop_cols};
  if (a.f32) return mivp_fused_swin_block_f32(&a, dh, bp, stream, info);
  return launch_dh<false>(a, dh, bp, static_cast<cudaStream_t>(stream),
                          info);
}

extern "C" const char* mivp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // MIVP_F32_UNIT
