// Swin block PAIR forward for Hopper (sm_90a): both blocks of a
// (no-shift, shift) pair in one launch.
//
// Replaces the TPU kernel `_pair_kernel` of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/fused_block.py,
// launched by `_forward_pair`).  Input and output are the UNSHIFTED
// windows [BP, M, C] of the pair; block 2 runs on the cyclically shifted
// windows.  Windows are dilated (voxel t*p + w of an axis is token t of
// window w), so a roll maps every shifted window w' onto exactly one
// source window src[w'] with its tokens rolled: token t of w' is token
// tok[w', t] of src[w'] (ops/windows.py::pair_plan).  One cluster of
// CTAs (B1's cluster size, cluster_size in fused_block_common.cuh) per
// shifted window w' = b*P + j of the [B*P] batch:
//
//   block 1 on source window s = b*P + src[j]  (dropout counters of s,
//           no mask), output rounded to the array dtype (bf16 or fp32,
//           as x) and written to s's slot of `out` -- where the pair's
//           output for s goes anyway;
//   block 2 on the shifted window: its row t reads row tok[j, t] of that
//           slot (labels of j, dropout counters of w'), and writes its
//           output back to the same row: the inverse roll.
//
// These are the JAX kernel's counters and its rounding between the
// blocks, so B5 is bit for bit B1 -> shift gather -> B1 -> inverse gather.
//
// What bounds it on the H100: the same matrix products as two B1 launches
// (it runs B1's body, swin_block_window in fused_block_common.cuh, twice),
// and how many warps are in flight per SM.  The TPU kernel's point was
// to keep block 1's output out of HBM; here the shifted-window tile has to
// be read back by every CTA of the cluster in another row order, so block
// 1's output goes to the window's output slot in device memory (written
// and read back by the same cluster, so it stays in L2) and shared memory
// grows only by the M row indices.  Between the blocks one cluster barrier
// (release/acquire) makes every CTA's block-1 rows visible to the others
// and frees the CTAs' `ra` regions for block 2.  In block 2 each slot row
// is read by every CTA's LN1 before the cluster barrier of the block, and
// written only after it by the CTA that owns the shifted row.

#include "fused_block_common.cuh"

namespace {

struct PairArgs {
  BlockArgs blk[2];  // blk[0].x / .out: the pair's input and output;
                     // blk[1].labels: [P, N] labels of the shifted windows
  const int* src;    // [P] source window of each shifted window
  const int* tok;    // [P, M] source token of each shifted token
};

// F32: x and out (and block 1's output in the slot) are fp32.
template <int DH, bool DROP, int MAXT, bool F32>
__global__ void __launch_bounds__(MAXT, MAXT <= 256 ? 2 : 1)
    fused_swin_pair_kernel(const PairArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockArgs& a0 = p.blk[0];
  const BlockArgs& a1 = p.blk[1];
  const int M = a0.m, P = a1.p_windows;
  int* rows = reinterpret_cast<int*>(smem + block_smem(a0, pad16(DH), a0.ks).total);
  const size_t w = blockIdx.x / a0.ks;         // shifted window
  const int j = (int)(w % P);
  const size_t s = w - j + __ldg(p.src + j);   // its source window
  for (int t = threadIdx.x; t < M; t += blockDim.x)
    rows[t] = __ldg(p.tok + (size_t)j * M + t);
  void* slot = act_at(a0.out, s * M * a0.c, F32);
  swin_block_window<DH, DROP, false, F32>(
      a0, act_at(a0.x, s * M * a0.c, F32), slot, nullptr, (uint32_t)s,
      nullptr, smem);
  // Block 1's rows (other warps' and other CTAs') and the row map visible;
  // every CTA done with its `ra`.
  if (a0.ks > 1) cluster_sync();
  else __syncthreads();
  swin_block_window<DH, DROP, true, F32>(
      a1, slot, slot, rows, (uint32_t)w,
      a1.labels == nullptr ? nullptr : a1.labels + (size_t)j * (M + a1.n_ext),
      smem);
}

// Launches the kernel, or (info not null) writes the launch's shape
// instead (launch_clustered).
template <int DH, bool DROP, int MAXT, bool F32>
cudaError_t launch_as(PairArgs p, int bp, cudaStream_t stream, int* info) {
  const BlockArgs& a = p.blk[0];
  auto* kernel = fused_swin_pair_kernel<DH, DROP, MAXT, F32>;
  size_t bytes = 0;
  const int ks = cluster_size(kernel, a, bp, pad16(DH),
                              align16((size_t)a.m * 4), &bytes);
  if (ks == 0) return cudaErrorInvalidValue;
  p.blk[0].ks = p.blk[1].ks = ks;
  return launch_clustered(kernel, p, bp, ks, (a.m + 31) / 32 * 32, bytes,
                          stream, info);
}

template <int DH, bool DROP, bool F32>
cudaError_t launch(const PairArgs& p, int bp, cudaStream_t stream,
                   int* info) {
  if (p.blk[0].m <= 256)
    return launch_as<DH, DROP, 256, F32>(p, bp, stream, info);
  return launch_as<DH, DROP, 1024, F32>(p, bp, stream, info);
}

template <bool DROP, bool F32>
cudaError_t launch_dh(const PairArgs& p, int dh, int bp, cudaStream_t s,
                      int* info) {
  switch (dh) {
    case 8: return launch<8, DROP, F32>(p, bp, s, info);
    case 12: return launch<12, DROP, F32>(p, bp, s, info);
    case 16: return launch<16, DROP, F32>(p, bp, s, info);
    case 24: return launch<24, DROP, F32>(p, bp, s, info);
    case 32: return launch<32, DROP, F32>(p, bp, s, info);
    case 48: return launch<48, DROP, F32>(p, bp, s, info);
    case 64: return launch<64, DROP, F32>(p, bp, s, info);
    default: return cudaErrorInvalidValue;
  }
}

// One block's operand pointers, in the order of ops/fused_pair.py.
void set_operands(BlockArgs& a, const void* const* ops) {
  a.wqkv = static_cast<const bf16*>(ops[0]);
  a.ext_kv = static_cast<const bf16*>(ops[1]);
  a.pe_tab = static_cast<const float*>(ops[2]);
  a.pe_coord = static_cast<const int*>(ops[3]);
  a.ln1_s = static_cast<const float*>(ops[4]);
  a.ln1_b = static_cast<const float*>(ops[5]);
  a.wproj = static_cast<const bf16*>(ops[6]);
  a.bproj = static_cast<const float*>(ops[7]);
  a.ln2_s = static_cast<const float*>(ops[8]);
  a.ln2_b = static_cast<const float*>(ops[9]);
  a.wmlp = static_cast<const bf16*>(ops[10]);
  a.bmlp = static_cast<const float*>(ops[11]);
}

}  // namespace

// Each (activation dtype, dropout) set of instances is a translation unit
// of its own, so the library's four quarters build in parallel: this file
// holds the bf16 instances without dropout and the C entry;
// fused_pair_drop.cu, fused_pair_f32.cu and fused_pair_f32_drop.cu include
// it with MIVP_PAIR_SET naming their set's entry.
#ifdef MIVP_PAIR_SET

extern "C" cudaError_t MIVP_PAIR_SET(const void* args, int dh, int bp,
                                     void* stream, int* info) {
  return launch_dh<MIVP_PAIR_DROP, MIVP_PAIR_F32>(
      *static_cast<const PairArgs*>(args), dh, bp,
      static_cast<cudaStream_t>(stream), info);
}

#else

typedef cudaError_t (*PairSet)(const void*, int, int, void*, int*);
extern "C" cudaError_t mivp_fused_swin_pair_drop(const void*, int, int,
                                                 void*, int*);
extern "C" cudaError_t mivp_fused_swin_pair_f32(const void*, int, int,
                                                void*, int*);
extern "C" cudaError_t mivp_fused_swin_pair_f32_drop(const void*, int, int,
                                                     void*, int*);

// ops0 / ops1: each block's 12 operand pointers (wqkv, ext_kv, pe_tab,
// pe_coord, ln1_s, ln1_b, wproj, bproj, ln2_s, ln2_b, wmlp, bmlp) as B1
// takes them; ph/pw/pd, fold and pe_scale are the two blocks' (equal)
// bias-factor geometry.  info: null to launch, else int[7] that receives
// the launch's shape and nothing runs.
extern "C" cudaError_t mivp_fused_swin_pair(
    const void* x, void* out, const void* src, const void* tok,
    const void* labels, const void* const* ops0, const void* const* ops1,
    int* info, int bp, int m, int c, int heads, int dh, int n_ext,
    int p_windows, int ph, int pw, int pd, int fold, float scale,
    float pe_scale, unsigned seed_a0, unsigned seed_p0, unsigned thr_a0,
    unsigned thr_p0, float keep_a0, float keep_p0, unsigned seed_a1,
    unsigned seed_p1, unsigned thr_a1, unsigned thr_p1, float keep_a1,
    float keep_p1, int drop_cols, int x_f32, void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      p_windows < 1 || bp % p_windows != 0 || drop_cols < m + n_ext ||
      ph < 1 || pw < 1 || pd < 1 || ph > 255 || pw > 255 || pd > 255 ||
      (fold != 0 && n_ext < 1))
    return cudaErrorInvalidValue;
  PairArgs p = {};
  for (int i = 0; i < 2; ++i) {
    BlockArgs& a = p.blk[i];
    set_operands(a, i == 0 ? ops0 : ops1);
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
    a.f32 = x_f32 != 0;
  }
  p.blk[0].x = x;
  p.blk[0].out = out;
  p.blk[1].labels = static_cast<const int*>(labels);
  p.blk[0].drop = DropArgs{seed_a0, seed_p0, thr_a0, thr_p0, keep_a0,
                           keep_p0, drop_cols};
  p.blk[1].drop = DropArgs{seed_a1, seed_p1, thr_a1, thr_p1, keep_a1,
                           keep_p1, drop_cols};
  p.src = static_cast<const int*>(src);
  p.tok = static_cast<const int*>(tok);
  const bool drop = thr_a0 || thr_p0 || thr_a1 || thr_p1;
  if (x_f32 || drop) {
    const PairSet set = x_f32 ? (drop ? mivp_fused_swin_pair_f32_drop
                                      : mivp_fused_swin_pair_f32)
                              : mivp_fused_swin_pair_drop;
    return set(&p, dh, bp, stream, info);
  }
  return launch_dh<false, false>(p, dh, bp,
                                 static_cast<cudaStream_t>(stream), info);
}

#endif  // MIVP_PAIR_SET
