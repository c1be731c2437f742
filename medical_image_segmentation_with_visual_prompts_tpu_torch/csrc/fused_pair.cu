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
// tok[w', t] of src[w'] (ops/windows.py::pair_plan).  One CTA per shifted
// window w' = b*P + j of the [B*P] batch:
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
// and how many windows are in flight per SM.  The TPU kernel's point was
// to keep block 1's output out of HBM; here the shifted-window tile has to
// be read back by other warps in another row order, and a dedicated
// shared-memory tile for it (M x (C + 8) bf16, 28,672 B at 64x64x4) would
// cost the second CTA per SM that B1 relies on.  So block 1's output goes
// to the CTA's own output slot in device memory (written and read back by
// the same CTA, so it stays in L2) and shared memory grows only by the M
// row indices.  Each slot row is then read and written by one warp only
// (the warp that owns the shifted row), so block 2 needs no barrier beyond
// the one between the two blocks.

#include "fused_block_common.cuh"

namespace {

struct PairArgs {
  BlockArgs blk[2];  // blk[0].x / .out: the pair's input and output;
                     // blk[1].labels: [P, N] labels of the shifted windows
  const int* src;    // [P] source window of each shifted window
  const int* tok;    // [P, M] source token of each shifted token
};

__host__ __device__ inline size_t pair_smem(const BlockSmem& L, int m) {
  return L.total + align16((size_t)m * 4);
}

// F32: x and out (and block 1's output in the slot) are fp32.
template <int DH, bool DROP, int MAXT, bool F32>
__global__ void __launch_bounds__(MAXT, MAXT <= 256 ? 2 : 1)
    fused_swin_pair_kernel(const PairArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockArgs& a0 = p.blk[0];
  const BlockArgs& a1 = p.blk[1];
  const int M = a0.m, P = a1.p_windows;
  const BlockSmem L(M, a0.c, M + a0.n_ext, pad16(DH), blockDim.x);
  int* rows = reinterpret_cast<int*>(smem + L.total);
  const size_t w = blockIdx.x;                 // shifted window
  const int j = (int)(w % P);
  const size_t s = w - j + __ldg(p.src + j);   // its source window
  for (int t = threadIdx.x; t < M; t += blockDim.x)
    rows[t] = __ldg(p.tok + (size_t)j * M + t);
  void* slot = act_at(a0.out, s * M * a0.c, F32);
  swin_block_window<DH, DROP, false, false, F32>(
      a0, act_at(a0.x, s * M * a0.c, F32), slot, nullptr, (uint32_t)s,
      nullptr, smem);
  __syncthreads();  // block 1's rows (other warps') and the row map visible
  swin_block_window<DH, DROP, true, false, F32>(
      a1, slot, slot, rows, (uint32_t)w,
      a1.labels == nullptr ? nullptr : a1.labels + (size_t)j * (M + a1.n_ext),
      smem);
}

// Launches the kernel, or (ctas not null) writes how many of its CTAs fit
// on one SM instead.
template <int DH, bool DROP, int MAXT, bool F32>
cudaError_t launch_as(const PairArgs& p, int bp, cudaStream_t stream,
                      int* ctas) {
  const BlockArgs& a = p.blk[0];
  const int threads = (a.m + 31) / 32 * 32;
  const size_t bytes =
      pair_smem(BlockSmem(a.m, a.c, a.m + a.n_ext, pad16(DH), threads), a.m);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = fused_swin_pair_kernel<DH, DROP, MAXT, F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (ctas != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                         threads, bytes);
  kernel<<<bp, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, bool F32>
cudaError_t launch(const PairArgs& p, int bp, cudaStream_t stream,
                   int* ctas) {
  bool drop = false;
  for (const BlockArgs& a : p.blk) drop = drop || a.drop.thr_a || a.drop.thr_p;
  if (p.blk[0].m <= 256)
    return drop ? launch_as<DH, true, 256, F32>(p, bp, stream, ctas)
                : launch_as<DH, false, 256, F32>(p, bp, stream, ctas);
  return drop ? launch_as<DH, true, 1024, F32>(p, bp, stream, ctas)
              : launch_as<DH, false, 1024, F32>(p, bp, stream, ctas);
}

template <bool F32>
cudaError_t launch_dh(const PairArgs& p, int dh, int bp, cudaStream_t s,
                      int* ctas) {
  switch (dh) {
    case 8: return launch<8, F32>(p, bp, s, ctas);
    case 12: return launch<12, F32>(p, bp, s, ctas);
    case 16: return launch<16, F32>(p, bp, s, ctas);
    case 24: return launch<24, F32>(p, bp, s, ctas);
    case 32: return launch<32, F32>(p, bp, s, ctas);
    case 48: return launch<48, F32>(p, bp, s, ctas);
    case 64: return launch<64, F32>(p, bp, s, ctas);
    default: return cudaErrorInvalidValue;
  }
}

// One block's operand pointers, in the order of ops/fused_pair.py.
void set_operands(BlockArgs& a, const void* const* ops) {
  a.wqkv = static_cast<const bf16*>(ops[0]);
  a.ext_kv = static_cast<const bf16*>(ops[1]);
  a.bias = static_cast<const float*>(ops[2]);
  a.ln1_s = static_cast<const float*>(ops[3]);
  a.ln1_b = static_cast<const float*>(ops[4]);
  a.wproj = static_cast<const bf16*>(ops[5]);
  a.bproj = static_cast<const float*>(ops[6]);
  a.ln2_s = static_cast<const float*>(ops[7]);
  a.ln2_b = static_cast<const float*>(ops[8]);
  a.wmlp = static_cast<const bf16*>(ops[9]);
  a.bmlp = static_cast<const float*>(ops[10]);
}

}  // namespace

// The fp32 instances are compiled in their own translation unit
// (fused_pair_f32.cu includes this file with MIVP_F32_UNIT), so the two
// halves of the library build in parallel.
#ifdef MIVP_F32_UNIT

extern "C" cudaError_t mivp_fused_swin_pair_f32(const void* args, int dh,
                                                int bp, void* stream) {
  return launch_dh<true>(*static_cast<const PairArgs*>(args), dh, bp,
                         static_cast<cudaStream_t>(stream), nullptr);
}

#else

extern "C" cudaError_t mivp_fused_swin_pair_f32(const void* args, int dh,
                                                int bp, void* stream);

// ops0 / ops1: each block's 11 operand pointers (wqkv, ext_kv, bias,
// ln1_s, ln1_b, wproj, bproj, ln2_s, ln2_b, wmlp, bmlp) as B1 takes them.
extern "C" cudaError_t mivp_fused_swin_pair(
    const void* x, void* out, const void* src, const void* tok,
    const void* labels, const void* const* ops0, const void* const* ops1,
    int bp, int m, int c, int heads, int dh, int n_ext, int p_windows,
    float scale, unsigned seed_a0, unsigned seed_p0, unsigned thr_a0,
    unsigned thr_p0, float keep_a0, float keep_p0, unsigned seed_a1,
    unsigned seed_p1, unsigned thr_a1, unsigned thr_p1, float keep_a1,
    float keep_p1, int drop_cols, int x_f32, void* stream) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c || bp < 1 ||
      p_windows < 1 || bp % p_windows != 0 || drop_cols < m + n_ext)
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
    a.scale = scale;
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
  if (x_f32) return mivp_fused_swin_pair_f32(&p, dh, bp, stream);
  return launch_dh<false>(p, dh, bp, static_cast<cudaStream_t>(stream),
                          nullptr);
}

// CTAs of B5 that fit on one SM at this geometry (dropout on or off).
extern "C" cudaError_t mivp_fused_swin_pair_ctas_per_sm(
    int m, int c, int heads, int dh, int n_ext, int drop, int* ctas) {
  if (m < 1 || m > 1024 || c % 16 != 0 || heads * dh != c)
    return cudaErrorInvalidValue;
  PairArgs p = {};
  for (BlockArgs& a : p.blk) {
    a.m = m;
    a.c = c;
    a.heads = heads;
    a.n_ext = n_ext;
  }
  p.blk[0].drop.thr_a = drop ? 1u : 0u;
  return launch_dh<false>(p, dh, 1, nullptr, ctas);
}

#endif  // MIVP_F32_UNIT
