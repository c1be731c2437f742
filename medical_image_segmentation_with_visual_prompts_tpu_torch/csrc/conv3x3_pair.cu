// 3x3x3 decoder conv with an optional BN + LeakyReLU prologue on one or
// two inputs, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package
// (medical_image_segmentation_with_visual_prompts_tpu/ops/conv_pallas.py):
// `_kernel_pair` (B2, launched by `_forward_pair`) and its one-input form
// `_kernel` (B3, launched by `_forward`).  It computes
//
//   out = conv3x3x3_same(act(concat(xa, xb) * scale + shift)) + bias
//
// on channels-last inputs without building the concat: the prologue
// reads each tap's voxel from xa or xb, applies the folded BatchNorm
// affine (AFFINE) and LeakyReLU(0.01) (LEAKY), and rounds to bf16.
// Out-of-range taps contribute 0 (zero padding AFTER the prologue, not
// act(shift)).  B3 is the same kernel with no xb (cb = 0); its "no
// prologue" and "no LeakyReLU" forms are the template flags.
//
// What bounds it on the H100: the bytes of xa/xb read per tap -- every
// input voxel is read by 27 output voxels -- and, at these small channel
// counts, the tile loop's synchronisation.  Design: an implicit GEMM,
// M = voxels, N = output channels, K = 27 taps x (Ca + Cb) channels.  A
// CTA owns 128 voxels x 16*NF channels; per K step it stages one tap's
// 16 input channels for its voxels (prologue applied) and the matching
// weight rows in shared memory, and 8 warps run bf16 WMMA 16x16x16 with
// fp32 accumulators.  Neighbouring voxels share taps, so the repeated
// reads are served from L1/L2; a halo tile in shared memory is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
using namespace nvcuda;

constexpr int BM = 128;  // voxels per CTA
constexpr int BK = 16;   // input channels per K step
constexpr int kThreads = 256;

struct ConvArgs {
  const bf16* xa;       // [V, Ca]
  const bf16* xb;       // [V, Cb], or null when cb = 0
  const bf16* w;        // [27, Ca + Cb, Co]
  const float* bias;    // [Co]
  const float* scale;   // [Ca + Cb] (AFFINE)
  const float* shift;   // [Ca + Cb] (AFFINE)
  bf16* out;            // [V, Co]
  int voxels, h, w_, d, ca, cb, co;
};

template <int NF, bool AFFINE, bool LEAKY>
__global__ void __launch_bounds__(kThreads)
conv3x3_pair_kernel(const ConvArgs a) {
  constexpr int BN = 16 * NF;
  __shared__ __align__(32) bf16 s_a[BM * BK];
  __shared__ __align__(32) bf16 s_b[BK * BN];
  __shared__ __align__(32) float s_c[BM * BN];

  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.y * BN;
  const int cin = a.ca + a.cb;

  // Each thread stages 8 channels of one voxel per K step.
  const int r = tid / 2, half = tid % 2;
  const long v = (long)blockIdx.x * BM + r;
  const bool valid = v < a.voxels;
  int vh = 0, vw = 0, vd = 0;
  long vb = 0;
  if (valid) {
    vd = v % a.d;
    long t = v / a.d;
    vw = t % a.w_;
    t /= a.w_;
    vh = t % a.h;
    vb = t / a.h;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int tap = 0; tap < 27; ++tap) {
    const int nh = vh + tap / 9 - 1, nw = vw + (tap / 3) % 3 - 1,
              nd = vd + tap % 3 - 1;
    const bool inb = valid && nh >= 0 && nh < a.h && nw >= 0 && nw < a.w_ &&
                     nd >= 0 && nd < a.d;
    const long nv = ((vb * a.h + nh) * a.w_ + nw) * a.d + nd;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      // A tile: prologue on the tap's voxel, zero when out of range.
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (inb) {
        const int c = c0 + half * 8;
        const bf16* src = c < a.ca ? a.xa + nv * a.ca + c
                                   : a.xb + nv * a.cb + (c - a.ca);
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
        __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(hv[k]);
          float y0 = f.x, y1 = f.y;
          if (AFFINE) {
            y0 = y0 * __ldg(a.scale + c + 2 * k) + __ldg(a.shift + c + 2 * k);
            y1 = y1 * __ldg(a.scale + c + 2 * k + 1) + __ldg(a.shift + c + 2 * k + 1);
          }
          if (LEAKY) {
            y0 = y0 >= 0.f ? y0 : 0.01f * y0;
            y1 = y1 >= 0.f ? y1 : 0.01f * y1;
          }
          hp[k] = (AFFINE || LEAKY) ? __floats2bfloat162_rn(y0, y1) : hv[k];
        }
      }
      *reinterpret_cast<uint4*>(s_a + r * BK + half * 8) = packed;
      // B tile: 16 weight rows x BN output channels.
      for (int t = tid; t < BK * BN / 8; t += kThreads) {
        const int k = t / (BN / 8), n8 = (t % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(s_b + k * BN + n8) = __ldg(
            reinterpret_cast<const uint4*>(
                a.w + ((long)tap * cin + c0 + k) * a.co + n0 + n8));
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, s_a + warp * 16 * BK, BK);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, s_b + f * 16, BN);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(s_c + warp * 16 * BN + f * 16, acc[f], BN,
                            wmma::mem_row_major);
  __syncthreads();
  for (int t = tid; t < BM * BN; t += kThreads) {
    const int rr = t / BN, n = t % BN;
    const long vo = (long)blockIdx.x * BM + rr;
    if (vo < a.voxels)
      a.out[vo * a.co + n0 + n] =
          __float2bfloat16_rn(s_c[t] + __ldg(a.bias + n0 + n));
  }
}

template <int NF, bool AFFINE, bool LEAKY>
cudaError_t launch_as(const ConvArgs& a, cudaStream_t stream) {
  dim3 grid((a.voxels + BM - 1) / BM, a.co / (16 * NF));
  conv3x3_pair_kernel<NF, AFFINE, LEAKY><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int NF>
cudaError_t launch(const ConvArgs& a, bool affine, bool leaky,
                   cudaStream_t s) {
  if (affine)
    return leaky ? launch_as<NF, true, true>(a, s)
                 : launch_as<NF, true, false>(a, s);
  return leaky ? launch_as<NF, false, true>(a, s)
               : launch_as<NF, false, false>(a, s);
}

}  // namespace

// B2 with xb (cb > 0), B3 without (xb null, cb = 0).  affine: apply
// scale/shift; leaky: apply LeakyReLU(0.01) after it.
extern "C" cudaError_t mivp_conv3x3(
    const void* xa, const void* xb, const void* w, const void* bias,
    const void* scale, const void* shift, void* out, int voxels, int h,
    int w_, int d, int ca, int cb, int co, int affine, int leaky,
    void* stream) {
  if (voxels < 1 || ca < BK || ca % BK != 0 || cb % BK != 0 ||
      co % 16 != 0 || (cb > 0) != (xb != nullptr) ||
      (affine && (scale == nullptr || shift == nullptr)) ||
      (long)voxels != (long)voxels / ((long)h * w_ * d) * h * w_ * d)
    return cudaErrorInvalidValue;
  ConvArgs a{static_cast<const bf16*>(xa), static_cast<const bf16*>(xb),
             static_cast<const bf16*>(w), static_cast<const float*>(bias),
             static_cast<const float*>(scale), static_cast<const float*>(shift),
             static_cast<bf16*>(out), voxels, h, w_, d, ca, cb, co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co % 48 == 0) return launch<3>(a, affine, leaky, s);
  if (co % 32 == 0) return launch<2>(a, affine, leaky, s);
  return launch<1>(a, affine, leaky, s);
}
