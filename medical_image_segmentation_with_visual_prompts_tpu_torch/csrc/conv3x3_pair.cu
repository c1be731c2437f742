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
// on channels-last bf16 inputs without building the concat: the folded
// BatchNorm affine (optional), LeakyReLU(0.01) (optional) and the bf16
// rounding of the conv operand, with zero padding AFTER the prologue
// (out-of-range taps contribute 0, not act(shift)).  bf16 weights, fp32
// sums, the output in fp32 or bf16 (the model's dtype).  B3 is the same
// kernel with no xb (cb = 0).
//
// What bounds it on the H100: the tensor-core products (2 x voxels x Co x
// 27 x Cin operations; every input voxel feeds 27 output voxels).  Design:
// an implicit GEMM (M = output voxels, N = output channels, K = 27 taps x
// Cin) over a brick of th x 8 x td output voxels (td the full depth up to
// 4) and a slice of BN output channels per CTA of 8 warps.  For each chunk
// of 16 input channels (xa's chunks, then xb's):
//   * the brick's (th+2) x 10 x (td+2) halo and the chunk's 27 x BN weight
//     rows are staged in shared memory by cp.async, double-buffered: the
//     next chunk's copies fly while this chunk computes;
//   * the prologue runs once per staged element, in place, and leaves the
//     out-of-volume halo voxels at 0;
//   * each tap is a shifted view of the halo: ldmatrix takes one row
//     address per lane, so a tap is an address offset and no im2col tile
//     exists; every warp runs mma.sync m16n8k16 over its 16*MT rows and
//     the BN columns for all 27 taps.
// A table of the halo voxels' offsets (-1 outside the volume), built once
// per CTA, serves every chunk's copies and prologue.  Each tap's fragments
// are loaded while the previous tap's products run (two register sets,
// the 27 taps unrolled).  Rows of a 16-row tile are runs of 8 voxels along
// W, so the 8 rows an ldmatrix reads are consecutive halo voxels; with
// 32-byte voxel rows the two 16-byte halves of a row are swapped on bit 2
// of its index (the same for the weight rows), which makes every ldmatrix
// free of bank conflicts.  The epilogue adds the bias from registers and
// stores from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTW = 8;         // brick width along W: an ldmatrix tile's rows
constexpr int kChunk = 16;     // input channels per staged chunk (one k-step)
constexpr int kRow = 32;       // bytes per staged voxel or weight row
constexpr int kMaxSmem = 227 * 1024;

struct ConvArgs {
  const bf16* xa;       // [B, H, W, D, Ca]
  const bf16* xb;       // [B, H, W, D, Cb], or null when cb = 0
  const bf16* w;        // [(Ca + Cb) / 16, 27, Co, 16] (ops/conv_fused.py)
  const float* bias;    // [Co]
  const float* scale;   // [Ca + Cb], or null (no affine)
  const float* shift;   // [Ca + Cb], or null
  void* out;            // [B, H, W, D, Co], fp32 or bf16 (out_f32)
  int b, h, w_, d, ca, cb, co;
  int th, td;           // brick: th x kTW x td output voxels
  int nbh, nbw, nbd;    // bricks along H, W and D
  bool affine, leaky, out_f32;
};

// Tile of one launch: MT 16-row tiles per warp, BN = 8 * NT8 columns.
struct Tile {
  int mt, nt8, th, td, hv;
  size_t halo, stage, smem;
  Tile(int mt_, int nt8_, int d) : mt(mt_), nt8(nt8_) {
    td = d < 4 ? d : 4;
    th = kWarps * 16 * mt / (kTW * td);
    hv = (th + 2) * (td + 2) * (kTW + 2);
    halo = (size_t)hv * kRow;
    stage = halo + (size_t)27 * 8 * nt8 * kRow;
    smem = 2 * stage + (size_t)hv * 4;   // two stages, then the halo table
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Halo voxel `hv` of the brick at (y0, x0, z0) -> its volume coordinates;
// false when it lies outside the volume.
__device__ __forceinline__ bool halo_voxel(const ConvArgs& a, int hv, int y0,
                                           int x0, int z0, int& y, int& x,
                                           int& z) {
  const int dt = a.td + 2;
  x = x0 - 1 + hv % (kTW + 2);
  const int t = hv / (kTW + 2);
  z = z0 - 1 + t % dt;
  y = y0 - 1 + t / dt;
  return y >= 0 && y < a.h && x >= 0 && x < a.w_ && z >= 0 && z < a.d;
}

// One tap's fragments: the A tiles of the warp's MT row tiles (ldmatrix
// at the tap's halo offset) and the B tiles of its NT8 / 2 column pairs.
template <int MT, int NT8>
__device__ __forceinline__ void load_tap(uint32_t (&af)[MT][4],
                                         uint32_t (&bf)[NT8 / 2][4],
                                         unsigned sh, const int (&hbase)[MT],
                                         int off, int ka, unsigned sw_tap) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int h = hbase[mt] + off;
    ldmatrix_x4(af[mt], sh + h * kRow + ((ka ^ ((h >> 2) & 1)) << 4));
  }
#pragma unroll
  for (int pr = 0; pr < NT8 / 2; ++pr)
    ldmatrix_x4(bf[pr], sw_tap + pr * 16 * kRow);
}

template <int MT, int NT8>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const ConvArgs a) {
  constexpr int BN = 8 * NT8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int DT = a.td + 2, WT = kTW + 2;
  const int HV = (a.th + 2) * DT * WT;
  const int halo_bytes = HV * kRow;
  const int stage_bytes = halo_bytes + 27 * BN * kRow;
  int blk = blockIdx.x;
  const int bw = blk % a.nbw;
  blk /= a.nbw;
  const int bd = blk % a.nbd;
  blk /= a.nbd;
  const int bh = blk % a.nbh;
  const int bb = blk / a.nbh;
  const int y0 = bh * a.th, x0 = bw * kTW, z0 = bd * a.td;
  const int n0 = blockIdx.y * BN;
  const int nca = a.ca / kChunk, nch = nca + a.cb / kChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t vox0 = (size_t)bb * a.h * a.w_ * a.d;

  // Halo table, the same for every chunk: each halo voxel's offset in its
  // image, or -1 outside the volume.
  int* tbl = reinterpret_cast<int*>(smem + 2 * stage_bytes);
  for (int hv = tid; hv < HV; hv += kThreads) {
    int y, x, z;
    tbl[hv] = halo_voxel(a, hv, y0, x0, z0, y, x, z)
                  ? (y * a.w_ + x) * a.d + z : -1;
  }
  __syncthreads();

  // Stage chunk c (halo and weights) into buffer `buf` by cp.async;
  // out-of-volume halo voxels are stored as zeros.
  auto stage = [&](int c, int buf) {
    unsigned char* sh = smem + buf * stage_bytes;
    const bf16* src = c < nca ? a.xa : a.xb;
    const int cs = c < nca ? a.ca : a.cb;
    const int c0 = (c < nca ? c : c - nca) * kChunk;
    for (int p = tid; p < 2 * HV; p += kThreads) {
      const int hv = p >> 1, ph = p & 1;
      const int vo = tbl[hv];
      void* dst = sh + hv * kRow + (ph << 4);
      if (vo >= 0) {
        const int lh = ph ^ ((hv >> 2) & 1);
        cp_async16(dst, src + (vox0 + vo) * cs + c0 + lh * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    unsigned char* sw = sh + halo_bytes;
    const bf16* wc = a.w + (size_t)c * 27 * a.co * kChunk;
    for (int p = tid; p < 2 * 27 * BN; p += kThreads) {
      const int row = p >> 1, ph = p & 1;        // row = tap * BN + n
      const int lh = ph ^ ((row >> 2) & 1);
      const int tap = row / BN, n = row % BN;
      cp_async16(sw + row * kRow + (ph << 4),
                 wc + ((size_t)tap * a.co + n0 + n) * kChunk + lh * 8);
    }
    cp_async_commit();
  };

  // The prologue of chunk c in buffer `buf`, once per staged element;
  // out-of-volume voxels stay 0 (padding after the prologue).
  auto prologue = [&](int c, int buf) {
    unsigned char* sh = smem + buf * stage_bytes;
    for (int p = tid; p < 2 * HV; p += kThreads) {
      const int hv = p >> 1, ph = p & 1;
      if (tbl[hv] < 0) continue;
      const int ch = c * kChunk + (ph ^ ((hv >> 2) & 1)) * 8;
      uint4* q = reinterpret_cast<uint4*>(sh + hv * kRow + (ph << 4));
      uint4 u = *q;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
      float sc[8], sf[8];
      if (a.affine) {
        const float4* s4 = reinterpret_cast<const float4*>(a.scale + ch);
        const float4* f4 = reinterpret_cast<const float4*>(a.shift + ch);
        *reinterpret_cast<float4*>(sc) = __ldg(s4);
        *reinterpret_cast<float4*>(sc + 4) = __ldg(s4 + 1);
        *reinterpret_cast<float4*>(sf) = __ldg(f4);
        *reinterpret_cast<float4*>(sf + 4) = __ldg(f4 + 1);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float2 f = __bfloat1622float2(h2[k]);
        if (a.affine) {
          f.x = f.x * sc[2 * k] + sf[2 * k];
          f.y = f.y * sc[2 * k + 1] + sf[2 * k + 1];
        }
        if (a.leaky) {
          f.x = f.x >= 0.f ? f.x : 0.01f * f.x;
          f.y = f.y >= 0.f ? f.y : 0.01f * f.y;
        }
        h2[k] = __floats2bfloat162_rn(f.x, f.y);
      }
      *q = u;
    }
  };

  // Rows of this lane's A addresses (ldmatrix: lane l gives row l % 16 of
  // the 16-row tile, k-half l / 16): halo index of the tap (0, 0, 0).
  const int rows_valid = a.th * kTW * a.td;
  int hbase[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = (warp * MT + mt) * 16 + (lane & 15);
    const int q = r >> 3, tz = q % a.td, ty = q / a.td;
    hbase[mt] = r < rows_valid ? (ty * DT + tz) * WT + (r & 7) : 0;
  }
  const int ka = lane >> 4;                            // A k-half
  // B: this lane's row of a column pair (n 0-7 or 8-15, k-half), as a
  // byte offset; the rows of a tap and pair start at multiples of 8, so
  // the half swap depends on this offset alone.
  const int nb = (lane >> 4) * 8 + (lane & 7);
  const int boff = nb * kRow + ((((lane >> 3) & 1) ^ ((nb >> 2) & 1)) << 4);

  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  stage(0, 0);
  for (int c = 0; c < nch; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();   // chunk c landed; every warp is done with chunk c - 1
    if (c + 1 < nch) stage(c + 1, buf ^ 1);
    if (a.affine || a.leaky) {
      prologue(c, buf);
      __syncthreads();
    }
    const unsigned sh = static_cast<unsigned>(
        __cvta_generic_to_shared(smem + buf * stage_bytes));
    const unsigned sw = sh + halo_bytes + boff;
    // The 27 taps, each one's fragments loaded while the previous tap's
    // products run (two register sets).
    uint32_t af[2][MT][4], bf[2][NT8 / 2][4];
    load_tap<MT, NT8>(af[0], bf[0], sh, hbase, 0, ka, sw);
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      if (tap + 1 < 27) {
        const int t = tap + 1;   // kh = t / 9, kw = t / 3 % 3, kd = t % 3
        load_tap<MT, NT8>(af[t & 1], bf[t & 1], sh, hbase,
                          ((t / 9) * DT + t % 3) * WT + t / 3 % 3, ka,
                          sw + t * BN * kRow);
      }
#pragma unroll
      for (int pr = 0; pr < NT8 / 2; ++pr)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * pr], af[tap & 1][mt], bf[tap & 1][pr][0],
                   bf[tap & 1][pr][1]);
          mma16816(acc[mt][2 * pr + 1], af[tap & 1][mt], bf[tap & 1][pr][2],
                   bf[tap & 1][pr][3]);
        }
    }
  }

  // Epilogue: bias, then fp32 or bf16 stores of the rows inside the volume.
  const int g = lane / 4, cq = lane % 4;
  float2 bias[NT8];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
    bias[nt] = make_float2(__ldg(a.bias + n0 + nt * 8 + 2 * cq),
                           __ldg(a.bias + n0 + nt * 8 + 2 * cq + 1));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = (warp * MT + mt) * 16 + g + hf * 8;
      const int q = r >> 3, tz = q % a.td, ty = q / a.td;
      const int y = y0 + ty, x = x0 + (r & 7), z = z0 + tz;
      if (r >= rows_valid || y >= a.h || x >= a.w_ || z >= a.d) continue;
      const size_t o = (vox0 + ((size_t)y * a.w_ + x) * a.d + z) * a.co + n0 +
                       2 * cq;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const float v0 = acc[mt][nt][2 * hf] + bias[nt].x;
        const float v1 = acc[mt][nt][2 * hf + 1] + bias[nt].y;
        if (a.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o + nt * 8) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o +
                                             nt * 8) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
}

typedef void (*KernelFn)(const ConvArgs);

template <int MT>
KernelFn kernel_of(int nt8) {
  switch (nt8) {
    case 6: return conv3x3_kernel<MT, 6>;
    case 4: return conv3x3_kernel<MT, 4>;
    case 2: return conv3x3_kernel<MT, 2>;
    default: return nullptr;
  }
}

KernelFn kernel_of(int mt, int nt8) {
  return mt == 4 ? kernel_of<4>(nt8) : mt == 2 ? kernel_of<2>(nt8) : nullptr;
}

// The launch's tile: rows_per_warp 32 or 64 (MT 2 or 4) and BN 16, 32 or
// 48 when given, else the widest BN dividing Co and 64 rows per warp
// where the taller brick still fits the height (fewer B fragment loads
// per product), 32 otherwise.
Tile choose(int h, int d, int co, int rows_per_warp, int bn) {
  const int nt8 = bn ? bn / 8 : co % 48 == 0 ? 6 : co % 32 == 0 ? 4 : 2;
  if (rows_per_warp) return Tile(rows_per_warp / 16, nt8, d);
  const Tile tall(4, nt8, d);
  return tall.th <= h ? tall : Tile(2, nt8, d);
}

bool tile_ok(const Tile& t, int co) {
  return (t.mt == 2 || t.mt == 4) &&
         (t.nt8 == 2 || t.nt8 == 4 || t.nt8 == 6) && co % (8 * t.nt8) == 0 &&
         t.th >= 1 && t.smem <= kMaxSmem;
}

}  // namespace

// B2 with xb (cb > 0), B3 without (xb null, cb = 0).  affine: apply
// scale/shift; leaky: apply LeakyReLU(0.01) after it; out_f32: write fp32
// (else bf16).  rows_per_warp (32 or 64) and bn (16, 32 or 48) pick the
// tile, 0 for the default.
extern "C" cudaError_t mivp_conv3x3(
    const void* xa, const void* xb, const void* w, const void* bias,
    const void* scale, const void* shift, void* out, int b, int h, int w_,
    int d, int ca, int cb, int co, int affine, int leaky, int out_f32,
    int rows_per_warp, int bn, void* stream) {
  if (b < 1 || h < 1 || w_ < 1 || d < 1 || ca < kChunk || ca % kChunk != 0 ||
      cb < 0 || cb % kChunk != 0 || co < 16 || co % 16 != 0 ||
      (cb > 0) != (xb != nullptr) ||
      (affine && (scale == nullptr || shift == nullptr)))
    return cudaErrorInvalidValue;
  const Tile t = choose(h, d, co, rows_per_warp, bn);
  if (!tile_ok(t, co)) return cudaErrorInvalidValue;
  ConvArgs a;
  a.xa = static_cast<const bf16*>(xa);
  a.xb = static_cast<const bf16*>(xb);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = out;
  a.b = b;
  a.h = h;
  a.w_ = w_;
  a.d = d;
  a.ca = ca;
  a.cb = cb;
  a.co = co;
  a.th = t.th;
  a.td = t.td;
  a.nbh = (h + t.th - 1) / t.th;
  a.nbw = (w_ + kTW - 1) / kTW;
  a.nbd = (d + t.td - 1) / t.td;
  a.affine = affine != 0;
  a.leaky = leaky != 0;
  a.out_f32 = out_f32 != 0;
  const long bricks = (long)b * a.nbh * a.nbw * a.nbd;
  if (bricks >= (1L << 31)) return cudaErrorInvalidValue;
  KernelFn fn = kernel_of(t.mt, t.nt8);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3((unsigned)bricks, co / (8 * t.nt8)), kThreads, t.smem,
       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// What a launch at this geometry and tile uses: info[0] CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [1] registers per
// thread, [2] local (spill) bytes per thread, [3] dynamic shared memory
// per CTA, [4] CTAs of the grid, [5] rows per warp, [6] BN.
extern "C" cudaError_t mivp_conv3x3_info(int b, int h, int w_, int d, int co,
                                         int rows_per_warp, int bn,
                                         int* info) {
  const Tile t = choose(h, d, co, rows_per_warp, bn);
  if (b < 1 || h < 1 || w_ < 1 || d < 1 || co % 16 != 0 || !tile_ok(t, co))
    return cudaErrorInvalidValue;
  KernelFn fn = kernel_of(t.mt, t.nt8);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(info, fn, kThreads,
                                                      t.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)t.smem;
  info[4] = b * ((h + t.th - 1) / t.th) * ((w_ + kTW - 1) / kTW) *
            ((d + t.td - 1) / t.td) * (co / (8 * t.nt8));
  info[5] = 16 * t.mt;
  info[6] = 8 * t.nt8;
  return cudaSuccess;
}
