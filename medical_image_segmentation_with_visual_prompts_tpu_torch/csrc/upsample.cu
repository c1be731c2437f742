// Trilinear upsample of a channels-last volume with a crop, and the
// downstream seg head (inference BatchNorm + 3x3x3 conv) as its epilogue,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package resizes with per-axis einsums
// against dense interpolation matrices (ops/resize.py), and so did the
// port, which copied each matrix from the host to the card at every call
// (a stream sync each) and wrote every axis' result, the crop's copy and
// the head's fp32 casts and affine to device memory.  This kernel takes
// the place of that chain in the serving forward (ops/upsample.py):
//
//   plain form:  y = crop(resize(x))                     (SwinUpBlock)
//   head form:   logits = conv3x3x3_same(S(y * scale + shift)) + bias
//                (SwinUnetR._head after the final x2 upsample; y the
//                full-size upsample, never written to device memory; S
//                the trunk's dtype, bf16 or fp32, which is T but where
//                an fp32 decoder output feeds a bf16 head)
//
// It keeps every rounding point of the plain chain: the axes in the order
// H, W, D, each written in the storage dtype T (bf16 or fp32) as each
// einsum writes it, with fp32 products and sums; weights equal to
// interp_matrix's float32 entries rounded to T, computed here from the
// output index in double precision with the same formula, so no matrix
// is sent to the card; the folded BatchNorm as a multiply then an add in
// fp32 (no fused multiply-add), rounded to S; zero "same" padding of the
// normalised tensor; S weights and bias with fp32 sums, the logits
// rounded to S and stored as fp32.
//
// What bounds it on the H100: bytes.  The plain form reads its input and
// writes its output once (16-byte loads and stores, channels fastest; the
// up to 8 input vectors of an output vector come through L1).  The head
// form reads x (1.6 MB per 64x64x4x48 bf16 window) and writes the fp32
// logits (1 MB for 2 classes at 128x128x8), where the chain it replaces
// moved about 240 MB per window; its 27 x C x K multiply-adds per output
// voxel run on the CUDA cores from shared memory.  Design of the head
// form: one CTA of 128 threads per window and 8x8x8 output tile; per chunk
// of 16 bytes of input channels (8 bf16 or 4 fp32), the input tile is
// staged in shared memory with 16-byte loads, the H pass writes the
// tile's H-upsampled rows (its one-voxel halo included), the W and D
// passes and the BatchNorm write the normalised 10x10x10 halo tile in
// fp32 (zero outside the volume), and each thread adds the chunk's
// contributions to 4 consecutive depth outputs of one (h, w) column for
// every class from registers (each input vector it loads serves 3 depth
// taps).  Static shared memory stays under 48 KB, so no launch sets a
// function attribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPlainThreads = 256;
constexpr int kPlainMaxCtas = 2048;
constexpr int kMaxTaps = 1024;     // plain form: oh + ow + od
constexpr int kHeadThreads = 128;
constexpr int kTile = 8;           // head form: output tile edge
constexpr int kHalo = kTile + 2;   // ... with its one-voxel halo
constexpr int kHbVox = 512;        // head form: H-pass vectors per chunk
constexpr int kMaxClasses = 4;     // head form: classes per launch

// One output index's interpolation along an axis: interp_matrix's row.
struct Tap {
  int lo, hi;   // lo = -1: the index lies outside the volume (head halo)
  float wl, wh;
};

__host__ __device__ inline double dadd(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

__host__ __device__ inline double dmul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

__host__ __device__ inline double ddiv(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}

// ops/resize.py::interp_matrix's row `o` (float64 source index, its
// float32 entries; where lo == hi, numpy's float32 sum of the two).
__host__ __device__ inline Tap axis_tap(int o, int in, int out, bool ac) {
  Tap t;
  if (in == 1) {
    t.lo = t.hi = 0;
    t.wl = 1.f;
    t.wh = 0.f;
    return t;
  }
  double src;
  if (ac) {
    src = ddiv((double)o * (double)(in - 1),
               (double)(out - 1 > 1 ? out - 1 : 1));
  } else {
    src = dadd(ddiv(dmul(dadd((double)o, 0.5), (double)in), (double)out),
               -0.5);
    if (src < 0.0) src = 0.0;
  }
  int lo = (int)floor(src);
  if (lo > in - 1) lo = in - 1;
  t.lo = lo;
  t.hi = lo + 1 < in - 1 ? lo + 1 : in - 1;
  const double w = dadd(src, -(double)lo);
  const float fl = (float)dadd(1.0, -w), fh = (float)w;
  if (t.lo == t.hi) {
    t.wl = fl + fh;
    t.wh = 0.f;
  } else {
    t.wl = fl;
    t.wh = fh;
  }
  return t;
}

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Storage dtype T: 16 bytes hold N values.
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static float round(float v) { return round_bf16(v); }
  __device__ static void load(const uint4& u, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static float round(float v) { return v; }
  __device__ static void load(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// A tap's weights as the plain path multiplies them: rounded to T.
template <typename T>
__device__ inline Tap weights_in(Tap t) {
  t.wl = Vec<T>::round(t.wl);
  t.wh = Vec<T>::round(t.wh);
  return t;
}

// One axis of the resize on N values: the einsum's fp32 products and sum,
// written in T.
template <typename T>
__device__ inline void lerp(const Tap& t, const float (&a)[Vec<T>::N],
                            const float (&b)[Vec<T>::N],
                            float (&out)[Vec<T>::N]) {
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i)
    out[i] = Vec<T>::round(__fadd_rn(__fmul_rn(t.wl, a[i]),
                                     __fmul_rn(t.wh, b[i])));
}

struct Dims {
  int b, h, w, d, c;      // input [B, H, W, D, C]
  int fh, fw, fd;         // resized sizes (the interpolation's)
  int oh, ow, od;         // output sizes (the crop, <= the resized)
  bool ac;                // align_corners
};

// An axis the plain path leaves alone (its size unchanged): no einsum,
// no rounding.
__device__ inline bool same(int in, int out) { return in == out; }

// ---------------------------------------------------------------- plain

template <typename T>
__global__ void __launch_bounds__(kPlainThreads)
    upsample_kernel(const T* __restrict__ x, T* __restrict__ out, Dims a) {
  constexpr int N = Vec<T>::N;
  __shared__ Tap taps[kMaxTaps];
  const int nt = a.oh + a.ow + a.od;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int axis = i < a.oh ? 0 : i < a.oh + a.ow ? 1 : 2;
    const int o = i - (axis > 0 ? a.oh : 0) - (axis > 1 ? a.ow : 0);
    const int in = axis == 0 ? a.h : axis == 1 ? a.w : a.d;
    const int full = axis == 0 ? a.fh : axis == 1 ? a.fw : a.fd;
    taps[i] = weights_in<T>(axis_tap(o, in, full, a.ac));
  }
  __syncthreads();
  const bool sh = same(a.h, a.fh), sw = same(a.w, a.fw), sd = same(a.d, a.fd);
  const int nv = a.c / N;
  const long long total = (long long)a.b * a.oh * a.ow * a.od * nv;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(idx % nv);
    long long r = idx / nv;
    const int z = (int)(r % a.od);
    r /= a.od;
    const int y = (int)(r % a.ow);
    r /= a.ow;
    const int hh = (int)(r % a.oh);
    const int bb = (int)(r / a.oh);
    const Tap th = taps[hh], tw = taps[a.oh + y], td = taps[a.oh + a.ow + z];
    const int hs[2] = {sh ? hh : th.lo, sh ? hh : th.hi};
    const int ws[2] = {sw ? y : tw.lo, sw ? y : tw.hi};
    const int ds[2] = {sd ? z : td.lo, sd ? z : td.hi};
    float wv[2][N];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && sd) break;
      float hv[2][N];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && sw) break;
        float p[2][N];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == 1 && sh) break;
          const size_t off =
              ((((size_t)bb * a.h + hs[k]) * a.w + ws[i]) * a.d + ds[j]) *
                  a.c + (size_t)v * N;
          Vec<T>::load(__ldg(reinterpret_cast<const uint4*>(x + off)), p[k]);
        }
        if (sh) {
#pragma unroll
          for (int n = 0; n < N; ++n) hv[i][n] = p[0][n];
        } else {
          lerp<T>(th, p[0], p[1], hv[i]);
        }
      }
      if (sw) {
#pragma unroll
        for (int n = 0; n < N; ++n) wv[j][n] = hv[0][n];
      } else {
        lerp<T>(tw, hv[0], hv[1], wv[j]);
      }
    }
    float o[N];
    if (sd) {
#pragma unroll
      for (int n = 0; n < N; ++n) o[n] = wv[0][n];
    } else {
      lerp<T>(td, wv[0], wv[1], o);
    }
    *reinterpret_cast<uint4*>(out + (size_t)idx * N) = Vec<T>::pack(o);
  }
}

// ----------------------------------------------------------------- head

struct HeadArgs {
  const void* x;          // [B, H, W, D, C], T
  const float* scale;     // [C]: the folded BatchNorm
  const float* shift;     // [C]
  const float4* wk;       // [C / N, 27, N / 4, K] float4 (ops/upsample.py)
  const float* bias;      // [K], rounded to S
  float* out;             // [B, oh, ow, od, k_total] at class k0
  Dims a;
  int k_total;
  bool s_bf16;            // S, the head's dtype: bf16 (else fp32)
  int nth, ntw, ntd;      // output tiles along each axis
};

// The F buffer's column (one (h, w) of the halo tile, kHalo depths of
// N fp32 channels) in float4 units, padded to an odd count so the 8
// columns a quarter warp reads lie in distinct bank groups.
template <typename T>
__host__ __device__ constexpr int fcol() {
  return kHalo * (Vec<T>::N / 4) + 1;
}

// Input vectors one output tile's halo reads along an axis (host check).
inline int tile_inputs(int o0, int in, int full, int out, bool ac) {
  int first = -1, last = -1;
  for (int p = 0; p < kHalo; ++p) {
    const int o = o0 - 1 + p;
    if (o < 0 || o >= out) continue;
    if (in == full) {
      if (first < 0) first = o;
      last = o;
      continue;
    }
    const Tap t = axis_tap(o, in, full, ac);
    if (first < 0) first = t.lo;
    last = t.hi;
  }
  return first < 0 ? 0 : last - first + 1;
}

inline int max_tile_inputs(int in, int full, int out, bool ac) {
  int m = 0;
  for (int o0 = 0; o0 < out; o0 += kTile) {
    const int n = tile_inputs(o0, in, full, out, ac);
    if (n > m) m = n;
  }
  return m;
}

template <typename T, int K>
__global__ void __launch_bounds__(kHeadThreads)
    upsample_head_kernel(HeadArgs args) {
  constexpr int N = Vec<T>::N;
  constexpr int NQ = N / 4;
  constexpr int FC = fcol<T>();
  const Dims& a = args.a;
  __shared__ float4 fbuf[kHalo * kHalo * FC];   // F; first the input tile
  __shared__ uint4 hbuf[kHbVox];                // the H pass, in T
  __shared__ float4 wbuf[27 * NQ * K];
  __shared__ float sc[N], sf[N];
  __shared__ Tap taps[3][kHalo];
  __shared__ int base[3], nin[3];
  uint4* xbuf = reinterpret_cast<uint4*>(fbuf);

  int t = blockIdx.x;
  const int tz = t % args.ntd;
  t /= args.ntd;
  const int ty = t % args.ntw;
  t /= args.ntw;
  const int tx = t % args.nth;
  const int bb = t / args.nth;
  const int o0[3] = {tx * kTile, ty * kTile, tz * kTile};
  const int ins[3] = {a.h, a.w, a.d};
  const int fulls[3] = {a.fh, a.fw, a.fd};
  const int outs[3] = {a.oh, a.ow, a.od};
  const int tid = threadIdx.x;
  if (tid < 3 * kHalo) {
    const int axis = tid / kHalo, p = tid % kHalo;
    const int o = o0[axis] - 1 + p;
    Tap tp;
    if (o < 0 || o >= outs[axis]) {
      tp.lo = tp.hi = -1;
      tp.wl = tp.wh = 0.f;
    } else if (same(ins[axis], fulls[axis])) {
      tp.lo = tp.hi = o;
      tp.wl = 1.f;
      tp.wh = 0.f;
    } else {
      tp = weights_in<T>(axis_tap(o, ins[axis], fulls[axis], a.ac));
    }
    taps[axis][p] = tp;
  }
  __syncthreads();
  if (tid < 3) {
    int first = -1, last = -1;
    for (int p = 0; p < kHalo; ++p) {
      if (taps[tid][p].lo < 0) continue;
      if (first < 0) first = taps[tid][p].lo;
      last = taps[tid][p].hi;
    }
    base[tid] = first < 0 ? 0 : first;
    nin[tid] = first < 0 ? 0 : last - first + 1;
  }
  __syncthreads();
  const bool sh = same(a.h, a.fh), sw = same(a.w, a.fw), sd = same(a.d, a.fd);
  const int nh = nin[0], nw = nin[1], nd = nin[2];
  const int col = tid % (kTile * kTile), dz = tid / (kTile * kTile);
  const int lh = col / kTile, lw = col % kTile;

  float acc[4][K];
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[o][k] = 0.f;

  const T* x = static_cast<const T*>(args.x);
  for (int c0 = 0; c0 < a.c; c0 += N) {
    // Stage: the input tile's vectors of this chunk, its weights and
    // BatchNorm factors.
    for (int i = tid; i < nh * nw * nd; i += kHeadThreads) {
      const int id = i % nd, iw = (i / nd) % nw, ih = i / (nd * nw);
      const size_t off = ((((size_t)bb * a.h + base[0] + ih) * a.w + base[1] +
                           iw) * a.d + base[2] + id) * a.c + c0;
      xbuf[i] = __ldg(reinterpret_cast<const uint4*>(x + off));
    }
    for (int i = tid; i < 27 * NQ * K; i += kHeadThreads)
      wbuf[i] = args.wk[(size_t)(c0 / N) * 27 * NQ * K + i];
    if (tid < N) {
      sc[tid] = args.scale[c0 + tid];
      sf[tid] = args.shift[c0 + tid];
    }
    __syncthreads();
    // H pass: the halo rows' H-upsampled vectors, in T.
    for (int i = tid; i < kHalo * nw * nd; i += kHeadThreads) {
      const int p = i / (nw * nd), r = i % (nw * nd);
      const Tap th = taps[0][p];
      if (th.lo < 0) continue;
      if (sh) {
        hbuf[i] = xbuf[(th.lo - base[0]) * nw * nd + r];
        continue;
      }
      float u[N], v[N], h[N];
      Vec<T>::load(xbuf[(th.lo - base[0]) * nw * nd + r], u);
      Vec<T>::load(xbuf[(th.hi - base[0]) * nw * nd + r], v);
      lerp<T>(th, u, v, h);
      hbuf[i] = Vec<T>::pack(h);
    }
    __syncthreads();
    // W and D passes and the BatchNorm: the normalised halo tile, fp32,
    // zero outside the volume.
    for (int i = tid; i < kHalo * kHalo * kHalo; i += kHeadThreads) {
      const int pd = i % kHalo, pw = (i / kHalo) % kHalo, ph = i / (kHalo * kHalo);
      const Tap tw = taps[1][pw], td = taps[2][pd];
      float f[N];
      if (taps[0][ph].lo < 0 || tw.lo < 0 || td.lo < 0) {
#pragma unroll
        for (int n = 0; n < N; ++n) f[n] = 0.f;
      } else {
        const int row = ph * nw;
        float wv[2][N];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j == 1 && sd) break;
          const int dd = (j ? td.hi : td.lo) - base[2];
          float u[N], v[N];
          Vec<T>::load(hbuf[(row + tw.lo - base[1]) * nd + dd], u);
          if (sw) {
#pragma unroll
            for (int n = 0; n < N; ++n) wv[j][n] = u[n];
          } else {
            Vec<T>::load(hbuf[(row + tw.hi - base[1]) * nd + dd], v);
            lerp<T>(tw, u, v, wv[j]);
          }
        }
        if (sd) {
#pragma unroll
          for (int n = 0; n < N; ++n) f[n] = wv[0][n];
        } else {
          lerp<T>(td, wv[0], wv[1], f);
        }
#pragma unroll
        for (int n = 0; n < N; ++n) {
          f[n] = __fadd_rn(__fmul_rn(f[n], sc[n]), sf[n]);
          if (args.s_bf16) f[n] = round_bf16(f[n]);
        }
      }
      float4* dst = fbuf + (ph * kHalo + pw) * FC + pd * NQ;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        dst[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
    }
    __syncthreads();
    // The conv's products for this chunk: 4 depth outputs x K classes.
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float4* fc = fbuf + ((lh + kh) * kHalo + lw + kw) * FC + 4 * dz * NQ;
        const float4* wt = wbuf + (kh * 3 + kw) * 3 * NQ * K;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float4 v[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) v[j] = fc[j * NQ + q];
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float4 w = wt[(kd * NQ + q) * K + k];
#pragma unroll
              for (int o = 0; o < 4; ++o) {
                float s = acc[o][k];
                s = fmaf(v[o + kd].x, w.x, s);
                s = fmaf(v[o + kd].y, w.y, s);
                s = fmaf(v[o + kd].z, w.z, s);
                s = fmaf(v[o + kd].w, w.w, s);
                acc[o][k] = s;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  // Epilogue: the bias, the logits rounded to S, stored as fp32.
  const int hh = o0[0] + lh, ww = o0[1] + lw;
  if (hh >= a.oh || ww >= a.ow) return;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int dd = o0[2] + 4 * dz + o;
    if (dd >= a.od) break;
    float* dst = args.out +
                 ((((size_t)bb * a.oh + hh) * a.ow + ww) * a.od + dd) *
                     args.k_total;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = __fadd_rn(acc[o][k], args.bias[k]);
      dst[k] = args.s_bf16 ? round_bf16(v) : v;
    }
  }
}

typedef void (*HeadFn)(HeadArgs);

template <typename T>
HeadFn head_kernel(int k) {
  switch (k) {
    case 1: return upsample_head_kernel<T, 1>;
    case 2: return upsample_head_kernel<T, 2>;
    case 3: return upsample_head_kernel<T, 3>;
    case 4: return upsample_head_kernel<T, 4>;
    default: return nullptr;
  }
}

bool dims_ok(const Dims& a, int vec) {
  return a.b >= 1 && a.h >= 1 && a.w >= 1 && a.d >= 1 && a.c >= vec &&
         a.c % vec == 0 && a.oh >= 1 && a.ow >= 1 && a.od >= 1 &&
         a.oh <= a.fh && a.ow <= a.fw && a.od <= a.fd;
}

Dims make_dims(int b, int h, int w, int d, int c, int fh, int fw, int fd,
               int oh, int ow, int od, int ac) {
  Dims a;
  a.b = b;
  a.h = h;
  a.w = w;
  a.d = d;
  a.c = c;
  a.fh = fh;
  a.fw = fw;
  a.fd = fd;
  a.oh = oh;
  a.ow = ow;
  a.od = od;
  a.ac = ac != 0;
  return a;
}

}  // namespace

// Plain form: out [B, oh, ow, od, C] = the first (oh, ow, od) of x [B, h,
// w, d, C] resized to (fh, fw, fd), in x's dtype (fp32 when x_f32, else
// bf16).
extern "C" cudaError_t mivp_upsample(const void* x, void* out, int b, int h,
                                     int w, int d, int c, int fh, int fw,
                                     int fd, int oh, int ow, int od, int ac,
                                     int x_f32, void* stream) {
  const Dims a = make_dims(b, h, w, d, c, fh, fw, fd, oh, ow, od, ac);
  const int vec = x_f32 ? 4 : 8;
  if (!dims_ok(a, vec) || oh + ow + od > kMaxTaps) return cudaErrorInvalidValue;
  const long long total = (long long)b * oh * ow * od * (c / vec);
  const long long want = (total + kPlainThreads - 1) / kPlainThreads;
  const unsigned ctas = (unsigned)(want < kPlainMaxCtas ? want : kPlainMaxCtas);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    upsample_kernel<float><<<ctas, kPlainThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a);
  else
    upsample_kernel<bf16><<<ctas, kPlainThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), a);
  return cudaGetLastError();
}

// Head form: out [B, oh, ow, od, k_total] fp32, classes [k0, k0 + k) at
// `out` (the caller offsets it by k0), of the 3x3x3 "same" conv (weights
// `wk`, ops/upsample.py::kernel_operands; `bias` [k]) of the upsampled x
// normalised by scale/shift and rounded to S (bf16 when s_bf16, else
// fp32).  k <= 4.
extern "C" cudaError_t mivp_upsample_head(
    const void* x, const void* scale, const void* shift, const void* wk,
    const void* bias, void* out, int b, int h, int w, int d, int c, int fh,
    int fw, int fd, int oh, int ow, int od, int ac, int k, int k_total,
    int x_f32, int s_bf16, void* stream) {
  HeadArgs args;
  args.a = make_dims(b, h, w, d, c, fh, fw, fd, oh, ow, od, ac);
  const int vec = x_f32 ? 4 : 8;
  if (!dims_ok(args.a, vec) || k < 1 || k > kMaxClasses || k_total < k)
    return cudaErrorInvalidValue;
  const bool acb = ac != 0;
  const int nh = max_tile_inputs(h, fh, oh, acb);
  const int nw = max_tile_inputs(w, fw, ow, acb);
  const int nd = max_tile_inputs(d, fd, od, acb);
  const int fcols = kHalo * kHalo * (x_f32 ? fcol<float>() : fcol<bf16>());
  if (nh * nw * nd > fcols || kHalo * nw * nd > kHbVox)
    return cudaErrorInvalidValue;
  args.x = x;
  args.scale = static_cast<const float*>(scale);
  args.shift = static_cast<const float*>(shift);
  args.wk = static_cast<const float4*>(wk);
  args.bias = static_cast<const float*>(bias);
  args.out = static_cast<float*>(out);
  args.k_total = k_total;
  args.s_bf16 = s_bf16 != 0;
  args.nth = (oh + kTile - 1) / kTile;
  args.ntw = (ow + kTile - 1) / kTile;
  args.ntd = (od + kTile - 1) / kTile;
  const long long ctas = (long long)b * args.nth * args.ntw * args.ntd;
  if (ctas >= (1LL << 31)) return cudaErrorInvalidValue;
  HeadFn fn = x_f32 ? head_kernel<float>(k) : head_kernel<bf16>(k);
  fn<<<(unsigned)ctas, kHeadThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return cudaGetLastError();
}
