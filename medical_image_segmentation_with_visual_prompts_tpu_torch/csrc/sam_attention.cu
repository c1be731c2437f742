// S1: MedSAM's image-encoder attention core with the decomposed relative
// position bias inside, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no SAM.  The port computed
// this core (models/sam.py::Attention, after the qkv linear and before
// proj) as q' = [q / 8, q . Rh, q . Rw] and k' = [k, onehot(kh),
// onehot(kw)] concatenated in bf16 and handed to cuDNN's fused attention:
// the concatenations, the head split and the 3x wider QK product took
// about 74 ms of a 158 ms study.  This kernel computes, for each image or
// window b, head n and query i of an h x w grid (keys j):
//
//   s[i, j] = (q_i . k_j) / 8 + q_i . Rh[qh_i - kh_j + h - 1]
//                             + q_i . Rw[qw_i - kw_j + w - 1]
//   o_i     = softmax_j(s[i, .]) v
//
// It reads q, k and v in place from the qkv linear's output [B, h w, 3,
// heads, 64] and writes o into [B, h w, heads 64], the layout proj takes.
// The tables come as the model's gathered [side, side, 64] form
// (Attention.rel_table: T[qh, kh] = Rh[qh - kh + side - 1]), whose first
// row and column hold every row of Rh.
//
// What bounds it on the H100: in the global blocks (64 x 64 grids, 4,096
// keys) the two products, 2 x 2 x 64 FLOPs per score: operations, 0.85 ms
// a call of 16 images at the bf16 peak.  At head size 64 each score also
// costs about six instructions of softmax (scale and bias, max, shift,
// exp2, sum, conversion), as many issue slots as its products take on the
// tensor cores, so the kernel is only as fast as the two overlap.  In the
// windowed blocks (14 x 14 windows, 196 keys) bytes: q, k, v read and o
// written once.
//
// Design (bf16): one CTA per (b, head, block of query rows): consumer
// warpgroups of 64 query rows each (three in the global blocks, two in
// the windows) and one producer warp.  The producer loads the query tiles
// and a ring of K/V tiles of 64 keys by TMA from the strided qkv tensor
// (one 2-D tensor map [B h w, 3 C], 128-byte swizzle, no copy),
// completing on mbarriers; the consumers run QK^T and PV on wgmma (Q and K
// from shared memory, P from registers as bf16, V as the MN-major B
// operand).  In the global blocks QK(t) and PV(t - 1) are issued together
// and the softmax of tile t runs while PV(t - 1) is on the tensor cores.
// The softmax is online, in fp32 on exp2 with the scale folded; a row's
// reference maximum is raised only when a tile passes it by more than 8
// (log2 units), so o is rarely rescaled.  The bias: each consumer's
// prologue computes q . R for all 2 side - 1 rows of both tables on the
// tensor cores (the tables staged in shared memory in the swizzled
// K-major layout) and scatters it along the Toeplitz diagonal into
// rel_h[i, kh] and rel_w[i, kw] (fp32, shared memory, log2 e folded in);
// q . R never reaches device memory.  Two geometries from one source;
// the wrapper (ops/sam_attention.py::kernel_form) chooses one from the
// input's own (h, w) and passes it, and each refuses a grid its shared
// memory does not hold:
//   * row tiles (w = 64, h <= 64: the global blocks): a 64-key tile is
//     one grid row kh and a 64-row query tile one grid row qh, so a
//     tile's bias is rel_h[i, kh] (two loads a tile) plus rel_w[i, kw],
//     the same for every key tile and held in registers;
//   * windows (h, w <= 16: the 14 x 14 windows of the 70 x 70 padded
//     grid): keys padded to the tile and the tail masked; each key's (kh,
//     kw) from a table in shared memory; one product at a time, two CTAs
//     per SM.  The padded tokens of the grid are ordinary keys and
//     queries, as SAM has them.
// fp32 (an fp32 model): one thread pair per query on the CUDA cores, K/V
// tiles in shared memory, fp32 products and sums; no speed target.  No
// atomics: two runs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHd = 64;                      // head dim (both instances)
constexpr int kTile = 64;                    // query rows per consumer, keys per tile
constexpr int kTileBytes = kTile * kHd * 2;  // one bf16 64 x 64 tile
constexpr int kMaxWinKeys = 256;             // window form: keys per sequence
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLazy = 8.f;                 // log2 units a row's max may lag

template <bool kRows>
struct Geo {
  // Consumer warpgroups (64 query rows each) and threads: the global
  // grids take three, the 196-row windows two, and one producer warp.
  static constexpr int kConsumers = kRows ? 3 : 2;
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kQRows = kConsumers * kTile;   // query rows per CTA
  static constexpr int kTab = kRows ? 128 : 64;   // table rows (>= 2 side - 1)
  static constexpr int kSide = kRows ? 64 : 16;   // largest h and w
  static constexpr int kRel = kSide + 1;          // fp32 stride of rel_h/rel_w rows
  static constexpr int kStages = kRows ? 4 : 3;   // K/V ring
  static constexpr int kMinBlocks = kRows ? 1 : 2;
  // Shared memory, from a 1024-byte aligned base (swizzled tiles first).
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + kConsumers * kTileBytes;
  static constexpr int kTabH = kKV + kStages * 2 * kTileBytes;
  static constexpr int kTabW = kTabH + kTab * 128;
  static constexpr int kRelH = kTabW + kTab * 128;
  static constexpr int kRelW = kRelH + kConsumers * kTile * kRel * 4;
  static constexpr int kKeys = kRelW + kConsumers * kTile * kRel * 4;
  static constexpr int kBars = kKeys + (kRows ? 0 : kMaxWinKeys * 4);
  static constexpr int kEnd = kBars + (2 * kStages + kConsumers) * 8;
  static constexpr int kSmem = kEnd + 1024;       // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete.  A wait that never
// ends (a fault of the kernel) traps, so the launch fails and the process
// goes on, where it would otherwise hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int spins = 0; !mbar_try(bar, parity); ++spins)
    if (spins > (1 << 24)) __trap();
}

// 2-D TMA load of a box at (column c0, row c1) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}


// Generic-proxy shared memory accesses before async-proxy ones (wgmma, TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------------- wgmma
// Shared memory descriptor of a K-major (or, as B, MN-major) tile of
// 128-byte rows in the 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  uint64_t d = (uint64_t)((a & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;      // stride byte offset
  d |= (uint64_t)1 << 62;                // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MIVP_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MIVP_D32                                                            \
  MIVP_D4(0), MIVP_D4(4), MIVP_D4(8), MIVP_D4(12), MIVP_D4(16), MIVP_D4(20), \
      MIVP_D4(24), MIVP_D4(28)
#define MIVP_R32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIVP_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MIVP_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64], B MN-major in shared
// memory (rows of 64 consecutive N values).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MIVP_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MIVP_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element e of a thread (m64nN layout): row within the
// warpgroup's 64 and column within the 64.
__device__ __forceinline__ int acc_row(int warp, int lane, int e) {
  return warp * 16 + (lane >> 2) + ((e & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
}

struct Args {
  const bf16* tab_h;   // [h, h, 64]
  const bf16* tab_w;   // [w, w, 64]
  bf16* out;           // [B, L, heads 64]
  int L, h, w, heads, nk;
};

// q . R for the 2 side - 1 rows of a table, scattered into rel[row, k]
// (k = kh or kw) along the diagonal: rel[i, k] = (q_i . R[p_i - k + side -
// 1]) log2 e, p_i = qh_i or qw_i.
template <bool kRows>
__device__ __forceinline__ void rel_terms(const uint8_t* q_tile, const uint8_t* tab,
                                          float* rel, int side, int q0, int w,
                                          bool by_row, int warp, int lane) {
  using G = Geo<kRows>;
  const uint64_t dq = smem_desc(q_tile);
  // The grid row (or column) of the thread's two accumulator rows.
  const int i0 = q0 + acc_row(warp, lane, 0), i1 = i0 + 8;
  const int p0 = by_row ? i0 / w : i0 % w, p1 = by_row ? i1 / w : i1 % w;
#pragma unroll 1
  for (int half = 0; half < G::kTab / 64; ++half) {
    float d[32];
    const uint64_t dt = smem_desc(tab + half * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kHd / 16; ++k) wgmma_ss(d, dq + 2 * k, dt + 2 * k, k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int k = ((e & 2) ? p1 : p0) + side - 1 - (half * 64 + acc_col(lane, e));
      if (k >= 0 && k < side)
        rel[acc_row(warp, lane, e) * G::kRel + k] = d[e] * kLog2e;
    }
  }
}

template <bool kRows>
__global__ void __launch_bounds__(Geo<kRows>::kThreads, Geo<kRows>::kMinBlocks)
    sam_attention_kernel(const __grid_constant__ CUtensorMap qkv_map,
                         const Args args) {
  using G = Geo<kRows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBars);
  uint64_t* empty = full + G::kStages;
  uint64_t* qfull = empty + G::kStages;

  const int L = args.L, h = args.h, w = args.w, nk = args.nk;
  const int head = blockIdx.y, b = blockIdx.z;
  const int C = args.heads * kHd;
  const int row0 = b * L;                // this sequence's first row of qkv
  const int qb = blockIdx.x * G::kQRows; // first query row of the CTA
  const int warp_all = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G::kConsumers * 4);
    }
    for (int c = 0; c < G::kConsumers; ++c) mbar_init(&qfull[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_all == G::kConsumers * 4) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      for (int c = 0; c < G::kConsumers; ++c) {
        mbar_expect_tx(&qfull[c], kTileBytes);
        tma_load(smem + G::kQ + c * kTileBytes, &qkv_map, &qfull[c],
                 head * kHd, row0 + qb + c * kTile);
      }
      for (int t = 0; t < nk; ++t) {
        const int s = t % G::kStages;
        if (t >= G::kStages) mbar_wait(&empty[s], ((t / G::kStages) - 1) & 1);
        uint8_t* kv = smem + G::kKV + s * 2 * kTileBytes;
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load(kv, &qkv_map, &full[s], C + head * kHd, row0 + t * kTile);
        tma_load(kv + kTileBytes, &qkv_map, &full[s], 2 * C + head * kHd,
                 row0 + t * kTile);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  // The consumer warpgroup, as a value the compiler knows is the same
  // across the warp: the wgmma descriptors built from it then live in
  // uniform registers (a per-thread one would serialise the wgmmas).
  const int c = __shfl_sync(0xffffffffu, warp_all >> 2, 0);
  const int warp = warp_all & 3;         // warp within it
  const int tid = threadIdx.x;           // numbered over all consumers
  const int q0 = qb + c * kTile;         // its first query row
  uint8_t* tab_h = smem + G::kTabH;
  uint8_t* tab_w = smem + G::kTabW;
  float* rel_h = reinterpret_cast<float*>(smem + G::kRelH) + c * kTile * G::kRel;
  float* rel_w = reinterpret_cast<float*>(smem + G::kRelW) + c * kTile * G::kRel;
  int* keys = reinterpret_cast<int*>(smem + G::kKeys);

  // Both tables' rows R[0 .. 2 side - 2] (zeros after) in the swizzled
  // K-major layout: R[r] = T[0, side - 1 - r] for r < side, else T[r -
  // side + 1, 0].
  for (int idx = tid; idx < 2 * G::kTab * 8; idx += G::kConsumers * 128) {
    const int tbl = idx / (G::kTab * 8);
    const int r = (idx >> 3) % G::kTab, ch = idx & 7;
    const int side = tbl ? w : h;
    const bf16* T = tbl ? args.tab_w : args.tab_h;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < 2 * side - 1) {
      const long long row = r < side ? (side - 1 - r) : (long long)(r - side + 1) * side;
      v = *reinterpret_cast<const uint4*>(T + row * kHd + ch * 8);
    }
    *reinterpret_cast<uint4*>((tbl ? tab_w : tab_h) + r * 128 +
                              ((ch ^ (r & 7)) << 4)) = v;
  }
  if (!kRows) {
    for (int j = tid; j < kMaxWinKeys; j += G::kConsumers * 128)
      keys[j] = j < L ? ((j / w) | ((j % w) << 16)) : -1;
  }
  fence_async_smem();
  named_sync(1, G::kConsumers * 128);

  uint8_t* q_tile = smem + G::kQ + c * kTileBytes;
  mbar_wait(&qfull[c], 0);
  rel_terms<kRows>(q_tile, tab_h, rel_h, h, q0, w, true, warp, lane);
  rel_terms<kRows>(q_tile, tab_w, rel_w, w, q0, w, false, warp, lane);
  named_sync(2 + c, 128);

  const int r0 = acc_row(warp, lane, 0), r1 = r0 + 8;
  float bias_w[32];
  if (kRows) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      bias_w[e] = rel_w[acc_row(warp, lane, e) * G::kRel + acc_col(lane, e)];
  }

  const float scale = 0.125f * kLog2e;   // 1 / sqrt(64), in log2 units
  float o[32], sa[32];                   // o; a score tile
  uint32_t p[4][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  // Each row's reference maximum (log2 units) and sum.  The maximum is
  // raised only where a tile's maximum passes it by more than kLazy, so
  // most tiles leave o and l as they are; p stays under 2^kLazy.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float c0 = 1.f, c1 = 1.f;              // factors o takes for the new maxima
  const uint64_t dq = smem_desc(q_tile);

  // Key tile t's scores in x into its probabilities (fp32, in place).
  auto softmax = [&](float (&x)[32], int t) {
    float off0 = 0.f, off1 = 0.f;        // row constants: rel_h of the tile
    if (kRows) {
      off0 = rel_h[r0 * G::kRel + t];
      off1 = rel_h[r1 * G::kRel + t];
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] = fmaf(x[e], scale, bias_w[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = keys[t * kTile + acc_col(lane, e)];
        const int row = (e & 2) ? r1 : r0;
        x[e] = key < 0 ? -INFINITY
                       : fmaf(x[e], scale,
                              rel_h[row * G::kRel + (key & 0xFFFF)] +
                                  rel_w[row * G::kRel + (key >> 16)]);
      }
    }
    // Row maxima and sums in two partial chains a row (short dependency
    // chains: a few warps an SM sub-partition hide little latency).
    float mp[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = ((e >> 1) & 1) * 2 + ((e >> 2) & 1);   // row * 2 + chain
      mp[i] = fmaxf(mp[i], x[e]);
    }
    float mx0 = fmaxf(mp[0], mp[1]), mx1 = fmaxf(mp[2], mp[3]);
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    mx0 += off0;
    mx1 += off1;
    c0 = c1 = 1.f;
    if (mx0 > m0 + kLazy) {
      c0 = fast_exp2(m0 - mx0);
      m0 = mx0;
    }
    if (mx1 > m1 + kLazy) {
      c1 = fast_exp2(m1 - mx1);
      m1 = mx1;
    }
    const float b0 = m0 == -INFINITY ? 0.f : m0 - off0;
    const float b1 = m1 == -INFINITY ? 0.f : m1 - off1;
    float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      x[e] = fast_exp2(x[e] - ((e & 2) ? b1 : b0));
      sp[((e >> 1) & 1) * 2 + ((e >> 2) & 1)] += x[e];
    }
    l0 = fmaf(l0, c0, sp[0] + sp[1]);
    l1 = fmaf(l1, c1, sp[2] + sp[3]);
  };
  uint64_t dqs[4], dk[4], dv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dqs[k] = dq + 2 * k;
    asm volatile("" : "+l"(dqs[k]));
  }

  // The operands of a wgmma group are all defined before its wgmma.fence
  // (fence_acc, settle_pv): a register written between two of its wgmmas
  // would make the compiler serialise every wgmma of the kernel.
  auto settle_pv = [&]() {
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[kk][r])::"memory");
    }
  };
  // Descriptors of tile t's K (its 4 k-steps) and V (4 key steps).
  auto k_descs = [&](int t) {
    const uint64_t d0 =
        smem_desc(smem + G::kKV + (t % G::kStages) * 2 * kTileBytes);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dk[k] = d0 + 2 * k;                // 32 bytes along the head dim
      asm volatile("" : "+l"(dk[k]));
    }
  };
  auto v_descs = [&](int t) {
    const uint64_t d0 = smem_desc(smem + G::kKV +
                                  (t % G::kStages) * 2 * kTileBytes + kTileBytes);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dv[k] = d0 + 128 * k;              // 16 keys of 128 bytes
      asm volatile("" : "+l"(dv[k]));
    }
  };
  // QK(t) into x, issued once tile t has landed.
  auto issue_qk = [&](float (&x)[32], int t) {
    k_descs(t);
    mbar_wait(&full[t % G::kStages], (t / G::kStages) & 1);
    fence_acc(x);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kHd / 16; ++k) wgmma_ss(x, dqs[k], dk[k], k);
    wgmma_commit();
    fence_acc(x);
  };
  auto issue_pv = [&](int t) {
    v_descs(t);
    settle_pv();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(o, p[kk], dv[kk]);
    wgmma_commit();
    fence_acc(o);
  };
  // PV(t) done: its stage goes back to the producer.
  auto retire = [&](int t) {
    settle_pv();
    if (lane == 0) mbar_arrive(&empty[t % G::kStages]);
  };
  // Once no PV is in flight: o to the new maxima, and the probabilities
  // in x to the bf16 A fragments p of the next PV.
  auto take_p = [&](const float (&x)[32]) {
    if (c0 != 1.f || c1 != 1.f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[e] *= (e & 2) ? c1 : c0;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    }
  };

  if constexpr (kRows) {
    // Software pipeline: QK(t) and PV(t - 1) issued back to back, and the
    // softmax of tile t runs while PV(t - 1) is on the tensor cores.
    issue_qk(sa, 0);
    wgmma_wait<0>();
    fence_acc(sa);
    softmax(sa, 0);
    take_p(sa);
#pragma unroll 1
    for (int t = 1; t < nk; ++t) {
      issue_qk(sa, t);
      issue_pv(t - 1);
      wgmma_wait<1>();
      fence_acc(sa);
      softmax(sa, t);
      wgmma_wait<0>();
      retire(t - 1);
      take_p(sa);
    }
    issue_pv(nk - 1);
    wgmma_wait<0>();
    retire(nk - 1);
  } else {
    // Windows: a few tiles a CTA and two CTAs an SM; one product at a time
    // keeps the registers under the two-CTA bound.
#pragma unroll 1
    for (int t = 0; t < nk; ++t) {
      issue_qk(sa, t);
      wgmma_wait<0>();
      fence_acc(sa);
      softmax(sa, t);
      take_p(sa);
      issue_pv(t);
      wgmma_wait<0>();
      retire(t);
    }
  }

  // Epilogue: o / l in bf16, staged in the (now free) query tile with the
  // same swizzle, then 16-byte rows to device memory.
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  fence_async_smem();
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int row = acc_row(warp, lane, e), col = acc_col(lane, e);
    const float inv = (e & 2) ? inv1 : inv0;
    *reinterpret_cast<uint32_t*>(q_tile + row * 128 +
                                 ((((col >> 3) ^ (row & 7))) << 4) +
                                 (col & 7) * 2) =
        pack_bf16(o[e] * inv, o[e + 1] * inv);
  }
  named_sync(2 + c, 128);
  const int t128 = tid & 127;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int id = t128 + 128 * k;
    const int row = id >> 3, ch = id & 7;
    const int i = q0 + row;
    if (i < L) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          q_tile + row * 128 + ((ch ^ (row & 7)) << 4));
      *reinterpret_cast<uint4*>(args.out + ((long long)row0 + i) * C +
                                head * kHd + ch * 8) = v;
    }
  }
}

// ---------------------------------------------------------- fp32 instance
constexpr int kF32Threads = 128;    // 64 queries, a thread pair each
constexpr int kF32Keys = 32;        // keys per shared-memory tile
constexpr int kF32Side = 64;        // largest h and w
constexpr int kF32Rel = kF32Side + 1;
constexpr int kF32Row = 66;         // K/V row stride: the halves 33 apart
constexpr int kF32Smem =
    (2 * 64 * kF32Rel + 2 * kF32Keys * kF32Row) * (int)sizeof(float);

__global__ void __launch_bounds__(kF32Threads)
    sam_attention_f32_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ tab_h,
                             const float* __restrict__ tab_w,
                             float* __restrict__ out, int L, int h, int w,
                             int heads) {
  extern __shared__ float fsm[];
  float* rel_h = fsm;                          // [64][kF32Rel]
  float* rel_w = rel_h + 64 * kF32Rel;
  float* ks = rel_w + 64 * kF32Rel;            // [kF32Keys][kF32Row]
  float* vs = ks + kF32Keys * kF32Row;
  const int head = blockIdx.y, b = blockIdx.z;
  const int C = heads * kHd;
  const int ql = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int i = blockIdx.x * 64 + ql;
  const bool valid = i < L;
  const int qh = valid ? i / w : 0, qw = valid ? i % w : 0;
  const long long row0 = (long long)b * L;
  float q[32], o[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    q[d] = valid ? qkv[(row0 + i) * 3 * C + head * kHd + half * 32 + d] : 0.f;
    o[d] = 0.f;
  }
  for (int k = 0; k < h; ++k) {
    const float* r = tab_h + ((long long)qh * h + k) * kHd + half * 32;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 32; ++d) acc = fmaf(q[d], r[d], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) rel_h[ql * kF32Rel + k] = acc;
  }
  for (int k = 0; k < w; ++k) {
    const float* r = tab_w + ((long long)qw * w + k) * kHd + half * 32;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 32; ++d) acc = fmaf(q[d], r[d], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) rel_w[ql * kF32Rel + k] = acc;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += kF32Keys) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Keys * 16; idx += kF32Threads) {
      const int r = idx >> 4, d4 = (idx & 15) * 4;
      const int col = d4 + (d4 >= 32 ? 1 : 0);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j0 + r < L) {
        const float* src = qkv + (row0 + j0 + r) * 3 * C + head * kHd + d4;
        kv = *reinterpret_cast<const float4*>(src + C);
        vv = *reinterpret_cast<const float4*>(src + 2 * C);
      }
      float* kd = ks + r * kF32Row + col;
      float* vd = vs + r * kF32Row + col;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();
    float s[kF32Keys];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      const float* kr = ks + jj * kF32Row + half * 33;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < 32; ++d) acc = fmaf(q[d], kr[d], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      const int j = j0 + jj;
      s[jj] = j < L ? acc * 0.125f + rel_h[ql * kF32Rel + j / w] +
                          rel_w[ql * kF32Rel + j % w]
                    : -INFINITY;
      mx = fmaxf(mx, s[jj]);
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int d = 0; d < 32; ++d) o[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      const float p = expf(s[jj] - mx);
      l += p;
      const float* vr = vs + jj * kF32Row + half * 33;
#pragma unroll
      for (int d = 0; d < 32; ++d) o[d] = fmaf(p, vr[d], o[d]);
    }
  }
  if (valid) {
    float* dst = out + (row0 + i) * C + head * kHd + half * 32;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < 32; ++d) dst[d] = o[d] * inv;
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, from the libcuda the process has
// loaded (the library links no driver stub).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  });
  return fn;
}

// The forms ops/sam_attention.py::kernel_form chooses (its FORMS).
enum Form { kFormRows = 1, kFormWindows = 2, kFormF32 = 3 };

// Whether a form's shared memory holds an h x w grid (a row tile is also
// one grid row).
bool holds(int form, int h, int w) {
  switch (form) {
    case kFormRows:
      return w == kTile && h <= Geo<true>::kSide;
    case kFormWindows:
      return h <= Geo<false>::kSide && w <= Geo<false>::kSide;
    case kFormF32:
      return h <= kF32Side && w <= kF32Side;
    default:
      return false;
  }
}

template <bool kRows>
cudaError_t prepare() {
  static cudaError_t err = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [] {
    err = cudaFuncSetAttribute(sam_attention_kernel<kRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Geo<kRows>::kSmem);
  });
  return err;
}

cudaError_t prepare_f32() {
  static cudaError_t err = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [] {
    err = cudaFuncSetAttribute(sam_attention_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kF32Smem);
  });
  return err;
}

template <bool kRows>
cudaError_t launch_bf16(const void* qkv, const void* tab_h, const void* tab_w,
                        void* out, int b, int h, int w, int heads,
                        cudaStream_t stream) {
  cudaError_t err = prepare<kRows>();
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  const int L = h * w, C = heads * kHd;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)3 * C, (cuuint64_t)b * L};
  const cuuint64_t strides[1] = {(cuuint64_t)3 * C * sizeof(bf16)};
  const cuuint32_t box[2] = {kHd, kTile};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(qkv),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  Args args;
  args.tab_h = static_cast<const bf16*>(tab_h);
  args.tab_w = static_cast<const bf16*>(tab_w);
  args.out = static_cast<bf16*>(out);
  args.L = L;
  args.h = h;
  args.w = w;
  args.heads = heads;
  args.nk = (L + kTile - 1) / kTile;
  using G = Geo<kRows>;
  const dim3 grid((L + G::kQRows - 1) / G::kQRows, heads, b);
  sam_attention_kernel<kRows><<<grid, G::kThreads, G::kSmem, stream>>>(
      map, args);
  return cudaGetLastError();
}

}  // namespace

// o [B, h w, heads 64] of the attention core over qkv [B, h w, 3, heads,
// 64] with the gathered tables tab_h [h, h, 64] and tab_w [w, w, 64], all
// contiguous in one dtype (fp32 for kFormF32, else bf16), in the form
// given (enum Form).
extern "C" cudaError_t mivp_sam_attention(const void* qkv, const void* tab_h,
                                          const void* tab_w, void* out, int b,
                                          int h, int w, int heads, int form,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || h < 1 || w < 1 ||
      !holds(form, h, w))
    return cudaErrorInvalidValue;
  if (form == kFormF32) {
    cudaError_t err = prepare_f32();
    if (err != cudaSuccess) return err;
    const int L = h * w;
    const dim3 grid((L + 63) / 64, heads, b);
    sam_attention_f32_kernel<<<grid, kF32Threads, kF32Smem, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(tab_h),
        static_cast<const float*>(tab_w), static_cast<float*>(out), L, h, w,
        heads);
    return cudaGetLastError();
  }
  if (form == kFormRows)
    return launch_bf16<true>(qkv, tab_h, tab_w, out, b, h, w, heads, s);
  return launch_bf16<false>(qkv, tab_h, tab_w, out, b, h, w, heads, s);
}

// The launch of a call at these sizes, without running it: info[7] =
// cluster, CTAs, threads, CTAs per SM, registers, spill bytes, shared
// bytes (ops/kernels.py::INFO_KEYS).
extern "C" cudaError_t mivp_sam_attention_info(int b, int h, int w, int heads,
                                               int form, int* info) {
  const void* fn;
  int threads, smem, rows;
  cudaError_t err;
  if (h < 1 || w < 1 || !holds(form, h, w)) return cudaErrorInvalidValue;
  if (form == kFormF32) {
    fn = reinterpret_cast<const void*>(sam_attention_f32_kernel);
    threads = kF32Threads;
    smem = kF32Smem;
    rows = 64;
    err = prepare_f32();
  } else if (form == kFormRows) {
    fn = reinterpret_cast<const void*>(sam_attention_kernel<true>);
    threads = Geo<true>::kThreads;
    rows = Geo<true>::kQRows;
    smem = Geo<true>::kSmem;
    err = prepare<true>();
  } else {
    fn = reinterpret_cast<const void*>(sam_attention_kernel<false>);
    threads = Geo<false>::kThreads;
    rows = Geo<false>::kQRows;
    smem = Geo<false>::kSmem;
    err = prepare<false>();
  }
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  info[0] = 1;
  info[1] = ((h * w + rows - 1) / rows) * heads * b;
  info[2] = threads;
  info[3] = per_sm;
  info[4] = attr.numRegs;
  info[5] = (int)attr.localSizeBytes;
  info[6] = smem;
  return cudaSuccess;
}
