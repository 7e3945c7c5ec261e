// Non-causal flash attention over CSP resolution groups for Hopper (sm_90a),
// paper section 4.2.
//
// Replaces the TPU kernel src/repro/kernels/patch_attention.py:_kernel (called
// through patch_attention), which ran a (B, H, S/block_q) Pallas grid with the
// whole K/V of one (batch, head) resident in VMEM.
//
// What it computes. q (B, Sq, H, D) and k, v (B, Sk, H, D) with any batch,
// sequence and head strides and unit stride over D; o (B, Sq, H, D)
// contiguous; o = softmax(q k^T * scale) v per (batch, head), every key
// visible, scale D^-0.5 of the caller's head dim. Any Sq, Sk >= 1 and any
// D >= 1 whose rows are whole 16-byte chunks (D * sizeof(T) % 16 == 0: the
// wrapper zero-pads the others to the next such width in a copy); fp32,
// bf16 and fp16.
//
// What bounds it on the H100. 4*Sq*Sk*D flops and Sq*Sk exponentials per
// (batch, head) against (2*Sq + 2*Sk)*D elements of traffic: at
// Sq = Sk >= 1024 it is bound by operations, and by which operations depends
// on the type and D:
// - fp32 by the tensor cores: three bf16 passes per product at 989 TFLOP/s,
//   330 TFLOP/s of fp32 work (B=2, H=4, S=4096, D=32: 0.052 ms, against
//   0.034 ms of exponentials);
// - bf16 and fp16 at D <= 32 by the exponentials, not the MMAs: S*S exp2 at
//   about 3.9e12/s on the special-function units (0.034 ms at the same
//   shape, against 0.017 ms of 16-bit MMA); from D = 64 up by the MMAs.
//
// What the design does about that.
// - Tensor cores, mma.sync.m16n8k16 with fp32 accumulators for every type
//   and both products: bf16 inputs for fp32 and bf16, f16 inputs for fp16.
//   A block of 4 warps owns 4 * 16 * kM query rows;
//   each warp owns kM m16 row tiles, so every K/V fragment it loads, and in
//   fp32 splits, feeds kM MMAs. Not wgmma: the fp32 split needs both halves
//   of every operand, which wgmma would read from shared memory in its
//   swizzled layout (twice the K/V footprint and a split pass per tile),
//   while mma.sync splits fragments in registers as they are loaded; and bf16
//   is bound by the exponentials at D <= 32, not the MMA rate.
// - One instance per type and padded width DP in kWidths: the smallest
//   DP >= D runs.
//   Shared-memory rows hold DP columns; columns D..DP-1 of K, V (and Q where
//   it is staged) are zero-filled once, and the copies never write them, so
//   they add nothing to q k^T. Q's fragment columns past D are zero; the
//   accumulator's columns past D are never stored. A width class sets where
//   Q lives, the row tiles per warp, the keys per shared-memory tile and the
//   ring depth, within 255 registers a thread and 227 KB of shared memory a
//   block (smem_bytes below):
//     width        fp32: kM  Q     keys  stages    bf16, fp16: kM  Q    keys  stages
//     16, 32             2   regs  64    2               2   regs  64    2
//     48, 64             1   regs  64    2               2   regs  64    2
//     80, 96             1   regs  64    2               1   regs  64    2
//     128                1   regs  32    2               1   regs  64    2
//     160 .. 256         1   smem  32    1               1   smem  64    2
//   Q in registers costs kM * DP/2 of them in fp32 (hi and lo) and the
//   accumulator kM * DP/2 more; past DP = 128 that leaves too few for the
//   scores, so Q is staged in shared memory once and each warp reads one
//   k-step's A fragments at a time. fp32 rows are twice bf16's: with 64-key
//   tiles fp32 from DP = 128 fits one block of 4 warps a SM, so it takes
//   32-key tiles (two blocks a SM up to DP = 192), and past DP = 128 one
//   stage, copying each tile in turn. The split-KV cut stays in tiles of
//   kBlockK = 64 keys, each walked as kBlockK / kTileK shared-memory tiles.
// - fp32 as 3xbf16. Each operand pair is written x = hi + lo with
//   hi = bf16(x) and lo = bf16(x - hi); a product accumulates
//   lo*hi + hi*lo + hi*hi (the small terms first), about 16 bits of each
//   operand. One pass (bf16 or TF32) misses the fp32 tolerance of 1e-4 at
//   S = 4096; three bf16 passes hold it with a margin of about 20, at twice
//   the MMA rate of 3xTF32 (ref.emulated_attention reproduces all three).
//   bf16 and fp16 inputs take one pass and round P to their own type for
//   P*V, as flash attention does.
// - Head dims past the widest instance (D > 256) split the columns of V and
//   o: the grid gains ceil(D / 256) column slices, each run by the width-256
//   instance's shared memory and fragments. A slice's block computes the
//   scores over the whole D, staging q and k one 256-wide chunk at a time
//   (copies past D zero-fill, so a ragged last chunk adds nothing), and keeps
//   the accumulator of its own 256 columns of o. This recomputes q k^T once
//   per slice and restages q for every key tile, with no copy in flight
//   during the MMAs: right at every D, and slow (PERF.md). The limit left is
//   the grid's: query tiles x n_split x slices < 2^31 blocks.
// - The P*V A operand comes straight from the score accumulators: two n8
//   score tiles are one k16 A fragment, so no shuffle moves P between threads.
// - K/V staging by cp.async, 16-byte copies, in a ring of kStages tiles of
//   kTileK keys in shared memory: with two stages tile j+1 is in flight
//   while tile j is in the MMAs. Rows are padded (fp32 +4 floats, 16-bit
//   types +8 values) so that fragment loads and ldmatrix.trans (V in 16-bit
//   types) spread over the banks. Copies past Sk zero-fill their row. The
//   wrapper checks that every base pointer and stride is 16-byte aligned.
// - Online softmax on the accumulator fragments: each thread holds two rows
//   of each m16 tile (g and g+8); the row max reduces over the thread quad by
//   two shuffles, the row sum stays per thread until the end. 2^x runs on the
//   special-function unit (ex2.approx, what exp2f becomes under fast math) on
//   s * scale*log2(e) - m * scale*log2(e), one FFMA on the fp32 scores (not
//   folded into q, which in 16 bits would round q a second time). Keys past
//   Sk score -inf in the last tile; query rows past Sq are not stored.
// - Split-KV to fill 132 SMs. The grid is (query tiles * n_split * slices,
//   H, B). When the B * H * ceil(Sq / block rows) * slices query tiles are
//   fewer than the SMs, the wrapper (split_kv in patch_attention.py) cuts the
//   T = ceil(Sk/64) key tiles into n_split = min(ceil(SMs / query tiles), T)
//   ranges of whole tiles, range i holding tiles [i*T/n, (i+1)*T/n), each
//   non-empty. Each block then writes its unnormalised fp32 (acc, m, l) to
//   scratch, and patch_attention_combine merges the ranges by log-sum-exp
//   and writes o in q's type. With n_split == 1 the attention kernel
//   normalises and writes o itself, and no combine runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockK = 64;           // keys per tile of the split-KV cut
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
// the padded head dims with an instance, ascending; D runs in the first >= D
constexpr int kWidths[] = {16, 32, 48, 64, 80, 96, 128, 160, 192, 256};
// wider head dims run in column slices of the widest instance
constexpr int kSliceWidth = kWidths[sizeof(kWidths) / sizeof(kWidths[0]) - 1];

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// the instance width of head dim D, 0 when none takes it whole
constexpr int instance_width(int D) {
  for (int w : kWidths)
    if (D >= 1 && D <= w) return w;
  return 0;
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (what exp2f compiles to under fast math)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the B fragment of an m16n8k16 product from a row-major 16 x 8 16-bit tile
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&b)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(smem_addr(row)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) = hi + lo with hi and lo packed bf16 pairs, x0 in the low half
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(f16* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(bf16* p) { *p = __float2bfloat16(0.f); }
__device__ __forceinline__ void set_zero(f16* p) { *p = __float2half_rn(0.f); }

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16(a); }
__device__ __forceinline__ void store1(f16* p, float a) { *p = __float2half_rn(a); }

// the 16-bit input types: their MMA and how P is packed for P*V
template <typename T> struct Half16;
template <> struct Half16<bf16> {
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    mma_bf16(c, a, b);
  }
  __device__ static uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
};
template <> struct Half16<f16> {
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    mma_f16(c, a, b);
  }
  __device__ static uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
};

// ---------------------------------------------------------------------------
// The routes, fp32 (3xbf16) and the 16-bit types, at padded width DP.
// Fragment coordinates of mma.m16n8k16: lane = 4*g + t; an A fragment of
// k-step kk holds pairs of columns (row g, 2t), (g+8, 2t), (g, 2t+8),
// (g+8, 2t+8) of the step's 16; an accumulator c[4] of an n8 tile holds
// (row g, cols 2t, 2t+1) and (row g+8, same cols).
// ---------------------------------------------------------------------------

template <typename T, int DP> struct Route;

template <int DP> struct Route<float, DP> {  // 3xbf16, mma.m16n8k16
  static constexpr int kM = DP <= 32 ? 2 : 1;
  static constexpr bool kQSmem = DP > 128;
  static constexpr int kTileK = DP >= 128 ? 32 : kBlockK;  // keys per shared-memory tile
  static constexpr int kStages = DP > 128 ? 1 : 2;
  static constexpr int kLd = DP + 4;          // shared row, floats
  static constexpr int kSteps = DP / 16;
  struct AFrag { uint32_t hi[kM][4], lo[kM][4]; };
  struct BFrag { uint32_t hi[2], lo[2]; };

  // the A fragments of k-step kk for the kM tiles from rows row0 + 16 mi
  // (+8) of base; rows at or past `rows` and columns at or past D are zero
  __device__ static void load_a(AFrag& f, const float* base, long long ld, int row0, int rows,
                                int kk, int t, int D) {
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + mi * 16 + (i & 1) * 8;
        const int d = kk * 16 + 2 * t + (i >> 1) * 8;
        float x0 = 0.f, x1 = 0.f;
        if (row < rows && d < D) {
          x0 = base[row * ld + d];
          x1 = base[row * ld + d + 1];
        }
        split_bf16x2(x0, x1, f.hi[mi][i], f.lo[mi][i]);
      }
  }

  // K's B fragment for keys 8j..8j+7 of the tile at k-step kk: (d 2t, 2t+1;
  // key g) and (d 2t+8, 2t+9; key g)
  __device__ static void load_b(BFrag& b, const float* ks, int j, int kk, int g, int t) {
    const float* kr = ks + (j * 8 + g) * kLd + kk * 16 + 2 * t;
    split_bf16x2(kr[0], kr[1], b.hi[0], b.lo[0]);
    split_bf16x2(kr[8], kr[9], b.hi[1], b.lo[1]);
  }

  __device__ static void mma(float (&c)[4], const AFrag& a, int mi, const BFrag& b) {
    mma_bf16(c, a.lo[mi], b.hi);
    mma_bf16(c, a.hi[mi], b.lo);
    mma_bf16(c, a.hi[mi], b.hi);
  }

  // acc += p v; score tiles 2jj and 2jj+1 are the A fragment of keys
  // 16jj..16jj+15, B = (keys 2t, 2t+1; d g) and (keys 2t+8, 2t+9; d g)
  __device__ static void pv(float (&acc)[kM][DP / 8][4], const float (&p)[kM][kTileK / 8][4],
                            const float* vs, int g, int t, int) {
#pragma unroll
    for (int jj = 0; jj < kTileK / 16; ++jj) {
      uint32_t ah[kM][4], al[kM][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_bf16x2(p[mi][2 * jj + i / 2][(i % 2) * 2], p[mi][2 * jj + i / 2][(i % 2) * 2 + 1],
                       ah[mi][i], al[mi][i]);
      const float* vr = vs + (jj * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t bh[2], bl[2];
        split_bf16x2(vr[n * 8], vr[kLd + n * 8], bh[0], bl[0]);
        split_bf16x2(vr[8 * kLd + n * 8], vr[9 * kLd + n * 8], bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_bf16(acc[mi][n], al[mi], bh);
          mma_bf16(acc[mi][n], ah[mi], bl);
          mma_bf16(acc[mi][n], ah[mi], bh);
        }
      }
    }
  }
};

template <typename T, int DP> struct Route16 {  // bf16 and fp16, mma.m16n8k16 in T
  static constexpr int kM = DP <= 64 ? 2 : 1;
  static constexpr bool kQSmem = DP > 128;
  static constexpr int kTileK = kBlockK;
  static constexpr int kStages = 2;
  static constexpr int kLd = DP + 8;          // shared row, 16-bit values
  static constexpr int kSteps = DP / 16;
  struct AFrag { uint32_t a[kM][4]; };
  struct BFrag { uint32_t b[2]; };

  __device__ static void load_a(AFrag& f, const T* base, long long ld, int row0, int rows,
                                int kk, int t, int D) {
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + mi * 16 + (i & 1) * 8;
        const int d = kk * 16 + 2 * t + (i >> 1) * 8;
        f.a[mi][i] = (row < rows && d < D)
                         ? *reinterpret_cast<const uint32_t*>(base + row * ld + d) : 0u;
      }
  }

  __device__ static void load_b(BFrag& b, const T* ks, int j, int kk, int g, int t) {
    const T* kr = ks + (j * 8 + g) * kLd + kk * 16 + 2 * t;
    b.b[0] = *reinterpret_cast<const uint32_t*>(kr);
    b.b[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
  }

  __device__ static void mma(float (&c)[4], const AFrag& a, int mi, const BFrag& b) {
    Half16<T>::mma(c, a.a[mi], b.b);
  }

  // acc += T(p) v; score tiles 2jj and 2jj+1 are the A fragment of keys
  // 16jj..16jj+15, and ldmatrix.trans reads V's matching B fragment
  __device__ static void pv(float (&acc)[kM][DP / 8][4], const float (&p)[kM][kTileK / 8][4],
                            const T* vs, int, int, int lane) {
#pragma unroll
    for (int jj = 0; jj < kTileK / 16; ++jj) {
      uint32_t a[kM][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        a[mi][0] = Half16<T>::pack(p[mi][2 * jj][0], p[mi][2 * jj][1]);
        a[mi][1] = Half16<T>::pack(p[mi][2 * jj][2], p[mi][2 * jj][3]);
        a[mi][2] = Half16<T>::pack(p[mi][2 * jj + 1][0], p[mi][2 * jj + 1][1]);
        a[mi][3] = Half16<T>::pack(p[mi][2 * jj + 1][2], p[mi][2 * jj + 1][3]);
      }
      const T* vr = vs + (jj * 16 + (lane & 15)) * kLd;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        ldsm_x2_trans(b, vr + n * 8);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) Half16<T>::mma(acc[mi][n], a[mi], b);
      }
    }
  }
};

template <int DP> struct Route<bf16, DP> : Route16<bf16, DP> {};
template <int DP> struct Route<f16, DP> : Route16<f16, DP> {};

template <typename T, int DP>
__host__ __device__ constexpr int block_q() {
  return 16 * Route<T, DP>::kM * kWarps;
}

// the K and V rings, then Q's rows where it is staged, each row kLd values
template <typename T, int DP>
constexpr int smem_bytes() {
  using R = Route<T, DP>;
  return (2 * R::kStages * R::kTileK + (R::kQSmem ? block_q<T, DP>() : 0)) * R::kLd *
         static_cast<int>(sizeof(T));
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// grid (query tiles * n_split * slices, H, B), blockIdx.x = (slice * n_split
// + split) * query tiles + query tile; slices is 1 unless kWide. n_split ==
// 1: writes o. Otherwise writes split's unnormalised fp32 partial
// part_o[split][row][D] and part_ml[split][row] = (m * scale*log2e, l), row
// indexing o's (B, Sq, H) rows. kWide (DP = kSliceWidth, D > DP): the block
// writes only columns [slice * DP, slice * DP + DP) of o. Sk is the last
// parameter: placed beside Sq it changed ptxas's register allocation of the
// main path's fp32 D = 32 instance and cost it 2% (PERF.md).
template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads)
patch_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ part_o, float* __restrict__ part_ml, int Sq, int H,
                       int D, int n_split, Strides st, float scale_log2, int Sk) {
  using R = Route<T, DP>;
  constexpr int kM = R::kM;
  constexpr int kStages = R::kStages;
  constexpr int kTileK = R::kTileK;
  constexpr int kBq = block_q<T, DP>();
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = DP / kChunk;  // 16-byte chunks of a padded row
  static_assert(!kWide || R::kQSmem, "a column slice stages q in shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);              // [kStages][kTileK][kLd]
  T* vs = ks + kStages * kTileK * R::kLd;          // [kStages][kTileK][kLd]
  T* qs = vs + kStages * kTileK * R::kLd;          // [kBq][kLd] when kQSmem

  const int n_qt = (Sq + kBq - 1) / kBq;
  const int qt = blockIdx.x % n_qt;
  const int split = kWide ? blockIdx.x / n_qt % n_split : blockIdx.x / n_qt;
  const int c0 = kWide ? blockIdx.x / (n_qt * n_split) * DP : 0;  // this slice's first column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // this split's key range, [kt0, kt1) in split tiles of kBlockK keys, walked
  // in shared-memory tiles of kTileK keys from tile t0; each holds a key < Sk
  const int n_kt = (Sk + kBlockK - 1) / kBlockK;
  const int kt0 = static_cast<int>(static_cast<long long>(split) * n_kt / n_split);
  const int kt1 = static_cast<int>(static_cast<long long>(split + 1) * n_kt / n_split);
  const int t0 = kt0 * (kBlockK / kTileK);
  const int n_tiles = min(kt1 * (kBlockK / kTileK), (Sk + kTileK - 1) / kTileK) - t0;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = (threadIdx.x / 32) * 16 * kM + g;  // row wrow + 16 mi + 8 r of the tile
  const int r0 = qt * kBq + wrow;
  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const T* qb = q + b * st.q_sb + h * st.q_sh;

  // zero the padding columns of every staged row once; copies never touch them
  if (!kWide && D < DP) {
    const int pad = DP - D;
    const int rows = 2 * kStages * kTileK + (R::kQSmem ? kBq : 0);
    for (int i = threadIdx.x; i < rows * pad; i += kThreads)
      set_zero(ks + (i / pad) * R::kLd + D + i % pad);
  }

  auto load_tile = [&](int i) {  // key tile t0 + i into stage i % kStages
    T* kd = ks + (i % kStages) * kTileK * R::kLd;
    T* vd = vs + (i % kStages) * kTileK * R::kLd;
    const int key0 = (t0 + i) * kTileK;
#pragma unroll
    for (int it = 0; it < (kTileK * kPerRow + kThreads - 1) / kThreads; ++it) {
      const int c = threadIdx.x + it * kThreads;
      if (c >= kTileK * kPerRow) break;
      const int j = c / kPerRow;
      const int col = (c % kPerRow) * kChunk;
      if (col >= D) continue;
      const bool ok = key0 + j < Sk;
      const long long key = ok ? key0 + j : 0;
      cp_async16(kd + j * R::kLd + col, kb + key * st.k_ss + col, ok);
      cp_async16(vd + j * R::kLd + col, vb + key * st.v_ss + col, ok);
    }
  };

  // kWide: rows [row0, row0 + n) of src, columns [col0, col0 + DP), into rows
  // of dst; rows at or past `valid` and columns at or past D zero-filled
  auto stage_rows = [&](T* dst, const T* src, long long ld, int row0, int n, int valid,
                        int col0) {
    for (int c = threadIdx.x; c < n * kPerRow; c += kThreads) {
      const int j = c / kPerRow;
      const int col = col0 + (c % kPerRow) * kChunk;
      const bool ok = row0 + j < valid && col < D;
      cp_async16(dst + j * R::kLd + col - col0, src + (ok ? (row0 + j) * ld + col : 0), ok);
    }
  };

  if constexpr (!kWide) {
    if constexpr (R::kQSmem) {  // Q's tile, rows past Sq zero; joins the first commit group
      for (int c = threadIdx.x; c < kBq * kPerRow; c += kThreads) {
        const int j = c / kPerRow;
        const int col = (c % kPerRow) * kChunk;
        const int row = qt * kBq + j;
        if (col < D)
          cp_async16(qs + j * R::kLd + col, qb + (row < Sq ? row : 0) * st.q_ss + col, row < Sq);
      }
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_tiles) load_tile(i);
      cp_async_commit();
    }
  }

  typename R::AFrag qf[R::kQSmem ? 1 : R::kSteps];  // Q's fragments, every k-step
  if constexpr (!R::kQSmem) {
#pragma unroll
    for (int kk = 0; kk < R::kSteps; ++kk) R::load_a(qf[kk], qb, st.q_ss, r0, Sq, kk, t, D);
  }

  float acc[kM][DP / 8][4];
  float m[kM][2];  // running max of the raw scores, rows r0 + 16 mi + 8 r
  float l[kM][2];  // this thread's part of the running sum
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (!kWide) {
      if constexpr (kStages > 1) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // tile i has landed; tile i-1's stage is free again
        if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
        cp_async_commit();
      } else {
        if (i > 0) __syncthreads();  // every warp is done with tile i-1
        load_tile(i);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
    }

    const T* kst = ks + (kWide ? 0 : i % kStages) * kTileK * R::kLd;
    const T* vst = vs + (kWide ? 0 : i % kStages) * kTileK * R::kLd;
    float s[kM][kTileK / 8][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
        s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
    // s[mi][j] = q k^T over keys 8j..8j+7 of the tile, k-steps in order
    if constexpr (kWide) {
      // over the whole D, q and k staged one DP-wide chunk at a time; this
      // slice's columns of V arrive with the first chunk
      for (int d0 = 0; d0 < D; d0 += DP) {
        __syncthreads();  // every warp is done with the staged chunk and tile i-1's V
        stage_rows(qs, qb, st.q_ss, qt * kBq, kBq, Sq, d0);
        stage_rows(ks, kb, st.k_ss, (t0 + i) * kTileK, kTileK, Sk, d0);
        if (d0 == 0) stage_rows(vs, vb, st.v_ss, (t0 + i) * kTileK, kTileK, Sk, c0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < R::kSteps; ++kk) {
          typename R::AFrag a;
          R::load_a(a, qs, R::kLd, wrow, kBq, kk, t, DP);
#pragma unroll
          for (int j = 0; j < kTileK / 8; ++j) {
            typename R::BFrag bf;
            R::load_b(bf, ks, j, kk, g, t);
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) R::mma(s[mi][j], a, mi, bf);
          }
        }
      }
    } else if constexpr (R::kQSmem) {  // one k-step's Q fragments at a time
#pragma unroll
      for (int kk = 0; kk < R::kSteps; ++kk) {
        typename R::AFrag a;
        R::load_a(a, qs, R::kLd, wrow, kBq, kk, t, DP);
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j) {
          typename R::BFrag bf;
          R::load_b(bf, kst, j, kk, g, t);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) R::mma(s[mi][j], a, mi, bf);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
        for (int kk = 0; kk < R::kSteps; ++kk) {
          typename R::BFrag bf;
          R::load_b(bf, kst, j, kk, g, t);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) R::mma(s[mi][j], qf[kk], mi, bf);
        }
    }

    const int key0 = (t0 + i) * kTileK;
    if (key0 + kTileK > Sk) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * t + (e & 1) >= Sk) {
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) s[mi][j][e] = -INFINITY;
          }
    }

    // every tile holds a valid key, so the new max is finite
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][j][0], s[mi][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][j][2], s[mi][j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float corr = ex2((m[mi][r] - mx[r]) * scale_log2);
        m[mi][r] = mx[r];
        l[mi][r] *= corr;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[mi][n][2 * r] *= corr;
          acc[mi][n][2 * r + 1] *= corr;
        }
      }
      const float mc[2] = {m[mi][0] * scale_log2, m[mi][1] * scale_log2};
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mi][j][e] = ex2(fmaf(s[mi][j][e], scale_log2, -mc[e >> 1]));
          l[mi][e >> 1] += s[mi][j][e];
        }
    }
    R::pv(acc, s, vst, g, t, lane);
  }
  cp_async_wait<0>();

  // columns c0 + 8n + 2t, c0 + 8n + 2t + 1 below D (D is even, so a pair is
  // stored whole or not at all)
  const int dn = kWide ? min(DP, D - c0) : D;
  const long long rows = static_cast<long long>(gridDim.z) * Sq * H;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mi][r];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const int row = r0 + 16 * mi + 8 * r;
      if (row >= Sq) continue;
      const long long orow = (static_cast<long long>(b) * Sq + row) * H + h;
      if (n_split == 1) {
        const float inv = 1.f / sum;
        T* op = o + orow * D + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          if (n * 8 + 2 * t < dn)
            store2(op + n * 8, acc[mi][n][2 * r] * inv, acc[mi][n][2 * r + 1] * inv);
      } else {
        const long long prow = split * rows + orow;
        float* pp = part_o + prow * D + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          if (n * 8 + 2 * t < dn) store2(pp + n * 8, acc[mi][n][2 * r], acc[mi][n][2 * r + 1]);
        if (t == 0 && c0 == 0) store2(part_ml + prow * 2, m[mi][r] * scale_log2, sum);
      }
    }
}

// o[row][d] = sum_s 2^(m_s - M) acc_s[row][d] / sum_s 2^(m_s - M) l_s, M = max_s m_s
template <typename T>
__global__ void __launch_bounds__(256)
patch_attention_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                        T* __restrict__ o, long long rows, int D, int n_split) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const long long row = i / D;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_ml[(s * rows + row) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = ex2(part_ml[(s * rows + row) * 2] - mx);
    den = fmaf(w, part_ml[(s * rows + row) * 2 + 1], den);
    num = fmaf(w, part_o[s * rows * D + i], num);
  }
  store1(o + i, num / den);
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, float* part_o,
                     float* part_ml, int B, int Sq, int Sk, int H, int D, int n_split,
                     const Strides& st, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, DP>();
  static_assert(kSmem <= 232448, "an instance needs at most 227 KB of shared memory");
  static bool configured = false;  // the shared-memory opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        patch_attention_kernel<T, DP, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long n_qt = (Sq + block_q<T, DP>() - 1) / block_q<T, DP>();
  const long long blocks = n_qt * n_split * (kWide ? (D + DP - 1) / DP : 1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), H, B);
  patch_attention_kernel<T, DP, kWide><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), part_o, part_ml, Sq, H, D, n_split, st, scale * kLog2e, Sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long cblocks = (rows * D + 255) / 256;
  patch_attention_combine<T><<<static_cast<unsigned>(cblocks), 256, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(o), rows, D, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* part_o,
                   void* part_ml, int B, int Sq, int Sk, int H, int D, int n_split,
                   long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (D <= 0 || D * sizeof(T) % 16 != 0) return cudaErrorInvalidValue;
  const int n_kt = (Sk + kBlockK - 1) / kBlockK;
  if (n_split < 1 || n_split > n_kt) return cudaErrorInvalidValue;
  if (n_split > 1 && (part_o == nullptr || part_ml == nullptr)) return cudaErrorInvalidValue;
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kSliceWidth)
    return launch_d<T, kSliceWidth, true>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st,
                                          scale, s);
  switch (instance_width(D)) {
    case 16: return launch_d<T, 16>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 32: return launch_d<T, 32>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 48: return launch_d<T, 48>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 64: return launch_d<T, 64>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 80: return launch_d<T, 80>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 96: return launch_d<T, 96>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 128: return launch_d<T, 128>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 160: return launch_d<T, 160>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 192: return launch_d<T, 192>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    case 256: return launch_d<T, 256>(q, k, v, o, po, pml, B, Sq, Sk, H, D, n_split, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int block_q_of(int D) {
  if (D > kSliceWidth) return block_q<T, kSliceWidth>();
  switch (instance_width(D)) {
    case 16: return block_q<T, 16>();
    case 32: return block_q<T, 32>();
    case 48: return block_q<T, 48>();
    case 64: return block_q<T, 64>();
    case 80: return block_q<T, 80>();
    case 96: return block_q<T, 96>();
    case 128: return block_q<T, 128>();
    case 160: return block_q<T, 160>();
    case 192: return block_q<T, 192>();
    case 256: return block_q<T, 256>();
    default: return 0;
  }
}

}  // namespace

// Query rows per block of the instance that runs head dim D in the type
// `dtype` (0 fp32, 1 bf16, 2 fp16), which the wrapper's split rule counts
// blocks with.
extern "C" cudaError_t ps_patch_attention_block_q(int dtype, int D, int* rows) {
  *rows = dtype == 0 ? block_q_of<float>(D)
        : dtype == 1 ? block_q_of<bf16>(D)
        : dtype == 2 ? block_q_of<f16>(D) : 0;
  return *rows > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// Strides are in elements; the head dimension must have unit stride, D *
// sizeof(T) a multiple of 16, and every base pointer and stride 16-byte
// aligned. scale multiplies q k^T (the caller's D^-0.5). part_o (n_split,
// B*Sq*H, D) and part_ml (n_split, B*Sq*H, 2) are fp32 scratch, unused when
// n_split == 1.
extern "C" cudaError_t ps_patch_attention_f32(const void* q, const void* k, const void* v,
                                              void* o, void* part_o, void* part_ml, int B,
                                              int Sq, int Sk, int H, int D, int n_split,
                                              long long q_sb, long long q_ss, long long q_sh,
                                              long long k_sb, long long k_ss, long long k_sh,
                                              long long v_sb, long long v_ss, long long v_sh,
                                              float scale, void* stream) {
  return launch<float>(q, k, v, o, part_o, part_ml, B, Sq, Sk, H, D, n_split, q_sb, q_ss,
                       q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, stream);
}

extern "C" cudaError_t ps_patch_attention_bf16(const void* q, const void* k, const void* v,
                                               void* o, void* part_o, void* part_ml, int B,
                                               int Sq, int Sk, int H, int D, int n_split,
                                               long long q_sb, long long q_ss, long long q_sh,
                                               long long k_sb, long long k_ss, long long k_sh,
                                               long long v_sb, long long v_ss, long long v_sh,
                                               float scale, void* stream) {
  return launch<bf16>(q, k, v, o, part_o, part_ml, B, Sq, Sk, H, D, n_split, q_sb, q_ss, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, stream);
}

extern "C" cudaError_t ps_patch_attention_f16(const void* q, const void* k, const void* v,
                                              void* o, void* part_o, void* part_ml, int B,
                                              int Sq, int Sk, int H, int D, int n_split,
                                              long long q_sb, long long q_ss, long long q_sh,
                                              long long k_sb, long long k_ss, long long k_sh,
                                              long long v_sb, long long v_ss, long long v_sh,
                                              float scale, void* stream) {
  return launch<f16>(q, k, v, o, part_o, part_ml, B, Sq, Sk, H, D, n_split, q_sb, q_ss, q_sh,
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, stream);
}
