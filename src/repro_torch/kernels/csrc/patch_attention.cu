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
//   330 TFLOP/s of fp32 work, against S*S exp2 at about 3.9e12/s on the
//   special-function units. A score costs 12*D MMA flops and one
//   exponential, so the exponentials take about 21/D of the MMA time: half
//   at D = 40, a quarter at D = 80, and from D = 128 up only the MMAs matter
//   (B=1, H=8, S=4096, D=40: 0.065 ms of MMA against 0.034 ms of
//   exponentials);
// - bf16 and fp16 at D <= 32 by the exponentials, not the MMAs: S*S exp2 at
//   about 3.9e12/s on the special-function units (0.034 ms at B=2, H=4,
//   S=4096, D=32, against 0.017 ms of 16-bit MMA); from D = 64 up by the MMAs.
//
// Two routes, chosen by the input alone: fp32 at D <= 256 runs the wgmma
// route; bf16, fp16 and every type's D > 256 run the mma.sync route. They
// share the launcher and the split-KV combine, nothing else.
//
// The fp32 route (wgmma, 3xbf16; `WgRoute`, the kernel template on DP alone).
// - fp32 as 3xbf16. Each operand pair is written x = hi + lo with
//   hi = bf16(x) and lo = bf16(x - hi); a product accumulates
//   lo*hi + hi*lo + hi*hi (the small terms first) in fp32, about 16 bits of
//   each operand. One pass (bf16 or TF32) misses the fp32 tolerance of 1e-4
//   at S = 4096; three bf16 passes hold it with a margin of about 20, at twice
//   the MMA rate of 3xTF32 (ref.emulated_attention reproduces all three).
// - Split once per block. A producer warpgroup has the copy engine (TMA, one
//   box per tensor per tile; columns past D and keys past Sk arrive as
//   zeros) bring each fp32 K and V tile of kN keys into a ring of kSt staged
//   tiles, and splits each tile once into bf16 hi and lo tiles, every load
//   of a thread first, then its splits. Where a warp once split its own
//   fragments in registers, every element was split once per warp; now once
//   per block. The split pass is the price of reading B from shared memory,
//   and the hi and lo tiles together take the bytes of the fp32 tile.
// - wgmma for both products: two consumer warpgroups own 64 query rows each
//   (block rows kWgRows) and split their Q rows once into the A operand of
//   q k^T. q k^T is m64 n=kN k16 with both operands in shared memory, K
//   K-major; P = 2^(s*scale*log2e - m*scale*log2e) is split in registers into
//   the register A operand of P*V (two n8 score tiles are one k16 fragment,
//   so no shuffle moves P), and V's hi and lo tiles, MN-major as V lies in
//   memory, are its B operand, m64 n=DP k16. The accumulators are fp32
//   registers. Operands are 8 x 16-byte core matrices, no swizzle.
// - Overlap. mbarriers hand hi/lo stages between the warpgroups (full:
//   split; empty: both consumers done), so the producer splits tile i+1 and
//   copies tile i+2 while the consumers compute tile i. A consumer's softmax
//   does not overlap its own MMAs: keeping the next q k^T or p v in flight
//   across it, ordering the two consumers' issues (ping-pong), and deeper
//   copy rings all measured no faster on the H100 (PERF.md).
// - What bounds it now: the producer's split, one warpgroup's loads,
//   conversions and stores a tile; the consumers alone run PixArt-alpha's
//   S = 4096 in about 0.38 ms against 0.48 ms in all (PERF.md). A second
//   producer warpgroup would cap every thread at 128 registers, and the
//   width-256 consumer needs 158.
// - Widths: one instance per padded width DP in kWidths. Shared memory holds
//   Q's hi and lo (kWgRows x DP), two stages of K and V hi and lo (kN x DP
//   each) and kSt fp32 tiles (kN x kLd, kLd = DP + 4 up to a 256-wide copy
//   box), within 227 KB:
//     width      kN  fp32 tiles
//     16 .. 80   64  2
//     96, 128    32  2
//     160        32  1
//     192        16  2
//     256        16  1
//   With one fp32 tile the next copy waits until the producer has split it.

// The mma.sync route (bf16 and fp16 at every D; fp32 at D > 256).
// - Tensor cores, mma.sync.m16n8k16 with fp32 accumulators for both products:
//   bf16 inputs for bf16 and 3xbf16, f16 inputs for fp16. A block of 4 warps
//   owns 4 * 16 * kM query rows; each warp owns kM m16 row tiles, so every
//   K/V fragment it loads feeds kM MMAs. bf16 and fp16 are bound by the
//   exponentials at D <= 32, not the MMA rate.
// - One instance per type and padded width DP in kWidths: the smallest
//   DP >= D runs.
//   Shared-memory rows hold DP columns; columns D..DP-1 of K, V (and Q where
//   it is staged) are zero-filled once, and the copies never write them, so
//   they add nothing to q k^T. Q's fragment columns past D are zero; the
//   accumulator's columns past D are never stored. A width class sets where
//   Q lives, the row tiles per warp, the keys per shared-memory tile and the
//   ring depth, within 255 registers a thread and 227 KB of shared memory a
//   block (smem_bytes below):
//     width        bf16, fp16: kM  Q    keys  stages
//     16 .. 64                 2   regs  64    2
//     80 .. 128                1   regs  64    2
//     160 .. 256               1   smem  64    2
//   (fp32 column slices run the width-256 instance with kM 1, Q in shared
//   memory, 32-key tiles and one stage.) Q in registers costs kM * DP/4 of
//   them and the accumulator kM * DP/2 more; past DP = 128 that leaves too
//   few for the scores, so Q is staged in shared memory once and each warp
//   reads one k-step's A fragments at a time. The split-KV cut stays in
//   tiles of kBlockK = 64 keys, each walked as kBlockK / kTileK
//   shared-memory tiles. bf16 and fp16 inputs take one pass and round P to
//   their own type for P*V, as flash attention does; fp32 slices split each
//   fragment into hi and lo in registers as it is loaded.
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
//
// Both routes.
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
//   normalises and writes o itself, and no combine runs. Every launch of a
//   call is one of those two kernels.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
// the fp32 wgmma route: consumer warpgroups a block, each owning 64 query
// rows, after one producer warpgroup of kProdThreads
constexpr int kWgs = 2;
constexpr int kProdThreads = 128;
constexpr int kWgThreads = kProdThreads + 128 * kWgs;
constexpr int kWgRows = 64 * kWgs;

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
// PTX (the pieces shared with fp32_gemm.cu are in hopper.cuh)
// ---------------------------------------------------------------------------

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

// wgmma and its fences. A shared-memory operand is K-major with no swizzle:
// 8 x 16-byte core matrices, LBO the byte step between core matrices along
// K and SBO along M or N.
__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32;
}

// a box of the 4-D tensor `map` at coordinates (c0 .. c3), innermost first,
// from global to shared memory by the copy engine, counted on bar; elements
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
               "r"(c2), "r"(c3), "r"(smem_addr(bar))
               : "memory");
}

// d (m64 x N fp32, N/2 a thread) += a b in bf16: ss with a and b in shared
// memory, both K-major; rs with a in registers and b MN-major (b's rows along
// K, n contiguous); the operand lists (PS_L*, PS_O*) are in hopper.cuh
template <int N> struct Wgmma;
// n0..n5: the operand numbers after the N/2 accumulators
#define PS_WGMMA(N, G, n0, n1, n2, n3, n4, n5)                                          \
  template <> struct Wgmma<N> {                                                         \
    __device__ static void ss(float (&d)[N / 2], uint64_t a, uint64_t b) {             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " n2 ", 0;\n"                      \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" PS_L##G \
                   "}, " n0 ", " n1 ", p, 1, 1, 0, 0;\n}\n"                             \
                   : PS_O##G : "l"(a), "l"(b), "r"(1));                                 \
    }                                                                                   \
    __device__ static void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " n5 ", 0;\n"                      \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" PS_L##G \
                   "}, {" n0 ", " n1 ", " n2 ", " n3 "}, " n4 ", p, 1, 1, 1;\n}\n"      \
                   : PS_O##G : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                     "r"(1));                                                           \
    }                                                                                   \
  };
PS_WGMMA(16, 1, "%8", "%9", "%10", "%11", "%12", "%13")
PS_WGMMA(32, 2, "%16", "%17", "%18", "%19", "%20", "%21")
PS_WGMMA(48, 3, "%24", "%25", "%26", "%27", "%28", "%29")
PS_WGMMA(64, 4, "%32", "%33", "%34", "%35", "%36", "%37")
PS_WGMMA(80, 5, "%40", "%41", "%42", "%43", "%44", "%45")
PS_WGMMA(96, 6, "%48", "%49", "%50", "%51", "%52", "%53")
PS_WGMMA(128, 8, "%64", "%65", "%66", "%67", "%68", "%69")
PS_WGMMA(160, 10, "%80", "%81", "%82", "%83", "%84", "%85")
PS_WGMMA(192, 12, "%96", "%97", "%98", "%99", "%100", "%101")
PS_WGMMA(256, 16, "%128", "%129", "%130", "%131", "%132", "%133")

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

// fp32 on mma.sync: only the column slices of D > kSliceWidth run it, at the
// widest width (below it fp32 runs WgRoute)
template <int DP> struct Route<float, DP> {  // 3xbf16, mma.m16n8k16
  static_assert(DP == kSliceWidth, "fp32 below the widest instance runs the wgmma route");
  static constexpr int kM = 1;
  static constexpr bool kQSmem = true;
  static constexpr int kTileK = 32;  // keys per shared-memory tile
  static constexpr int kStages = 1;
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

// The fp32 route on wgmma at padded width DP: its tiles and the byte layout
// of its shared memory (two stages of K hi, K lo, V hi, V lo; Q hi, Q lo;
// kSt staged fp32 tiles of K then V).
template <int DP> struct WgRoute {
  static constexpr int kN = DP <= 80 ? 64 : DP <= 160 ? 32 : 16;  // keys per tile
  static constexpr int kTileBytes = kN * DP * 2;    // K or V, hi or lo
  static constexpr int kQBytes = kWgRows * DP * 2;  // Q hi or lo
  // staged fp32 row, floats: 4 of padding spread a column's rows over the
  // banks; a copy's box is at most 256 wide
  static constexpr int kLd = DP + 4 <= 256 ? DP + 4 : DP;
  static constexpr int kStFloats = 2 * kN * kLd;    // one staged fp32 K and V tile
  static constexpr int kBase = 2 * 4 * kTileBytes + 2 * kQBytes;
  // fp32 tiles staged by the copy engine: two where they fit, else one
  static constexpr int kFree = (232448 - kBase - 32) / (kStFloats * 4 + 8);  // slots that fit
  static constexpr int kSt = kFree < 2 ? 1 : 2;
  static constexpr int kBars = kBase + kSt * kStFloats * 4;  // full[2], empty[2], landed[kSt]
  static constexpr int kSmem = kBars + (4 + kSt) * 8;
  static_assert(kBlockK % kN == 0, "a split-KV tile is whole shared-memory tiles");
};

// 8 floats -> their bf16 hi and lo halves, packed in order
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& lo) {
  split_bf16x2(x[0], x[1], hi.x, lo.x);
  split_bf16x2(x[2], x[3], hi.y, lo.y);
  split_bf16x2(x[4], x[5], hi.z, lo.z);
  split_bf16x2(x[6], x[7], hi.w, lo.w);
}

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

// the staged fp32 tile at ks split into the hi/lo stage at kh by the
// producer's 128 threads, kUnits 16-byte units of K and of V each, every
// load first. Unit u of K is (key u % kN, 8 d from 8 * (u / kN)), K-major;
// of V (key u / DP * 8 + u % 8, 8 d from 8 * (u / 8 % (DP / 8))), MN-major;
// both at byte 16 u. Eight threads in a row take eight keys' rows at one
// column, which the rows' 4-float padding puts in eight banks.
template <int DP>
__device__ __forceinline__ void wg_split_staged(unsigned char* kh, const float* ks) {
  using W = WgRoute<DP>;
  constexpr int kUnits = (W::kN * DP / 8 + kProdThreads - 1) / kProdThreads;
  const float* vs = ks + W::kN * W::kLd;
  float4 x[kUnits][4];
#pragma unroll
  for (int n = 0; n < kUnits; ++n) {
    const int u = threadIdx.x + kProdThreads * n;
    if (W::kN * DP / 8 % kProdThreads != 0 && u >= W::kN * DP / 8) continue;
    const float* k8 = ks + u % W::kN * W::kLd + u / W::kN * 8;
    const float* v8 = vs + (u / DP * 8 + u % 8) * W::kLd + u / 8 % (DP / 8) * 8;
    x[n][0] = *reinterpret_cast<const float4*>(k8);
    x[n][1] = *reinterpret_cast<const float4*>(k8 + 4);
    x[n][2] = *reinterpret_cast<const float4*>(v8);
    x[n][3] = *reinterpret_cast<const float4*>(v8 + 4);
  }
#pragma unroll
  for (int n = 0; n < kUnits; ++n) {
    const int u = threadIdx.x + kProdThreads * n;
    if (W::kN * DP / 8 % kProdThreads != 0 && u >= W::kN * DP / 8) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // K, then V
      const float4 a = x[n][2 * half], c = x[n][2 * half + 1];
      const float xs[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      uint4 hi, lo;
      split8(xs, hi, lo);
      *reinterpret_cast<uint4*>(kh + 2 * half * W::kTileBytes + 16 * u) = hi;
      *reinterpret_cast<uint4*>(kh + (2 * half + 1) * W::kTileBytes + 16 * u) = lo;
    }
  }
}

// s += q k^T over the hi/lo stage at kh, both operands in shared memory,
// the small terms first, k-steps in order
template <int DP>
__device__ __forceinline__ void wg_qk(float (&s)[WgRoute<DP>::kN / 2], uint64_t dq_hi,
                                      uint64_t dq_lo, const unsigned char* kh) {
  using W = WgRoute<DP>;
  const uint64_t dk_hi = wg_desc(kh, W::kN * 16, 128);
  const uint64_t dk_lo = wg_desc(kh + W::kTileBytes, W::kN * 16, 128);
  constexpr int kAk = 2 * W::kN;   // a k16 step: two core-matrix columns, in 16-byte units
  constexpr int kAq = 2 * kWgRows;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    Wgmma<W::kN>::ss(s, dq_lo + kAq * kk, dk_hi + kAk * kk);
    Wgmma<W::kN>::ss(s, dq_hi + kAq * kk, dk_lo + kAk * kk);
    Wgmma<W::kN>::ss(s, dq_hi + kAq * kk, dk_hi + kAk * kk);
  }
  wg_commit();
}

// acc += p v over the hi/lo stage at kh, P's hi and lo A fragments per
// k16 step of keys, the small terms first
template <int DP>
__device__ __forceinline__ void wg_pv(float (&acc)[DP / 2],
                                      const uint32_t (&ph)[WgRoute<DP>::kN / 16][4],
                                      const uint32_t (&pl)[WgRoute<DP>::kN / 16][4],
                                      const unsigned char* kh) {
  using W = WgRoute<DP>;
  // V MN-major: 8-key groups DP * 16 bytes apart (LBO), 8-d groups 128 (SBO)
  const uint64_t dv_hi = wg_desc(kh + 2 * W::kTileBytes, DP * 16, 128);
  const uint64_t dv_lo = wg_desc(kh + 3 * W::kTileBytes, DP * 16, 128);
  constexpr int kAv = 2 * DP;
#pragma unroll
  for (int kk = 0; kk < W::kN / 16; ++kk) {
    Wgmma<DP>::rs(acc, pl[kk], dv_hi + kAv * kk);
    Wgmma<DP>::rs(acc, ph[kk], dv_lo + kAv * kk);
    Wgmma<DP>::rs(acc, ph[kk], dv_hi + kAv * kk);
  }
  wg_commit();
}

// The fp32 route (3xbf16 on wgmma) at padded width DP <= kSliceWidth: the
// same grid, outputs and arguments as the kernel above but k and v, which
// come as copy boxes (kv_map), kWgRows query rows a block; threads 0..127
// produce, the rest consume. Q and K are K-major (row, d), V MN-major (key,
// d), with the 8-row groups of a core-matrix column adjacent: unit u of an
// operand of R rows holds row u % R, columns 8 * (u / R) on, at byte 16 u
// (LBO 16 R, SBO 128); V's unit u holds key u / DP * 8 + u % 8, d from
// 8 * (u / 8 % (DP / 8)) (LBO 16 DP, SBO 128).
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
patch_attention_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, float* __restrict__ o,
                       float* __restrict__ part_o, float* __restrict__ part_ml, int Sq, int H,
                       int D, int n_split, Strides st, float scale_log2, int Sk) {
  using W = WgRoute<DP>;
  constexpr int kN = W::kN;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* smem = wg_smem;
  unsigned char* hl = smem;                         // [2][K hi, K lo, V hi, V lo]
  unsigned char* q_hi = hl + 8 * W::kTileBytes;     // [kWgRows x DP], K-major
  unsigned char* q_lo = q_hi + W::kQBytes;

  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  const int qt = blockIdx.x % n_qt;
  const int split = blockIdx.x / n_qt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // this split's key range in tiles of kN keys, as the kernel above cuts it
  const int n_kt = (Sk + kBlockK - 1) / kBlockK;
  const int kt0 = static_cast<int>(static_cast<long long>(split) * n_kt / n_split);
  const int kt1 = static_cast<int>(static_cast<long long>(split + 1) * n_kt / n_split);
  const int t0 = kt0 * (kBlockK / kN);
  const int n_tiles = min(kt1 * (kBlockK / kN), (Sk + kN - 1) / kN) - t0;
  const int tid = threadIdx.x;
  const float* qb = q + b * st.q_sb + h * st.q_sh;
  float* stage = reinterpret_cast<float*>(smem + W::kBase);  // [kSt][K, V][kN][kLd]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::kBars);  // hi/lo stage s holds a tile
  uint64_t* empty = full + 2;                                     // every consumer is done with it
  uint64_t* landed = empty + 2;  // [kSt]: staged fp32 slot s holds its tile
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, kProdThreads);
      mbar_init(empty + i, 128 * kWgs);
    }
    for (int i = 0; i < W::kSt; ++i) mbar_init(landed + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProdThreads) {
    // the producer: copies tile j+kSt while it splits tile j into hi/lo
    // stage j % 2, once the consumers have left tile j-2 there. A tile's K
    // and V are a box each, kLd columns by kN keys: columns past D and keys
    // past Sk arrive as zeros.
    const CUtensorMap* mk = &tmk;
    const CUtensorMap* mv = &tmv;
    auto copy = [=](int j) {
      if (tid == 0) {
        uint64_t* bar = landed + j % W::kSt;
        float* ks = stage + j % W::kSt * W::kStFloats;
        mbar_arrive_tx(bar, 2 * kN * W::kLd * 4);
        tma_load(ks, mk, 0, h, (t0 + j) * kN, b, bar);
        tma_load(ks + kN * W::kLd, mv, 0, h, (t0 + j) * kN, b, bar);
      }
    };
    for (int j = 0; j < W::kSt && j < n_tiles; ++j) copy(j);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(landed + j % W::kSt, (j / W::kSt) & 1);  // tile j
      if (j >= 2) mbar_wait(empty + j % 2, (j / 2 - 1) & 1);
      wg_split_staged<DP>(hl + j % 2 * 4 * W::kTileBytes, stage + j % W::kSt * W::kStFloats);
      fence_proxy_async();
      mbar_arrive(full + j % 2);
      named_sync(1, kProdThreads);  // every producer thread is done with the staged tile
      if (j + W::kSt < n_tiles) copy(j + W::kSt);
    }
    return;
  }

  // a consumer warpgroup: rows 64 cw on of the block's
  const int cw = (tid - kProdThreads) / 128;
  const int ct = tid % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = qt * kWgRows + cw * 64 + (ct / 32) * 16 + g;  // rows r0, r0 + 8
  // its Q rows, split once into the A operand of q k^T; rows past Sq and
  // columns past D zero
  for (int u = ct; u < 64 * DP / 8; u += 128) {
    const int row = u % 64 + cw * 64;  // of the block's kWgRows
    const int col = u / 64 * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (qt * kWgRows + row < Sq) {
      const float* src = qb + static_cast<long long>(qt * kWgRows + row) * st.q_ss + col;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (col + 4 * half < D) {
          const float4 y = __ldg(reinterpret_cast<const float4*>(src + 4 * half));
          x[4 * half] = y.x;
          x[4 * half + 1] = y.y;
          x[4 * half + 2] = y.z;
          x[4 * half + 3] = y.w;
        }
    }
    uint4 hi, lo;
    split8(x, hi, lo);
    const int at = 16 * (u / 64 * kWgRows + row);
    *reinterpret_cast<uint4*>(q_hi + at) = hi;
    *reinterpret_cast<uint4*>(q_lo + at) = lo;
  }
  fence_proxy_async();
  named_sync(2 + cw, 128);
  const uint64_t dq_hi = wg_desc(q_hi + cw * 1024, kWgRows * 16, 128);  // rows 64 cw on
  const uint64_t dq_lo = wg_desc(q_lo + cw * 1024, kWgRows * 16, 128);

  float acc[DP / 2];
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows r0, r0 + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the running sum
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(full + i % 2, (i / 2) & 1);
    const unsigned char* kh = hl + i % 2 * 4 * W::kTileBytes;
    float s[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) s[j] = 0.f;
    reg_fence(s);
    wg_fence();
    wg_qk<DP>(s, dq_hi, dq_lo, kh);
    wg_wait();
    reg_fence(s);
    const int key0 = (t0 + i) * kN;
    if (key0 + kN > Sk) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < kN / 2; ++j)
        if (key0 + j / 4 * 8 + 2 * t + (j & 1) >= Sk) s[j] = -INFINITY;
    }
    // every tile holds a valid key, so the new max is finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < kN / 8; ++c)
        mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float corr = ex2((m[r] - mx) * scale_log2);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        acc[4 * c + 2 * r] *= corr;
        acc[4 * c + 2 * r + 1] *= corr;
      }
      const float mc = mx * scale_log2;
#pragma unroll
      for (int c = 0; c < kN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * c + 2 * r + e];
          x = ex2(fmaf(x, scale_log2, -mc));
          l[r] += x;
        }
    }
    // score tiles 2kk and 2kk+1 are the A fragment of keys 16kk..16kk+15
    uint32_t ph[kN / 16][4], pl[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4)
        split_bf16x2(s[8 * kk + 2 * i4], s[8 * kk + 2 * i4 + 1], ph[kk][i4], pl[kk][i4]);
    reg_fence(acc);
    wg_fence();
    wg_pv<DP>(acc, ph, pl, kh);
    wg_wait();
    reg_fence(acc);
    mbar_arrive(empty + i % 2);
  }

  // columns 8c + 2t, 8c + 2t + 1 below D (D is even, so a pair is stored
  // whole or not at all)
  const long long rows = static_cast<long long>(gridDim.z) * Sq * H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const long long orow = (static_cast<long long>(b) * Sq + row) * H + h;
    if (n_split == 1) {
      const float inv = 1.f / sum;
      float* op = o + orow * D + 2 * t;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c)
        if (c * 8 + 2 * t < D)
          store2(op + c * 8, acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    } else {
      const long long prow = split * rows + orow;
      float* pp = part_o + prow * D + 2 * t;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c)
        if (c * 8 + 2 * t < D) store2(pp + c * 8, acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
      if (t == 0) store2(part_ml + prow * 2, m[r] * scale_log2, sum);
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

// the split-KV merge of n_split > 1 partials into o
template <typename T>
cudaError_t combine(const float* part_o, const float* part_ml, void* o, int B, int Sq, int H,
                    int D, int n_split, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long cblocks = (rows * D + 255) / 256;
  patch_attention_combine<T><<<static_cast<unsigned>(cblocks), 256, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(o), rows, D, n_split);
  return cudaGetLastError();
}

// the fp32 route's copy box over k or v (B, S, H, D) with element strides
// sb, ss, sh: dims (D, H, S, B) innermost first, a box of kLd columns, one
// head and kN keys. A dim of one element takes the stride of a dense layout
// (the wrapper checks only the strides of longer dims).
template <int DP>
cudaError_t kv_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
                   long long ss, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const long long h_b = H > 1 ? sh * 4 : D * 4LL;
  const long long s_b = S > 1 ? ss * 4 : h_b * H;
  const long long b_b = B > 1 ? sb * 4 : s_b * S;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(h_b), static_cast<cuuint64_t>(s_b),
                                 static_cast<cuuint64_t>(b_b)};
  const cuuint32_t box[4] = {WgRoute<DP>::kLd, 1, WgRoute<DP>::kN, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the fp32 route at padded width DP
template <int DP>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, float* part_o,
                      float* part_ml, int B, int Sq, int Sk, int H, int D, int n_split,
                      const Strides& st, float scale, cudaStream_t stream) {
  constexpr int kSmem = WgRoute<DP>::kSmem;
  static_assert(kSmem <= 232448, "an instance needs at most 227 KB of shared memory");
  static bool configured = false;  // the shared-memory opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        patch_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = static_cast<long long>((Sq + kWgRows - 1) / kWgRows) * n_split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap tmk, tmv;
  cudaError_t map_err = kv_map<DP>(&tmk, k, B, Sk, H, D, st.k_sb, st.k_ss, st.k_sh);
  if (map_err == cudaSuccess) map_err = kv_map<DP>(&tmv, v, B, Sk, H, D, st.v_sb, st.v_ss, st.v_sh);
  if (map_err != cudaSuccess) return map_err;
  const dim3 grid(static_cast<unsigned>(blocks), H, B);
  patch_attention_kernel<DP><<<grid, kWgThreads, kSmem, stream>>>(
      static_cast<const float*>(q), tmk, tmv, static_cast<float*>(o), part_o, part_ml, Sq, H, D,
      n_split, st, scale * kLog2e, Sk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return combine<float>(part_o, part_ml, o, B, Sq, H, D, n_split, stream);
}

// fp32 below the widest instance takes the wgmma route, the rest mma.sync
template <typename T, int DP, bool kWide = false>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, float* part_o,
                     float* part_ml, int B, int Sq, int Sk, int H, int D, int n_split,
                     const Strides& st, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value && !kWide) {
    return launch_wg<DP>(q, k, v, o, part_o, part_ml, B, Sq, Sk, H, D, n_split, st, scale,
                         stream);
  } else {
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
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return err;
    return combine<T>(part_o, part_ml, o, B, Sq, H, D, n_split, stream);
  }
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
  if constexpr (std::is_same<T, float>::value) {
    return instance_width(D) > 0 ? kWgRows : 0;
  } else {
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
