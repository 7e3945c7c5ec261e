// fp32 matrix product on Hopper's tensor cores, as three TF32 passes (sm_90a).
//
// Replaces no TPU kernel. The JAX package writes no Pallas product: its
// linear layers are jnp matmuls that XLA compiles. On the H100, PyTorch runs
// an fp32 product with TF32 off (the configurations state fp32) as cuBLAS's
// FFMA kernels on the CUDA cores, 67 TFLOP/s at best, and those products
// take most of a DiT step's device time. This kernel runs the same product
// on the tensor cores instead.
//
// What it computes. c (M, N) = a (M, K) @ b (K, N) in fp32, with a's rows
// at a stride of lda floats and unit stride along K, and b given as two
// K-major (N, K) copies, b_big and b_small (fp32_gemm.py splits a weight
// once and keeps the copies): c row-major and contiguous. K and lda are
// multiples of 4 and N is even (the copy engine's 16-byte strides, the
// epilogue's float2 stores); any M, N and K beyond that, ragged tiles
// included.
//
// The arithmetic: 3xTF32. Each operand is x = big + small with
// big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), 11 significant
// bits each; a product accumulates small*big + big*small + big*big per
// k-step (small*small, about 2^-22 of the product, is dropped). Each product
// of two TF32 values is exact in fp32 (ref.emulated_tf32x3_matmul; the CPU
// tests hold its RMS error against an fp64 product to at most 2x that of a
// plain fp32 product, and three bf16 passes to failing it). The tensor
// cores' own fp32 accumulator rounds toward zero at each k8 step: a sum run
// over all of K in it drifts toward zero, its error growing with K (13x an
// FFMA product's RMS error at K = 1152, 74x at 4608, measured on the H100).
// So each stage's 32 columns start a fresh tensor-core sum, and the CUDA
// cores add it to the running fp32 total, rounding to nearest: a stage's
// truncation is then relative to its own partial sum, whose sign is random,
// and the result carries an FFMA product's error (PERF.md).
//
// What bounds it on the H100. 2*M*N*K flops of fp32 work, three TF32 passes
// of them at 495 TFLOP/s: 165 TFLOP/s of fp32 work, 2.5 times the CUDA
// cores' 67. Bytes: a read once per N tile, b's two copies once per M tile,
// c written once; at the models' shapes (K >= 320, 128 x 128 tiles and up)
// about 65 flops a byte against the tensor cores' 49, so operations bound it.
// Inside the SM, shared memory's 128 bytes a cycle is the next limit: every
// wgmma reads both operands from it, three times over, so the widest N tile
// that still fills the card is the fastest.
//
// The design.
// - A persistent grid: one block of 384 threads per SM walks the output
//   tiles (kBM x BN, N fastest, so concurrent tiles share a's row panel);
//   the copy ring runs on across tiles, so one tile's epilogue overlaps the
//   next one's first copies.
// - A producer warpgroup (one thread issues the copies, the warpgroup gives
//   its registers up with setmaxnreg) has the copy engine (TMA) bring, per
//   stage, a's fp32 tile and b's big and small tiles of kBK = 32 columns of
//   K: 128-byte rows, in the 128-byte swizzle wgmma reads without bank
//   conflicts. Rows past M or N and columns past K arrive as zeros.
// - Two consumer warpgroups own 64 rows of the tile each. Each splits its
//   own rows of a's tile once, in shared memory: big over the fp32 value in
//   place, small into a tile beside it, at the same swizzled offset. So every
//   element of a is split once per block, 16 floats a thread a stage, while
//   the tensor cores run the previous stage's 12 wgmmas. b's split costs
//   nothing here: a weight is split once, when first used.
// - wgmma m64 x BN x k8, tf32, both operands in shared memory (TF32 wgmma
//   takes only K-major operands, hence b's (N, K) copies), the stage's sum
//   and the running total in registers (BN/2 each a thread). A warpgroup
//   waits for its stage's group, adds it to the total and releases the
//   stage; the other warpgroup's group keeps the tensor cores busy
//   meanwhile, so the two take turns on them.
// - BN (64 or 128) is the wrapper's, chosen from M and N so that the tiles
//   fill the card's SMs in whole waves; the stages are as many as fit in
//   227 KB (4, 3). Wider tiles (192, 256: two stages, and no registers for a
//   second accumulator) measured slower at every cell shape (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                 // rows of a block tile: two warpgroups of 64
constexpr int kBK = 32;                  // fp32 columns of K a stage: one 128-byte row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kABytes = kBM * kBK * 4;   // a's fp32 tile, and its small tile
constexpr int kMaxSmem = 232448;

template <int BN> struct Tile {
  static constexpr int kBBytes = BN * kBK * 4;    // b big or b small
  // a (big in place), a small, b big, b small
  static constexpr int kStageBytes = 2 * kABytes + 2 * kBBytes;
  static constexpr int kFit = (kMaxSmem - 1024 - 64) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  // 1024 bytes of slack to align the swizzled tiles, then the full and empty
  // barriers of each stage
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kTx = kABytes + 2 * kBBytes;  // bytes the copies bring a stage
  static_assert(kStages >= 2, "a tile width needs two stages in shared memory");
};

// a box of the 2-D tensor `map` at (c0, c1), innermost first, from global to
// shared memory by the copy engine, counted on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3}], [%4];\n"
               ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
               "r"(smem_addr(bar))
               : "memory");
}

// a K-major operand of 128-byte rows in the 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO); LBO unused. A k8 step of tf32 is +32 bytes (+2).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d (m64 x N fp32) = a b + (accumulate ? d : 0) in tf32, a and b K-major in
// shared memory
template <int N> struct Tf32;
// n0..n2: the operand numbers after the N/2 accumulators
#define PS_TF32(N, G, n0, n1, n2)                                                         \
  template <> struct Tf32<N> {                                                            \
    __device__ static void ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " n2 ", 0;\n"                        \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" PS_L##G    \
                   "}, " n0 ", " n1 ", p, 1, 1;\n}\n"                                     \
                   : PS_O##G : "l"(a), "l"(b), "r"(accumulate));                          \
    }                                                                                     \
  };
PS_TF32(64, 4, "%32", "%33", "%34")
PS_TF32(128, 8, "%64", "%65", "%66")

// grid: at most one block per SM; block b runs tiles b, b + gridDim.x, ...
// Threads 0..127 produce, the rest consume.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
fp32_gemm_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                 const __grid_constant__ CUtensorMap tms, float* __restrict__ c, int M, int N,
                 int K) {
  using T = Tile<BN>;
  extern __shared__ unsigned char gemm_smem[];
  unsigned char* smem = gemm_smem + ((1024 - (smem_addr(gemm_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;  // every consumer is done with the stage
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int kblocks = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;  // stage uses so far, across tiles, as the consumers count them
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM;
        const int n0 = tile % tiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % T::kStages;
          if (it >= T::kStages) mbar_wait(empty + s, (it / T::kStages - 1) & 1);
          unsigned char* st = smem + s * T::kStageBytes;
          mbar_arrive_tx(full + s, T::kTx);
          tma_load_2d(st, &tma, kb * kBK, m0, full + s);
          tma_load_2d(st + 2 * kABytes, &tmb, kb * kBK, n0, full + s);
          tma_load_2d(st + 2 * kABytes + T::kBBytes, &tms, kb * kBK, n0, full + s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = tid / 128 - 1;  // rows 64 cw on of the tile
  const int ct = tid % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM;
    const int n0 = tile % tiles_n * BN;
    float acc[BN / 2];    // the tensor cores' sum over one stage's 32 columns of K
    float total[BN / 2];  // the sum over the stages so far, added on the CUDA cores
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = total[j] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % T::kStages;
      mbar_wait(full + s, (it / T::kStages) & 1);
      unsigned char* st = smem + s * T::kStageBytes;
      unsigned char* a_big = st + cw * (kABytes / 2);  // 64 rows of 128 bytes
      unsigned char* a_small = a_big + kABytes;
      // this warpgroup's rows, split once: 16-byte chunks, the same offset
      // in both tiles, so the swizzle carries over
#pragma unroll
      for (int j = 0; j < kABytes / 2 / 16 / 128; ++j) {
        const int off = 16 * (ct + 128 * j);
        const float4 x = *reinterpret_cast<const float4*>(a_big + off);
        const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
        const float4 lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                                      tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
        *reinterpret_cast<float4*>(a_big + off) = hi;
        *reinterpret_cast<float4*>(a_small + off) = lo;
      }
      fence_proxy_async();
      named_sync(1 + cw, 128);
      const uint64_t da = sw128_desc(a_big);
      const uint64_t dal = sw128_desc(a_small);
      const uint64_t db = sw128_desc(st + 2 * kABytes);
      const uint64_t dbl = sw128_desc(st + 2 * kABytes + T::kBBytes);
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {  // the small terms first; the first starts acc
        Tf32<BN>::ss(acc, dal + 2 * kk, db + 2 * kk, kk);
        Tf32<BN>::ss(acc, da + 2 * kk, dbl + 2 * kk, 1);
        Tf32<BN>::ss(acc, da + 2 * kk, db + 2 * kk, 1);
      }
      wg_commit();
      wg_wait();
      reg_fence(acc);
      mbar_arrive(empty + s);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) total[j] += acc[j];
    }
    // accumulator pair 4c + 2r: row 16 warp + g + 8r of the warpgroup's,
    // columns 8c + 2t, 8c + 2t + 1 (N is even: a pair is stored whole or not)
    const int row0 = m0 + cw * 64 + (ct / 32) * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= M) continue;
      float* cp = c + static_cast<long long>(row) * N + n0 + 2 * t;
#pragma unroll
      for (int cc = 0; cc < BN / 8; ++cc)
        if (n0 + cc * 8 + 2 * t < N)
          *reinterpret_cast<float2*>(cp + cc * 8) = make_float2(total[4 * cc + 2 * r],
                                                                total[4 * cc + 2 * r + 1]);
    }
  }
}

// a (rows, K) fp32 matrix at a row stride of ld floats, boxes of kBK columns
// by box_rows rows in the 128-byte swizzle; reads past the edges are zeros
cudaError_t map_2d(CUtensorMap* map, const void* base, int rows, int K, long long ld,
                   int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * 4)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch(const void* a, const void* b_big, const void* b_small, void* c, int M, int N,
                   int K, long long lda, int grid, cudaStream_t stream) {
  using T = Tile<BN>;
  static_assert(T::kSmem <= kMaxSmem, "a tile width needs at most 227 KB of shared memory");
  static bool configured = false;  // the shared-memory opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fp32_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap ta, tb, ts;
  cudaError_t err = map_2d(&ta, a, M, K, lda, kBM);
  if (err == cudaSuccess) err = map_2d(&tb, b_big, N, K, K, BN);
  if (err == cudaSuccess) err = map_2d(&ts, b_small, N, K, K, BN);
  if (err != cudaSuccess) return err;
  fp32_gemm_kernel<BN><<<grid, kThreads, T::kSmem, stream>>>(ta, tb, ts, static_cast<float*>(c),
                                                            M, N, K);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// c (M, N) contiguous = a (M, K; row stride lda floats) @ b, b given as its
// K-major (N, K) contiguous big and small TF32 halves. block_n is the tile
// width (64 or 128), grid the number of persistent blocks (at most
// the tiles). K and lda multiples of 4, N even, every pointer 16-byte
// aligned; anything else is refused before a launch.
extern "C" cudaError_t ps_fp32_gemm(const void* a, const void* b_big, const void* b_small,
                                    void* c, int M, int N, int K, long long lda, int block_n,
                                    int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || N % 2 != 0 || lda < K || lda % 4 != 0)
    return cudaErrorInvalidValue;
  if (block_n != 64 && block_n != 128) return cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(b_big) || !aligned16(b_small) || !aligned16(c))
    return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + block_n - 1) / block_n);
  if (grid < 1 || grid > tiles || tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 64: return launch<64>(a, b_big, b_small, c, M, N, K, lda, grid, s);
    default: return launch<128>(a, b_big, b_small, c, M, N, K, lda, grid, s);
  }
}
