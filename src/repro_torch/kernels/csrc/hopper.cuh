// Pieces that the Hopper kernels of this directory share: shared-memory
// addresses, wgmma's fences, mbarriers, named barriers, the operand lists of
// a wgmma's m64 x N fp32 accumulator, and cuTensorMapEncodeTiled.
// Included by patch_attention.cu and fp32_gemm.cu; each translation unit
// keeps its own internal copy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until every committed group is done
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// mbarriers in shared memory: init by one thread, arrive, wait for a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// this thread's share of an mbarrier phase: an arrival that also expects
// `bytes` more of copies to complete on it
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
// a barrier of `count` threads (whole warps) under id, 1..15
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// keeps the compiler from moving accesses to an accumulator across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the operand lists of an m64 x N wgmma's fp32 accumulator (N/2 registers a
// thread), spelled out per N: %0.. the accumulators, then the operands
#define PS_S0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define PS_S1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define PS_S2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define PS_S3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define PS_S4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define PS_S5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define PS_S6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define PS_S7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define PS_S8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define PS_S9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define PS_S10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define PS_S11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define PS_S12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define PS_S13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define PS_S14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define PS_S15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define PS_L1 PS_S0
#define PS_L2 PS_L1 ", " PS_S1
#define PS_L3 PS_L2 ", " PS_S2
#define PS_L4 PS_L3 ", " PS_S3
#define PS_L5 PS_L4 ", " PS_S4
#define PS_L6 PS_L5 ", " PS_S5
#define PS_L8 PS_L6 ", " PS_S6 ", " PS_S7
#define PS_L10 PS_L8 ", " PS_S8 ", " PS_S9
#define PS_L12 PS_L10 ", " PS_S10 ", " PS_S11
#define PS_L16 PS_L12 ", " PS_S12 ", " PS_S13 ", " PS_S14 ", " PS_S15
#define PS_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PS_O1 PS_D8(0)
#define PS_O2 PS_O1, PS_D8(8)
#define PS_O3 PS_O2, PS_D8(16)
#define PS_O4 PS_O3, PS_D8(24)
#define PS_O5 PS_O4, PS_D8(32)
#define PS_O6 PS_O5, PS_D8(40)
#define PS_O8 PS_O6, PS_D8(48), PS_D8(56)
#define PS_O10 PS_O8, PS_D8(64), PS_D8(72)
#define PS_O12 PS_O10, PS_D8(80), PS_D8(88)
#define PS_O16 PS_O12, PS_D8(96), PS_D8(104), PS_D8(112), PS_D8(120)

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
