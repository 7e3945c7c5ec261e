// Fused GroupNorm + patch-edge stitch for Hopper (sm_90a), paper section 4.3.
//
// Replaces the TPU kernel src/repro/kernels/groupnorm_stitch.py:_kernel
// (called through groupnorm_stitch), which ran one Pallas program per patch.
//
// What it computes. For patch i of a CSP batch (P, p, p, C) NHWC, write the
// (p+2h, p+2h, C) tile that a VALID 3x3 conv reads: the centre is patch i, the
// eight border strips come from neighbors[i, slot] (slot order N, S, W, E, NW,
// NE, SW, SE). Every element is normalised with the per-channel mean/rstd of
// the patch it was read from, then the affine scale/bias is applied. An
// absent neighbour (-1) gives 0 after normalisation (the conv's zero padding).
//
// What bounds it on the H100. Four flops per element against 8 bytes (fp32
// in + out), so it is bound by device-memory bytes (3.35 TB/s), far below the
// ridge point. The least traffic is one read of the patches and one write of
// the haloed tiles.
//
// What the design does about that. A pull design: the grid is (patch, part
// of the tile); each thread owns VEC consecutive channels of one output pixel,
// picks the source patch from its (row, col), and moves them with one 16-byte
// (fp32) or 8-byte (bf16) access, channel index fastest, so warps read and
// write whole NHWC lines. Halo strips re-read neighbour lines that the
// neighbour's own block also reads; those reads mostly hit L2. Stats,
// scale and bias are a few KB and stay in L1/L2. Arithmetic is fp32 for
// both storage types.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive channels moved as one aligned access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// (dr + 1) * 3 + (dc + 1) -> neighbour slot; -1 is the patch itself.
__constant__ int kSlot[9] = {4, 0, 5, 2, -1, 3, 6, 1, 7};

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_stitch_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ out, int p, int C, int halo) {
  const int i = blockIdx.x;
  const int w2 = p + 2 * halo;
  const int cv = C / VEC;                   // channel vectors per pixel
  const int total = w2 * w2 * cv;
  T* tile = out + (long long)i * w2 * w2 * C;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < total;
       e += gridDim.y * blockDim.x) {
    const int c = (e % cv) * VEC;
    const int pix = e / cv;
    const int rr = pix / w2 - halo;          // row, col in patch coordinates
    const int cc = pix % w2 - halo;
    const int dr = rr < 0 ? -1 : (rr >= p ? 1 : 0);
    const int dc = cc < 0 ? -1 : (cc >= p ? 1 : 0);
    const int slot = kSlot[(dr + 1) * 3 + (dc + 1)];
    const int src = slot < 0 ? i : nbr[i * 8 + slot];
    Vec<T, VEC> o;
    if (src < 0) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(0.f);
    } else {
      const int sr = rr - dr * p;
      const int sc = cc - dc * p;
      const Vec<T, VEC> xv = *reinterpret_cast<const Vec<T, VEC>*>(
          x + (((long long)src * p + sr) * p + sc) * C + c);
      const float* mu = mean + (long long)src * C + c;
      const float* rs = rstd + (long long)src * C + c;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o.v[k] = from_f32<T>((to_f32(xv.v[k]) - mu[k]) * rs[k] * scale[c + k] + bias[c + k]);
      }
    }
    *reinterpret_cast<Vec<T, VEC>*>(tile + (long long)pix * C + c) = o;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* nbr, const void* mean, const void* rstd,
                   const void* scale, const void* bias, void* out, int P, int p, int C,
                   int halo, void* stream) {
  if (P <= 0 || p <= 0 || C <= 0 || halo < 0 || halo > p) return cudaErrorInvalidValue;
  const int w2 = p + 2 * halo;
  const uintptr_t align = sizeof(T) * 4;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  const int per_patch = w2 * w2 * (vec ? C / 4 : C);
  int parts = (per_patch + kThreads * kItemsPerThread - 1) / (kThreads * kItemsPerThread);
  if (parts > 65535) parts = 65535;
  const dim3 grid(P, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int* nb = static_cast<const int*>(nbr);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (vec) {
    gn_stitch_kernel<T, 4><<<grid, kThreads, 0, s>>>(xt, nb, mu, rs, sc, bi, ot, p, C, halo);
  } else {
    gn_stitch_kernel<T, 1><<<grid, kThreads, 0, s>>>(xt, nb, mu, rs, sc, bi, ot, p, C, halo);
  }
  return cudaGetLastError();
}

}  // namespace

// patches (P,p,p,C) contiguous; neighbors (P,8) int32; mean/rstd (P,C) fp32;
// scale/bias (C,) fp32; out (P,p+2h,p+2h,C) contiguous, same type as patches.
extern "C" cudaError_t ps_groupnorm_stitch_f32(const void* x, const void* nbr, const void* mean,
                                               const void* rstd, const void* scale,
                                               const void* bias, void* out, int P, int p,
                                               int C, int halo, void* stream) {
  return launch<float>(x, nbr, mean, rstd, scale, bias, out, P, p, C, halo, stream);
}

extern "C" cudaError_t ps_groupnorm_stitch_bf16(const void* x, const void* nbr, const void* mean,
                                                const void* rstd, const void* scale,
                                                const void* bias, void* out, int P, int p,
                                                int C, int halo, void* stream) {
  return launch<__nv_bfloat16>(x, nbr, mean, rstd, scale, bias, out, P, p, C, halo, stream);
}
