// Non-causal flash attention over CSP resolution groups for Hopper (sm_90a),
// paper section 4.2.
//
// Replaces the TPU kernel src/repro/kernels/patch_attention.py:_kernel (called
// through patch_attention), which ran a (B, H, S/block_q) Pallas grid with the
// whole K/V of one (batch, head) resident in VMEM.
//
// What it computes. q, k, v (B, S, H, D) with any batch/sequence/head strides
// and unit stride over D; o (B, S, H, D) contiguous;
// o = softmax(q k^T * D^-0.5) v per (batch, head), every key visible.
//
// What bounds it on the H100. 4*S*S*D flops per (batch, head) against
// 4*S*D elements of traffic: at S >= 1024 the work is far above the ridge
// point, so it is bound by operations. This first version runs them as
// scalar fp32 FMAs (67 TFLOP/s peak), not on the tensor cores.
//
// What the design does about that. One block per (query tile, head, batch);
// each thread owns one query row and keeps q, the running max, the running
// sum and the output accumulator in fp32 registers, so no score matrix ever
// reaches memory (the flash-attention online softmax). A loop walks all of S
// in key tiles of kBlockK rows staged in shared memory, converted to fp32
// once per tile and read back as broadcast float4 loads; any S works because
// K/V are never held whole. The ragged tail is masked in the kernel (keys
// past S score -inf, query rows past S are not stored), so no padded copies
// are made. The softmax scale and log2(e) are folded into q so the inner
// loop uses exp2f. Tensor-core MMA (wgmma) and TMA staging are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kBlockQ = 64;   // query rows per block, one per thread
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
patch_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh, float scale) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool valid = row < S;

  float qr[D];
  float acc[D];
  const T* qp = q + b * q_sb + (long long)(valid ? row : 0) * q_ss + h * q_sh;
  const float qscale = scale * kLog2e;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f32(qp[d]) * qscale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;   // running max (log2 domain)
  float l = 0.f;         // running sum of exp2(s - m)

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();     // the previous tile is consumed
    for (int e = threadIdx.x; e < kBlockK * D; e += kBlockQ) {
      const int j = e / D;
      const int d = e % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        kv = to_f32(kb[key * k_ss + d]);
        vv = to_f32(vb[key * v_ss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    const int nvalid = min(kBlockK, S - k0);
    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      s[j] = j < nvalid ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds at least one valid key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = exp2f(s[j] - m_new);
      l += pj;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(pj, vv.x, acc[d]);
        acc[d + 1] = fmaf(pj, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pj, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pj, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (valid) {
    T* op = o + (((long long)b * S + row) * H + h) * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int S,
                     int H, const long long* st, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  patch_attention_kernel<T, D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_d<T, 8>(q, k, v, o, B, S, H, st, scale, s);
    case 16: return launch_d<T, 16>(q, k, v, o, B, S, H, st, scale, s);
    case 32: return launch_d<T, 32>(q, k, v, o, B, S, H, st, scale, s);
    case 64: return launch_d<T, 64>(q, k, v, o, B, S, H, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements; the head dimension must have unit stride.
extern "C" cudaError_t ps_patch_attention_f32(const void* q, const void* k, const void* v,
                                              void* o, int B, int S, int H, int D,
                                              long long q_sb, long long q_ss, long long q_sh,
                                              long long k_sb, long long k_ss, long long k_sh,
                                              long long v_sb, long long v_ss, long long v_sh,
                                              float scale, void* stream) {
  return launch<float>(q, k, v, o, B, S, H, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, scale, stream);
}

extern "C" cudaError_t ps_patch_attention_bf16(const void* q, const void* k, const void* v,
                                               void* o, int B, int S, int H, int D,
                                               long long q_sb, long long q_ss, long long q_sh,
                                               long long k_sb, long long k_ss, long long k_sh,
                                               long long v_sb, long long v_ss, long long v_sh,
                                               float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, H, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, scale, stream);
}
