// Fused GroupNorm + patch-edge stitch for Hopper (sm_90a), paper section 4.3:
// the statistics and the normalise-and-stitch pass, as two kernels.
//
// Replaces the TPU kernel src/repro/kernels/groupnorm_stitch.py:_kernel
// (called through groupnorm_stitch) together with the statistics that its
// caller, src/repro/kernels/ops.py:fused_groupnorm_stitch, computed for it.
//
// What it computes. For patch i of a CSP batch (P, p, p, C) NHWC, write the
// (p+2h, p+2h, C) tile that a VALID 3x3 conv reads: the centre is patch i, the
// eight border strips come from neighbors[i, slot] (slot order N, S, W, E, NW,
// NE, SW, SE). Every element is normalised with the mean and rstd of its
// channel group in the patch it was read from, then the affine scale/bias is
// applied. An absent neighbour (-1) gives 0 after normalisation (the conv's
// zero padding). Statistics are per (request, group) over all the request's
// patches (exact mode) or per (patch, group) (per-patch mode, the paper's
// approximation), with the reference's variance max(s2/cnt - mean^2, 0).
//
// Any G dividing C; fp32, bf16 and fp16 patches.
//
// What bounds it on the H100. Four flops per element against 8 bytes (fp32
// in + out), so device-memory bytes (3.35 TB/s), far below the ridge point.
// The least traffic is one read of the patches and one write of the tiles.
//
// What the design does about that. The TPU kernel took the statistics as an
// input, because its grid ran in order on one core; the caller made them
// with about twenty small ops and host copies. Here the function is two
// launches, with nothing between them on the host:
// 1. gn_partials_kernel reads the patches once with 16-byte loads and writes
//    fp32 (sum x, sum x^2) per (patch, group) into (P, G, 2) partials. A
//    patch's pixels are split over a thread block cluster of up to 8 blocks,
//    so that even a level-1 launch (P=29, p=16) spreads over the SMs; the
//    blocks of a cluster combine their sums in rank 0's shared memory through
//    distributed shared memory, so the partials need no zeroing and no
//    global atomics. Past kGroupChunk groups the grid gains a dimension over
//    chunks of kGroupChunk groups, each block summing its chunk's channels,
//    so that the shared sums stay within 48 KB at any G.
// 2. gn_stitch_kernel finalises, in its prologue, the mean/rstd it needs into
//    shared memory: in exact mode the request's (CSP neighbours never cross a
//    request, so one set serves the whole tile), in per-patch mode the
//    patch's own and its eight neighbours'. Its body is a pull: the grid is
//    (patch, part of the tile); each thread owns VEC consecutive channels of
//    one output pixel, picks the source patch from its (row, col), and moves
//    them with one 16-byte access, channel index fastest, so warps read and
//    write whole NHWC lines. Its reads of the patches, and the halo re-reads,
//    mostly hit the 50 MB L2, where kernel 1 (and on the main path the
//    producer of the patches) left them. Arithmetic is fp32 for every type.
//    Past kSmemGroups groups the 9 sets of statistics no longer fit the
//    stitch's shared memory: gn_finalise_kernel writes (mean, rstd) per
//    (patch, group) into a (P, G, 2) fp32 buffer, and the stitch reads each
//    element's statistics from there (L2), three launches a call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// VEC consecutive channels moved as one aligned access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Channels per 16-byte access.
template <typename T> constexpr int kVec = 16 / sizeof(T);

// (dr + 1) * 3 + (dc + 1) -> neighbour slot; -1 is the patch itself.
__constant__ int kSlot[9] = {4, 0, 5, 2, -1, 3, 6, 1, 7};

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;      // stitch grid target
constexpr int kMaxStitchItems = 4;   // output vectors a stitch thread writes, at most
constexpr int kMaxCluster = 8;       // partials blocks per patch, at most (portable size)
constexpr int kMinStatLoads = 2;     // vector loads a partials thread makes, at least
// groups a partials block sums: 2 * kGroupChunk * kMaxCluster floats of shared
// sums fill 48 KB; a multiple of 8, so a chunk's channels are whole vectors
constexpr int kGroupChunk = 768;
// groups whose 9 sets of statistics the stitch keeps in shared memory (36 KB)
constexpr int kSmemGroups = 512;

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Output vectors per stitch thread that fill the card with kBlocksPerSm
// blocks per SM, clamped to [1, most].
int items_per_thread(long long work, int most) {
  const long long target = (long long)sm_count() * kBlocksPerSm * kThreads;
  const long long items = work / target;
  return items < 1 ? 1 : (items > most ? most : (int)items);
}

// Grid: (one thread block cluster of `cs` blocks per patch, chunks of
// kGroupChunk groups); each block an even share of the patch's pixels and
// the channels of its chunk's gn groups. A block's threads read `cvb` channel
// vectors of `rows` pixels side by side (looping over channel chunks when the
// chunk's vectors exceed the block), keep per-channel sums in registers, and
// add them per group into the block's shared (gn, 2) sums. Every other block
// then writes its sums into its slot of rank 0's shared memory, and rank 0
// adds the slots in rank order and stores the patch's partials. Without
// kChunked the grid has one chunk, of all G groups.
template <typename T, int VEC, bool kChunked>
__global__ void __launch_bounds__(kThreads)
gn_partials_kernel(const T* __restrict__ x, float* __restrict__ part, int p, int C, int G) {
  // acc: (gn, 2) this block's sum x, sum x^2; then, in rank 0, (cs, gn, 2) every block's
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.x / cs;
  const int g0 = kChunked ? blockIdx.y * kGroupChunk : 0;  // this block's groups [g0, g0 + gn)
  const int gn = kChunked ? min(kGroupChunk, G - g0) : G;
  // first half of a cluster barrier: rank 0 has started (its shared memory
  // exists) by the time the wait below returns
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  for (int t = threadIdx.x; t < 2 * gn; t += kThreads) acc[t] = 0.f;
  __syncthreads();
  const int cpg = C / G;
  const int cv = (kChunked ? gn * cpg : C) / VEC;    // channel vectors of the chunk
  const int cvb = cv < kThreads ? cv : kThreads;
  const int rows = kThreads / cvb;
  const int lane = threadIdx.x % cvb;
  const int row = threadIdx.x / cvb;
  const int npix = p * p;
  const int px0 = (int)((long long)npix * rank / cs);
  const int px1 = (int)((long long)npix * (rank + 1) / cs);
  const T* src = x + (long long)i * npix * C + (kChunked ? g0 * cpg : 0);
  for (int cb = 0; row < rows && cb + lane < cv; cb += cvb) {
    const int c = (cb + lane) * VEC;
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll 4
    for (int px = px0 + row; px < px1; px += rows) {
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(src + (long long)px * C + c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f32(v.v[k]);
        s1[k] += f;
        s2[k] += f * f;
      }
    }
    if (cpg % VEC == 0) {                       // the vector lies in one group
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        a += s1[k];
        b += s2[k];
      }
      atomicAdd(acc + 2 * (c / cpg), a);
      atomicAdd(acc + 2 * (c / cpg) + 1, b);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        atomicAdd(acc + 2 * ((c + k) / cpg), s1[k]);
        atomicAdd(acc + 2 * ((c + k) / cpg) + 1, s2[k]);
      }
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // every block but rank 0 copies its sums into rank 0's slot for it
  float* slot = cluster.map_shared_rank(acc, 0) + rank * 2 * gn;
  if (rank != 0) {
    for (int t = threadIdx.x; t < 2 * gn; t += kThreads) slot[t] = acc[t];
  }
  cluster.sync();                               // all slots are filled and visible
  if (rank == 0) {
    for (int t = threadIdx.x; t < 2 * gn; t += kThreads) {
      float s = 0.f;
      for (int r = 0; r < cs; ++r) s += acc[r * 2 * gn + t];
      part[((long long)i * G + g0) * 2 + t] = s;
    }
  }
}

__device__ __forceinline__ void finalise(float s1, float s2, float cnt, float eps,
                                         float* mean, float* rstd) {
  const float mu = s1 / cnt;
  *mean = mu;
  *rstd = rsqrtf(fmaxf(s2 / cnt - mu * mu, 0.f) + eps);
}

// G > kSmemGroups: stats[i][g] = (mean, rstd) of patch i's group g, from the
// sums of the patch's request (exact) or of the patch itself; one thread
// per (patch, group)
__global__ void __launch_bounds__(kThreads)
gn_finalise_kernel(const float* __restrict__ part, const int* __restrict__ patch_req,
                   const int* __restrict__ req_off, float* __restrict__ stats, int P, int p,
                   int C, int G, int exact, float eps) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)P * G) return;
  const int i = (int)(e / G), g = (int)(e % G);
  const float cnt1 = (float)((long long)p * p * (C / G));
  float a, b, cnt;
  if (exact) {
    const int r = patch_req[i];
    const int lo = req_off[r], hi = req_off[r + 1];
    a = b = 0.f;
    for (int q = lo; q < hi; ++q) {
      a += part[((long long)q * G + g) * 2];
      b += part[((long long)q * G + g) * 2 + 1];
    }
    cnt = (float)(hi - lo) * cnt1;
  } else {
    a = part[e * 2];
    b = part[e * 2 + 1];
    cnt = cnt1;
  }
  finalise(a, b, cnt, eps, stats + e * 2, stats + e * 2 + 1);
}

// kGlobal: the statistics are (P, G, 2) (mean, rstd) in `stats`, written by
// gn_finalise_kernel, and no prologue runs; else the prologue finalises them
// from `part` into shared memory
template <typename T, int VEC, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
gn_stitch_kernel(const T* __restrict__ x, const float* __restrict__ part,
                 const float* __restrict__ stats, const int* __restrict__ nbr,
                 const int* __restrict__ patch_req, const int* __restrict__ req_off,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ out, int p, int C, int G, int halo, int exact, float eps) {
  extern __shared__ float st[];   // mean, then rstd: [sets][G] each, sets 1 or 9
  const int i = blockIdx.x;
  const int sets = exact ? 1 : 9;
  float* s_mean = st;
  float* s_rstd = st + sets * G;
  const int cpg = C / G;
  if constexpr (!kGlobal) {
    if (exact) {
      // the request's sums over its patches [lo, hi): one warp per group
      const int r = patch_req[i];
      const int lo = req_off[r], hi = req_off[r + 1];
      const float cnt = (float)((long long)(hi - lo) * p * p * cpg);
      const int lane = threadIdx.x % 32;
      for (int g = threadIdx.x / 32; g < G; g += kThreads / 32) {
        float a = 0.f, b = 0.f;
        for (int q = lo + lane; q < hi; q += 32) {
          a += part[((long long)q * G + g) * 2];
          b += part[((long long)q * G + g) * 2 + 1];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          b += __shfl_xor_sync(0xffffffffu, b, off);
        }
        if (lane == 0) finalise(a, b, cnt, eps, s_mean + g, s_rstd + g);
      }
    } else {
      // set s < 8: neighbour slot s; set 8: the patch itself
      const float cnt = (float)(p * p * cpg);
      for (int t = threadIdx.x; t < 9 * G; t += kThreads) {
        const int s = t / G, g = t - s * G;
        const int src = s == 8 ? i : nbr[i * 8 + s];
        s_mean[t] = 0.f;
        s_rstd[t] = 0.f;
        if (src >= 0) {
          const float* ps = part + ((long long)src * G + g) * 2;
          finalise(ps[0], ps[1], cnt, eps, s_mean + t, s_rstd + t);
        }
      }
    }
    __syncthreads();
  }

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
      // mean and rstd of group g at mu[g * ms] and rs[g * ms]
      const int set = exact ? 0 : (slot < 0 ? 8 : slot);
      const float* mu = kGlobal ? stats + (long long)src * G * 2 : s_mean + set * G;
      const float* rs = kGlobal ? mu + 1 : s_rstd + set * G;
      const int ms = kGlobal ? 2 : 1;
      int g = c / cpg, gr = c - g * cpg;     // group of channel c + k, and c + k's place in it
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o.v[k] = from_f32<T>((to_f32(xv.v[k]) - mu[g * ms]) * rs[g * ms] * scale[c + k] +
                             bias[c + k]);
        if (++gr == cpg) {
          gr = 0;
          ++g;
        }
      }
    }
    *reinterpret_cast<Vec<T, VEC>*>(tile + (long long)pix * C + c) = o;
  }
}

// The 16-byte path needs C % kVec == 0 and 16-byte aligned tensors.
template <typename T>
bool vectorised(int C, const void* a, const void* b) {
  return C % kVec<T> == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T, int VEC>
cudaError_t launch_partials_vec(const T* x, float* part, int P, int p, int C, int G,
                                cudaStream_t s) {
  // the largest cluster that still gives each thread kMinStatLoads vector loads
  const long long loads = (long long)p * p * (C / VEC);
  int cs = 1;
  while (cs < kMaxCluster && loads >= 2LL * cs * kThreads * kMinStatLoads) cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * cs, (G + kGroupChunk - 1) / kGroupChunk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * 2 * (G < kGroupChunk ? G : kGroupChunk) * cs;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (G > kGroupChunk)
    return cudaLaunchKernelEx(&cfg, gn_partials_kernel<T, VEC, true>, x, part, p, C, G);
  return cudaLaunchKernelEx(&cfg, gn_partials_kernel<T, VEC, false>, x, part, p, C, G);
}

template <typename T>
cudaError_t launch_partials(const void* x, void* part, int P, int p, int C, int G,
                            void* stream) {
  static_assert(2 * kGroupChunk * kMaxCluster * sizeof(float) <= 48 * 1024,
                "a partials block's shared sums fit 48 KB");
  if (P <= 0 || p <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
      (G + kGroupChunk - 1) / kGroupChunk > 65535)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = kVec<T>;
  cudaError_t err = vectorised<T>(C, x, x) ? launch_partials_vec<T, V>(xt, pt, P, p, C, G, s)
                                           : launch_partials_vec<T, 1>(xt, pt, P, p, C, G, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int VEC>
void stitch_vec(dim3 grid, cudaStream_t s, bool global, const T* x, const float* part,
                float* stats, const int* nb, const int* pr, const int* ro, const float* sc,
                const float* bi, T* out, int p, int C, int G, int halo, int exact, float eps) {
  if (global) {
    gn_stitch_kernel<T, VEC, true><<<grid, kThreads, 0, s>>>(
        x, part, stats, nb, pr, ro, sc, bi, out, p, C, G, halo, exact, eps);
  } else {
    const size_t smem = sizeof(float) * 2 * (exact ? 1 : 9) * (size_t)G;
    gn_stitch_kernel<T, VEC, false><<<grid, kThreads, smem, s>>>(
        x, part, stats, nb, pr, ro, sc, bi, out, p, C, G, halo, exact, eps);
  }
}

template <typename T>
cudaError_t launch_stitch(const void* x, const void* part, void* stats, const void* nbr,
                          const void* patch_req, const void* req_off, const void* scale,
                          const void* bias, void* out, int P, int p, int C, int G, int halo,
                          int exact, float eps, void* stream) {
  static_assert(sizeof(float) * 2 * 9 * kSmemGroups <= 48 * 1024,
                "the stitch's shared statistics fit 48 KB");
  if (P <= 0 || p <= 0 || C <= 0 || G <= 0 || C % G != 0 || halo < 0 || halo > p)
    return cudaErrorInvalidValue;
  const bool global = G > kSmemGroups;
  if (global && stats == nullptr) return cudaErrorInvalidValue;
  const int w2 = p + 2 * halo;
  const bool vec = vectorised<T>(C, x, out);
  const long long per_patch = (long long)w2 * w2 * (vec ? C / kVec<T> : C);
  const int items = items_per_thread(P * per_patch, kMaxStitchItems);
  long long parts = (per_patch + (long long)kThreads * items - 1) / ((long long)kThreads * items);
  if (parts > 65535) parts = 65535;
  const dim3 grid(P, (unsigned)parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const float* pt = static_cast<const float*>(part);
  float* sp = static_cast<float*>(stats);
  const int* nb = static_cast<const int*>(nbr);
  const int* pr = static_cast<const int*>(patch_req);
  const int* ro = static_cast<const int*>(req_off);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (global) {
    const long long n = (long long)P * G;
    gn_finalise_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        pt, pr, ro, sp, P, p, C, G, exact, eps);
  }
  if (vec) {
    stitch_vec<T, kVec<T>>(grid, s, global, xt, pt, sp, nb, pr, ro, sc, bi, ot, p, C, G, halo,
                           exact, eps);
  } else {
    stitch_vec<T, 1>(grid, s, global, xt, pt, sp, nb, pr, ro, sc, bi, ot, p, C, G, halo, exact,
                     eps);
  }
  return cudaGetLastError();
}

}  // namespace

// Kernel 1. patches (P,p,p,C) contiguous; part (P,G,2) fp32, written with
// (sum x, sum x^2) per (patch, group).
extern "C" cudaError_t ps_gn_partials_f32(const void* x, void* part, int P, int p, int C,
                                          int G, void* stream) {
  return launch_partials<float>(x, part, P, p, C, G, stream);
}

extern "C" cudaError_t ps_gn_partials_bf16(const void* x, void* part, int P, int p, int C,
                                           int G, void* stream) {
  return launch_partials<__nv_bfloat16>(x, part, P, p, C, G, stream);
}

extern "C" cudaError_t ps_gn_partials_f16(const void* x, void* part, int P, int p, int C,
                                          int G, void* stream) {
  return launch_partials<__half>(x, part, P, p, C, G, stream);
}

// Kernel 2. patches (P,p,p,C) contiguous; part (P,G,2) fp32 from kernel 1;
// stats (P,G,2) fp32 scratch, needed when G > 512 and unused otherwise;
// neighbors (P,8), patch_req (P,) and request_offset (R+1,) int32; scale/bias
// (C,) fp32; out (P,p+2h,p+2h,C) contiguous, same type as patches. exact != 0:
// per-request statistics, else per-patch.
extern "C" cudaError_t ps_gn_stitch_f32(const void* x, const void* part, void* stats,
                                        const void* nbr, const void* patch_req,
                                        const void* req_off, const void* scale,
                                        const void* bias, void* out, int P, int p, int C, int G,
                                        int halo, int exact, float eps, void* stream) {
  return launch_stitch<float>(x, part, stats, nbr, patch_req, req_off, scale, bias, out, P, p,
                              C, G, halo, exact, eps, stream);
}

extern "C" cudaError_t ps_gn_stitch_bf16(const void* x, const void* part, void* stats,
                                         const void* nbr, const void* patch_req,
                                         const void* req_off, const void* scale,
                                         const void* bias, void* out, int P, int p, int C,
                                         int G, int halo, int exact, float eps, void* stream) {
  return launch_stitch<__nv_bfloat16>(x, part, stats, nbr, patch_req, req_off, scale, bias,
                                      out, P, p, C, G, halo, exact, eps, stream);
}

extern "C" cudaError_t ps_gn_stitch_f16(const void* x, const void* part, void* stats,
                                        const void* nbr, const void* patch_req,
                                        const void* req_off, const void* scale,
                                        const void* bias, void* out, int P, int p, int C, int G,
                                        int halo, int exact, float eps, void* stream) {
  return launch_stitch<__half>(x, part, stats, nbr, patch_req, req_off, scale, bias, out, P, p,
                               C, G, halo, exact, eps, stream);
}
