// GroupNorm forward for Hopper (sm_90a): statistics and affine in one launch.
//
// Replaces no TPU kernel: the JAX package's GroupNorm is Flax's
// nn.GroupNorm, which XLA fuses on the TPU.  It was added because on the
// card ATen runs each GroupNorm of HMR's ResNet-50 as three kernels (the
// row-wise moments, the fused per-channel parameters and a broadcast
// a * x + b), and the moments kernel gives one block to each (image, group)
// row: with 4 groups and N = 1 to 3 images that is 4 to 12 blocks on a
// 132-SM card, each reducing 6,272 to 200,704 floats alone.  Those three
// took about a quarter of the device's time in the benchmark's 3DPW cells.
//
// Per (image n, group g), over the group's E = (C / G) * H * W elements:
//
//   mean = sum(x) / E,  var = sum((x - mean)^2) / E  (biased, two passes)
//   rstd = rsqrt(var + eps)
//   y[c, hw] = (x[c, hw] - mean) * (rstd * gamma[c]) + beta[c]
//
// all in float32, and writes mean and rstd as (N, G) for the backward, as
// ATen's native_group_norm does.
//
// What bounds it.  Reading x once and writing y once is 8 B per element
// (gamma, beta and the statistics add a few KB): 88.9 MB for the 53
// GroupNorms of one 224^2 image row, 26.5 us at the H100 SXM data sheet's
// 3.35 TB/s, and 0.33 to 2.9 us for the single calls.  The work is a few
// FLOP per element, so bandwidth bounds it, and at these sizes the launch
// and the latency of one pass over device memory bound each call.
//
// What this design does about the 4 to 12 rows:
//  * One thread-block cluster per (image, group) row: grid (S, N * G),
//    cluster (S, 1, 1).  The S CTAs of a cluster split the row into
//    contiguous slices, so a large row is read by up to 16 SMs at once.
//    The wrapper (kernels/group_norm.py:plan) picks S and the threads from
//    the shape alone.
//  * Each thread loads its whole share of the slice, up to 8 float4s, into
//    registers before it adds any of them, so a CTA has its whole slice in
//    flight at once, and x is read from device memory once: the second
//    pass and the affine run on the registers.  16 CTAs of 512 threads
//    hold a row of up to 262,144 floats (1 MiB), 1.3 times ResNet-50's
//    largest at 224^2; the wrapper refuses a larger one.
//  * The CTA sums reduce by warp shuffles and one shared-memory step; the
//    S partial sums meet through distributed shared memory: each CTA writes
//    its partial into its own shared memory, the cluster barrier publishes
//    it, and every warp reads all S of them (mapa, ld.shared::cluster) and
//    sums them by the same butterfly, so every CTA of the cluster holds the
//    same mean and rstd to the bit.  The centred pass does the same with a
//    second slot.  After the second read a CTA only arrives at the cluster
//    barrier, applies the affine and stores, and waits for the others
//    before it exits (a CTA's shared memory must outlive its neighbours'
//    reads).
//  * The affine reads each element's channel from a count kept per thread
//    (one division per thread, not per element); gamma and beta of the
//    slice's channels sit in shared memory.
//  * Stores are float4 where the rows are 16-byte aligned and E is a
//    multiple of 4 (every GroupNorm of ResNet-50), element by element
//    otherwise.
//  * Deterministic: no atomics, every sum in a fixed order, so a replay in
//    a CUDA graph gives the eager launch's bits.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise; the cluster attribute is set once when the library
//    loads (dynaboa_group_norm_init), never during a graph capture.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPerThread = 8;               // float4s a thread holds at most
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmemBytes = 48 * 1024;    // the default dynamic limit

__device__ __forceinline__ float warp_sum(float v) {
  // an xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum, the same in every thread.
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0.f);
}

// Component j of v (j a constant once unrolled, so v stays in registers).
__device__ __forceinline__ float part_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float load_cluster(const float* p, int rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The cluster's sum of each CTA's `part`, the same in every thread of every
// CTA: published in this CTA's `slot`, read from every rank.
__device__ __forceinline__ float cluster_sum(float part, float* slot,
                                             int ranks) {
  if (threadIdx.x == 0) *slot = part;
  cluster_arrive();
  cluster_wait();
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < ranks ? load_cluster(slot, lane) : 0.f);
}

// Launched as a grid (S, N * G) of clusters (S, 1, 1): the cluster spans
// the grid's x, so its size is gridDim.x and a CTA's rank blockIdx.x.
// `vec`: the rows are 16-byte aligned and E a multiple of 4.  Two CTAs of
// 512 threads fit an SM (64 registers a thread), so 14 clusters of 16 are
// resident at once: the 12 rows of ResNet-50's largest GroupNorm at N = 3.
__global__ void __launch_bounds__(kMaxThreads, 2)
    dynaboa_group_norm_fwd(const float* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           float* __restrict__ y, float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int C, int G, int HW,
                           int E, float eps, bool vec) {
  __shared__ float s_warp[2][kMaxWarps];
  __shared__ float s_part[2];
  extern __shared__ float s_chan[];   // gamma, then beta, of the slice

  const int S = (int)gridDim.x, rank = (int)blockIdx.x;
  const int row = blockIdx.y;                    // n * G + g
  const int c_base = (row % G) * (C / G);        // the group's first channel
  const int T = blockDim.x;
  const int E4 = (E + 3) >> 2;
  const int per = (E4 + S - 1) / S;
  const int s0 = min(rank * per, E4), s1 = min(s0 + per, E4);
  const size_t base = (size_t)row * E;
  const float* xg = x + base;
  float* yg = y + base;

  // the whole share of the slice in flight before any of it is used
  float4 v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = s0 + threadIdx.x + k * T;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < s1) {
      if (vec) {
        v[k] = __ldg(reinterpret_cast<const float4*>(xg) + i);
      } else {
        const float* p = xg + 4 * i;
        v[k] = make_float4(__ldg(p), 4 * i + 1 < E ? __ldg(p + 1) : 0.f,
                           4 * i + 2 < E ? __ldg(p + 2) : 0.f,
                           4 * i + 3 < E ? __ldg(p + 3) : 0.f);
      }
    }
  }

  // gamma and beta of the channels the slice touches
  const int e_lo = 4 * s0, e_hi = min(4 * s1, E);
  const int c_lo = e_lo / HW;
  const int nc = e_hi > e_lo ? (e_hi - 1) / HW - c_lo + 1 : 0;
  for (int i = threadIdx.x; i < nc; i += T) {
    s_chan[i] = gamma ? gamma[c_base + c_lo + i] : 1.f;
    s_chan[nc + i] = beta ? beta[c_base + c_lo + i] : 0.f;
  }

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    sum += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  const float mean =
      cluster_sum(block_sum(sum, s_warp[0]), &s_part[0], S) / (float)E;

  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = s0 + threadIdx.x + k * T;
    const int n_valid = i < s1 ? min(E - 4 * i, 4) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = part_of(v[k], j) - mean;
      if (j < n_valid) m2 += d * d;
    }
  }
  const float var =
      cluster_sum(block_sum(m2, s_warp[1]), &s_part[1], S) / (float)E;
  const float rstd = rsqrtf(var + eps);
  // every warp has read the partials: the others may go on
  cluster_arrive();

  if (rank == 0 && threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  // the channel c and offset r of this thread's first element, then steps
  // of 4 T elements
  const int step = 4 * T, q_step = step / HW, r_step = step - q_step * HW;
  int c = (4 * (s0 + (int)threadIdx.x)) / HW;
  int r = 4 * (s0 + (int)threadIdx.x) - c * HW;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = s0 + threadIdx.x + k * T;
    if (i < s1) {
      float o[4];
      int cc = c - c_lo, rr = r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j > 0 && ++rr == HW) {
          rr = 0;
          ++cc;
        }
        o[j] = 0.f;
        if (4 * i + j < E)
          o[j] = fmaf(part_of(v[k], j) - mean, rstd * s_chan[cc],
                      s_chan[nc + cc]);
      }
      if (vec) {
        reinterpret_cast<float4*>(yg)[i] = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * i + j < E) yg[4 * i + j] = o[j];
      }
    }
    c += q_step;
    r += r_step;
    if (r >= HW) {
      r -= HW;
      ++c;
    }
  }
  cluster_wait();
}

// Dynamic shared memory of a slice of `per` float4s: gamma and beta of the
// channels it can touch.
int smem_bytes(int per, int hw, int cg) {
  const long long nc = (4ll * per - 1) / hw + 2;
  return (int)(2 * 4 * (nc < cg ? nc : cg));
}

struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};

}  // namespace

// Allows clusters of up to 16 CTAs (8 is the portable limit) on `device`.
// Called once per device when the library loads, so that no attribute is
// set inside a graph capture.  Returns a cudaError_t.
extern "C" int dynaboa_group_norm_init(int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)cudaFuncSetAttribute(
      dynaboa_group_norm_fwd, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
}

// Plain C entry for ctypes.  x and y are contiguous float32 (n, c, hw) on
// `device`; gamma and beta (c,) or null; mean and rstd (n, g) or both null.
// `cluster` CTAs of `threads` threads, each holding up to 8 float4s, must
// cover a group: cluster * threads * 32 >= c / g * hw.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dynaboa_group_norm_forward(const void* x, const void* gamma,
                                          const void* beta, void* y,
                                          void* mean, void* rstd, int n, int c,
                                          int g, int hw, float eps,
                                          int cluster, int threads,
                                          int device, void* stream) {
  if (n <= 0 || c <= 0 || g <= 0 || c % g != 0 || hw <= 0 || n * g > 65535 ||
      cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long e = (long long)(c / g) * hw;
  if ((long long)cluster * threads * kPerThread * 4 < e)
    return (int)cudaErrorInvalidValue;
  const bool vec = e % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int per = (int)(((e + 3) / 4 + cluster - 1) / cluster);
  const int smem = smem_bytes(per, hw, c / g);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n * g, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dynaboa_group_norm_fwd, static_cast<const float*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), c, g, hw, (int)e, eps, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
