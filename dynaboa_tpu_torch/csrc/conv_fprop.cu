// Forward convolution for Hopper (sm_90a): an fp32 implicit GEMM whose
// reduction is split over a thread-block cluster.
//
// Replaces no TPU kernel: the JAX package's convolutions are Flax's nn.Conv,
// which XLA compiles for the TPU.  It was added because on the card cuDNN's
// fp32 forward (sm80_xmma_fprop_implicit_gemm_f32f32_..._nchwkcrs_nchw) ran
// HMR's ResNet-50 at about a tenth of the fp32 peak and took about a third
// of the device's time in the benchmark's 3DPW cells.  The batch is 1 to 3
// images, so the late layers have few output pixels: layer4's 3x3
// convolution at N = 1 is a 512 x 49 x 4,608 GEMM (output channels x output
// pixels x reduction), and a tiling that does not split the reduction puts
// 4 to 16 CTAs on the 132 SMs, each walking the whole reduction alone.
//
//   y[n, k, p] = sum over (c, r, s) of w[k, c, r, s] * x[n, c, ih(p, r), iw(p, s)]
//
// with zeros outside the input (the padding): a GEMM of A = w viewed as the
// row-major (K x C*R*S) matrix and B = the (C*R*S x N*P*Q) columns gathered
// from x (im2col, never materialised) into the (K x N*P*Q) output.
//
// What bounds it.  2 * K * C*R*S * N*P*Q FLOPs: 8.17 GFLOP for the 53
// convolutions of one 224^2 image row, 122 us at the H100 SXM data sheet's
// 67 TFLOP/s of fp32 FMA outside the tensor cores; the weights are 93.8 MB a
// forward (28 us at 3.35 TB/s) and the activations less.  So the FMA rate
// bounds it.  TF32 or 3xTF32 emulation on the tensor cores would not be the
// configuration's float32 arithmetic: every product and sum here is an fp32
// FFMA in registers.
//
// What this design does:
//  * A CTA of 256 threads computes a BM x BN output tile (64 x 64, or
//    128 x 32 where the output has few pixels), 4 x 4 outputs a thread, over
//    a ring of 4 stages of 16-deep slices of A and B in shared memory.  A
//    (w's rows) keeps its own order and comes by 16-byte cp.async (4-byte
//    where C*R*S is no multiple of 4: conv1).  B comes by 16-byte cp.async
//    for a 1x1, stride-1 convolution whose pixels are contiguous and
//    aligned; otherwise (the 3x3 and 7x7 gathers, 7x7 images, strided 1x1)
//    element by element through registers: loaded when its step is issued,
//    stored to shared memory after the current step's products, with zeros
//    at the padding and the ragged edges.  A warp reads four rows of A and
//    32 consecutive columns of B at a time, without bank conflicts.
//  * The reduction C*R*S is split over a cluster of up to 16 CTAs sharing
//    one output tile, each taking a contiguous share of the 16-deep steps.
//    The wrapper's plan (kernels/conv.py:plan) picks the tile and the split
//    from the shape alone, so that about 200 CTAs (one and a half a SM) or
//    more are in flight where the reduction is long enough.
//  * The partial tiles meet through distributed shared memory: each CTA
//    writes its partial tile into its own shared memory (the ring, free by
//    then), a cluster barrier publishes it, and each CTA loads its share of
//    the tile from every rank at once (mapa, ld.shared::cluster) and sums
//    the ranks in rank order.  So there are no atomics, no second pass and
//    no workspace, and every run, eager or replayed in a CUDA graph, gives
//    the same bits.
//  * The gather of the 3x3 and 7x7 convolutions reads a table of the
//    slice's (c, r, s) offsets built in shared memory at the start; a 1x1
//    convolution without padding needs none.  The input may have any
//    strides (conv1 reads a channels_last view of the NHWC crop).  The
//    output is NCHW, or channels_last where ATen's convolution would give
//    that; the partial tile is laid out with the output's contiguous axis
//    last, so that the stores are coalesced either way.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise; the cluster and shared-memory attributes are set once when
//    the library loads (dynaboa_conv_fprop_init), never in a graph capture.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_common.cuh"

namespace {

struct ConvArgs {
  const float* x;
  const float* w;
  float* y;
  int C, H, W;          // input channels and size
  int K, P, Q;          // output channels and size
  int R, S, stride, pad;
  int sN, sC, sH, sW;   // input strides, in elements
  int kred;             // C * R * S
  int ncol;             // N * P * Q
  int split;            // CTAs of a cluster, one share of the reduction each
  int cl;               // 1: channels_last output, 0: NCHW
  int vec;              // float4 stores: P * Q % 4 == 0 (NCHW), K % 4 == 0 (cl)
  int vec_a;            // 16-byte loads of w: C*R*S % 4 == 0
  int vec_b;            // 16-byte loads of x's pixels (1x1, stride 1, rows
                        // contiguous, P * Q % 4 == 0, 16-byte aligned)
};

// Output channel m, columns col .. col + 3 (column = n * P * Q + pixel).
__device__ __forceinline__ void store_nchw(const ConvArgs& a, int m, int col,
                                           float4 v) {
  if (m >= a.K) return;
  const int pq = a.P * a.Q;
  if (a.vec) {  // the 4 columns lie in one image, 16-byte aligned
    if (col < a.ncol) {
      const int n = col / pq;
      *reinterpret_cast<float4*>(a.y + ((size_t)n * a.K + m) * pq +
                                 (col - n * pq)) = v;
    }
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = col + i;
    if (c < a.ncol) {
      const int n = c / pq;
      a.y[((size_t)n * a.K + m) * pq + (c - n * pq)] = e[i];
    }
  }
}

// Column col, output channels m .. m + 3: channels_last, y[col * K + m].
__device__ __forceinline__ void store_cl(const ConvArgs& a, int col, int m,
                                         float4 v) {
  if (col >= a.ncol) return;
  float* p = a.y + (size_t)col * a.K + m;
  if (a.vec) {  // K % 4 == 0, so m < K covers all four
    if (m < a.K) *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (m + i < a.K) p[i] = e[i];
}

template <int BM, int BN>
__host__ __device__ constexpr int ring_floats() {
  return kStages * (BM * (kBK + 4) + kBK * BN);
}

// Launched as a grid (split * tiles of N*P*Q, tiles of K) of clusters
// (split, 1, 1): a cluster's CTAs share one output tile and split its
// reduction, so a CTA's rank is blockIdx.x % split.  `kOneByOne`: a 1x1
// kernel without padding (no table, no bounds on the input's rows).
template <int BM, int BN, bool kOneByOne>
__global__ void __launch_bounds__(kThreads, 3)
    dynaboa_conv_fprop(const ConvArgs a) {
  static_assert(BM * BN == 16 * kThreads, "4 x 4 outputs a thread");
  static_assert(BN % 32 == 0 && BM % 16 == 0, "warps of 16 x 32 outputs");
  static_assert(ring_floats<BM, BN>() >= BM * BN, "the partial tile fits");
  extern __shared__ __align__(16) float smem[];
  // A stored [m][k] (w's own order), rows padded to 20 floats: the four
  // rows a warp reads at once fall on four different groups of banks
  constexpr int kAPitch = kBK + 4;
  constexpr int kAStage = BM * kAPitch;
  constexpr int kBStage = kBK * BN;
  float* const As = smem;
  float* const Bs = smem + kStages * kAStage;
  int2* const table =
      reinterpret_cast<int2*>(smem + ring_floats<BM, BN>());

  const int tid = threadIdx.x;
  const int split = a.split;
  const int rank = (int)blockIdx.x % split;
  const int col0 = ((int)blockIdx.x / split) * BN;
  const int m0 = (int)blockIdx.y * BM;
  // this rank's share of the 16-deep steps, the floor or the ceiling of
  // steps / split: [k_lo, k_hi) of the reduction
  const int steps_all = (a.kred + kBK - 1) / kBK;
  const int s_lo = rank * steps_all / split;
  const int steps = (rank + 1) * steps_all / split - s_lo;
  const int k_lo = s_lo * kBK;
  const int k_hi = min(k_lo + steps * kBK, a.kred);

  if constexpr (!kOneByOne) {
    // reduction index -> (offset of (c, r, s) in x, r << 16 | s)
    const int rs_n = a.R * a.S;
    for (int i = tid; i < k_hi - k_lo; i += kThreads) {
      const int kk = k_lo + i;
      const int c = kk / rs_n, rs = kk - c * rs_n;
      const int r = rs / a.S, s = rs - r * a.S;
      table[i] = make_int2(c * a.sC + r * a.sH + s * a.sW, (r << 16) | s);
    }
    __syncthreads();
  }

  const int pq = a.P * a.Q;
  // B, element by element: each thread loads one column (its output
  // pixel) at kBLoads depths
  constexpr int kBRows = kThreads / BN;
  constexpr int kBLoads = kBK / kBRows;
  const int bj = tid % BN, bk = tid / BN;
  const int col = col0 + bj;
  const bool col_ok = col < a.ncol;
  int ih0 = 0, iw0 = 0, base = 0;
  if (col_ok) {
    const int n = col / pq, p = col - n * pq;
    const int oh = p / a.Q, ow = p - oh * a.Q;
    ih0 = oh * a.stride - a.pad;
    iw0 = ow * a.stride - a.pad;
    base = n * a.sN + ih0 * a.sH + iw0 * a.sW;
  }
  // B, 16 bytes at a time (1x1 only): each thread loads four columns of
  // one depth
  constexpr int kBVecs = kBK * BN / 4;
  const int vb_k = tid / (BN / 4), vb_c = col0 + (tid % (BN / 4)) * 4;
  const bool vb_ok = tid < kBVecs && vb_c < a.ncol;
  int vb_base = 0;
  if (vb_ok) {
    const int n = vb_c / pq;
    vb_base = n * a.sN + (vb_c - n * pq);
  }

  // the step's asynchronous copies: A, and B where it comes 16 bytes at a
  // time
  auto copy_async = [&](int slot, int step) {
    const int kb = k_lo + step * kBK;
    float* as = As + slot * kAStage;
    float* bs = Bs + slot * kBStage;
    if (a.vec_a) {
#pragma unroll
      for (int i = 0; i < BM * kBK / 4 / kThreads; ++i) {
        const int q = tid + i * kThreads;
        const int m = q / (kBK / 4), k = (q % (kBK / 4)) * 4;
        const bool ok = kb + k < k_hi && m0 + m < a.K;
        cp_async16(as + m * kAPitch + k,
                   ok ? a.w + (size_t)(m0 + m) * a.kred + kb + k : a.w, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM / (kThreads / kBK); ++i) {
        const int m = tid / kBK + i * (kThreads / kBK), k = tid % kBK;
        const bool ok = kb + k < k_hi && m0 + m < a.K;
        cp_async4(as + m * kAPitch + k,
                  ok ? a.w + (size_t)(m0 + m) * a.kred + kb + k : a.w, ok);
      }
    }
    if (kOneByOne && a.vec_b) {
      if (tid < kBVecs) {
        const int kk = kb + vb_k;
        const bool ok = vb_ok && kk < k_hi;
        cp_async16(bs + vb_k * BN + (tid % (BN / 4)) * 4,
                   ok ? a.x + vb_base + kk * a.sC : a.x, ok);
      }
    }
  };
  // B element by element goes through registers: loaded (ld.global.nc)
  // when its step is issued, stored to shared memory after the current
  // step's products (into the slot the step before last has freed)
  const bool gather_b = !(kOneByOne && a.vec_b);
  float breg[kBLoads];
  auto gather = [&](int step) {
    const int kb = k_lo + step * kBK;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int r = bk + i * kBRows;
      const int kk = kb + r;
      bool ok = col_ok && kk < k_hi;
      int off;
      if constexpr (kOneByOne) {
        off = kk * a.sC;
      } else {
        const int2 e = table[ok ? kk - k_lo : 0];
        off = e.x;
        ok = ok && (unsigned)(ih0 + (e.y >> 16)) < (unsigned)a.H &&
             (unsigned)(iw0 + (e.y & 0xffff)) < (unsigned)a.W;
      }
      breg[i] = ok ? __ldg(a.x + base + off) : 0.f;
    }
  };
  auto stage_b = [&](int slot) {
    float* bs = Bs + slot * kBStage;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) bs[(bk + i * kBRows) * BN + bj] = breg[i];
  };

  constexpr int kWarpsN = BN / 32;
  constexpr int kRowStep = BM / 4;
  const int warp = tid >> 5, lane = tid & 31;
  // rows tm + i * BM / 4 (i < 4), columns tn * 4 .. + 3
  const int tm = (warp / kWarpsN) * 4 + (lane >> 3);
  const int tn = (warp % kWarpsN) * 8 + (lane & 7);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      copy_async(s, s);
      if (gather_b) {
        gather(s);
        stage_b(s);
      }
    }
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    // the step's slices have landed, and every thread is done with the
    // slot the next copies overwrite
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps) {
      copy_async(next % kStages, next);
      if (gather_b) gather(next);
    }
    cp_async_commit();
    const float* as = As + (step % kStages) * kAStage + tm * kAPitch;
    const float* bs = Bs + (step % kStages) * kBStage + tn * 4;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * kRowStep * kAPitch +
                                                 k4);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bv[k] = *reinterpret_cast<const float4*>(bs + (k4 + k) * BN);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = k == 0 ? av[i].x : k == 1 ? av[i].y
                           : k == 2 ? av[i].z : av[i].w;
          acc[i][0] = fmaf(ai, bv[k].x, acc[i][0]);
          acc[i][1] = fmaf(ai, bv[k].y, acc[i][1]);
          acc[i][2] = fmaf(ai, bv[k].z, acc[i][2]);
          acc[i][3] = fmaf(ai, bv[k].w, acc[i][3]);
        }
      }
    }
    if (gather_b && next < steps) stage_b(next % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partial tile, the output's contiguous axis last: [m][col] for NCHW,
  // [col][m] for channels_last
  float* const part = smem;
  if (a.cl) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(tn * 4 + j) * BM + tm + i * kRowStep] = acc[i][j];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(part + (tm + i * kRowStep) * BN + tn * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster_arrive();
  cluster_wait();

  // this rank's share of the tile's float4s, summed over the ranks in order
  constexpr int kChunks = BM * BN / 4;
  const int fast4 = a.cl ? BM / 4 : BN / 4;
  const int q_hi = (rank + 1) * kChunks / split;
  for (int q = rank * kChunks / split + tid; q < q_hi; q += kThreads) {
    const float* p = part + 4 * q;
    // every rank's partial in flight at once, then summed in rank order
    float4 v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < split) v[r] = load_cluster4(p, r);
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < split) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    }
    const int slow = q / fast4, fast = (q - slow * fast4) * 4;
    if (a.cl)
      store_cl(a, col0 + slow, m0 + fast, sum);
    else
      store_nchw(a, m0 + slow, col0 + fast, sum);
  }
  // a CTA's shared memory must outlive its neighbours' reads
  cluster_arrive();
  cluster_wait();
}

template <int BM, int BN, bool kOneByOne>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      dynaboa_conv_fprop<BM, BN, kOneByOne>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dynaboa_conv_fprop<BM, BN, kOneByOne>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmemBytes);
}

template <int BM, int BN, bool kOneByOne>
cudaError_t launch(const ConvArgs& a, int tiles_n, int tiles_m, int smem,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split * tiles_n, tiles_m, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dynaboa_conv_fprop<BM, BN, kOneByOne>, a);
}

// Dynamic shared memory of a launch: the ring, and for a kernel with a
// gather table one int2 per reduction index of the longest share.
int smem_bytes(int bm, int kred, int split, bool one_by_one) {
  const int ring = bm == 64 ? ring_floats<64, 64>() : ring_floats<128, 32>();
  const int steps_all = (kred + kBK - 1) / kBK;
  const int share = (steps_all + split - 1) / split * kBK;
  return 4 * ring + (one_by_one ? 0 : 8 * share);
}

}  // namespace

// Allows clusters of up to 16 CTAs (8 is the portable limit) and up to
// kMaxSmemBytes of dynamic shared memory for every instance, on `device`.
// Called once per device when the library loads, so that no attribute is
// set inside a graph capture.  Returns a cudaError_t.
extern "C" int dynaboa_conv_fprop_init(int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err;
  if ((err = set_attributes<64, 64, true>()) != cudaSuccess ||
      (err = set_attributes<64, 64, false>()) != cudaSuccess ||
      (err = set_attributes<128, 32, true>()) != cudaSuccess ||
      (err = set_attributes<128, 32, false>()) != cudaSuccess)
    return (int)err;
  return 0;
}

// Plain C entry for ctypes.  x is float32 of shape (N, C, H, W) with the
// element strides g[12..15]; w contiguous float32 (K, C, R, S); y float32
// (N, K, P, Q), contiguous NCHW (g[16] = 0) or channels_last (g[16] = 1).
// g holds device, N, C, H, W, K, P, Q, R, S, stride, pad, the strides of x,
// the output layout, BM (64 or 128; BN is 64 or 32) and the cluster's
// split (1 to 16, at most the 16-deep steps of C*R*S).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dynaboa_conv_fprop_forward(const void* x, const void* w,
                                          void* y, const int* g,
                                          void* stream) {
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<float*>(y);
  const int device = g[0], n = g[1];
  a.C = g[2];
  a.H = g[3];
  a.W = g[4];
  a.K = g[5];
  a.P = g[6];
  a.Q = g[7];
  a.R = g[8];
  a.S = g[9];
  a.stride = g[10];
  a.pad = g[11];
  a.sN = g[12];
  a.sC = g[13];
  a.sH = g[14];
  a.sW = g[15];
  a.cl = g[16];
  const int bm = g[17];
  a.split = g[18];
  if (n <= 0 || a.C <= 0 || a.K <= 0 || a.R <= 0 || a.S <= 0 ||
      a.stride <= 0 || a.pad < 0 || a.R >= (1 << 15) ||
      a.S >= (1 << 15) || a.P <= 0 || a.Q <= 0 ||
      a.P != (a.H + 2 * a.pad - a.R) / a.stride + 1 ||
      a.Q != (a.W + 2 * a.pad - a.S) / a.stride + 1 ||
      (bm != 64 && bm != 128) || (a.cl != 0 && a.cl != 1) ||
      a.split < 1 || a.split > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const long long kred = (long long)a.C * a.R * a.S;
  const long long ncol = (long long)n * a.P * a.Q;
  if (kred >= (1ll << 31) || ncol * a.K >= (1ll << 31) ||
      a.split > (kred + kBK - 1) / kBK)
    return (int)cudaErrorInvalidValue;
  a.kred = (int)kred;
  a.ncol = (int)ncol;
  a.vec = a.cl ? a.K % 4 == 0 : (a.P * a.Q) % 4 == 0;
  a.vec_a = a.kred % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  a.vec_b = a.R == 1 && a.S == 1 && a.pad == 0 && a.stride == 1 &&
            a.sW == 1 && a.sH == a.W && (a.P * a.Q) % 4 == 0 &&
            a.sN % 4 == 0 && a.sC % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int bn = bm == 64 ? 64 : 32;
  const bool one = a.R == 1 && a.S == 1 && a.pad == 0;
  const long long tiles_n = (ncol + bn - 1) / bn;
  const int tiles_m = (a.K + bm - 1) / bm;
  if (tiles_n * a.split > 0x7fffffffll || tiles_m > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(bm, a.kred, a.split, one);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bm == 64)
    err = one ? launch<64, 64, true>(a, (int)tiles_n, tiles_m, smem, s)
              : launch<64, 64, false>(a, (int)tiles_n, tiles_m, smem, s);
  else
    err = one ? launch<128, 32, true>(a, (int)tiles_n, tiles_m, smem, s)
              : launch<128, 32, false>(a, (int)tiles_n, tiles_m, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
