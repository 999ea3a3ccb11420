// Data gradient of a convolution for Hopper (sm_90a): an fp32 implicit GEMM
// whose reduction is split over a thread-block cluster, computed phase by
// phase for a strided convolution.
//
// Replaces no TPU kernel: the JAX package's convolutions are Flax's nn.Conv,
// whose gradients XLA derives and compiles for the TPU.  It was added because
// on the card cuDNN's fp32 data gradient (dgrad_engine, sm80_xmma_dgrad_
// implicit_gemm, and at HRNet's 64x48 maps FFT algorithms with their complex
// GEMMs and transforms) ran the backward of HMR's ResNet-50 and of CLIFF's
// HRNet-W48 at under a tenth of the fp32 peak in CLIFF: the batch is 1 to 3
// images, so HRNet's low-resolution branches have few pixels (the 8x6 branch
// at N = 3 has 144 input pixels against a reduction of 384 * 9 = 3,456), and
// a tiling that does not split the reduction leaves most of the 132 SMs
// idle.  It is the forward kernel's design (conv_fprop.cu) turned onto the
// transposed problem:
//
//   dx[n, c, h, w] = sum over (k, r, s) of
//                    w[k, c, r, s] * dy[n, k, (h + pad - r) / stride,
//                                         (w + pad - s) / stride]
//
// over the taps where the division is exact and the index lies inside dy: a
// GEMM of A = w read as the (C x K*R*S) matrix (w transposed; the taps run
// as in a convolution of dy with the flipped kernel) and B = the
// (K*R*S x N*H*W) columns gathered from dy, never materialised, into the
// (C x N*H*W) gradient of the input.
//
// What bounds it.  2 * C * K*R*S * N*P*Q FLOPs, the forward's: for the 324
// convolutions of one CLIFF image row whose input needs a gradient, 33.80
// GFLOP, 505 us at the H100 SXM data sheet's 67 TFLOP/s of fp32 FMA outside
// the tensor cores; HMR's 52, 7.94 GFLOP, 118 us.  Their weights (301 MB and
// 93.8 MB) take 90 and 28 us at 3.35 TB/s.  So the FMA rate bounds it.
// Every product and sum is an fp32 FFMA in registers: no tensor cores, no
// TF32.
//
// What this design does:
//  * Strided convolutions are computed by phases, never on inserted zeros.
//    The input's pixels split into stride^2 classes by (h mod stride,
//    w mod stride); a class is a dense stride-1 problem over its own pixels
//    and its own taps (those r with r = h + pad mod stride), each tap a
//    fixed shift (h + pad - r) / stride of dy's rows.  One launch runs every
//    class, one per grid z; a class that no tap reaches (the odd pixels of a
//    1x1 stride-2 convolution) is written as zeros by its own CTAs.
//  * A CTA of 256 threads computes a BM x BN tile of dx (64 x 64, or
//    128 x 32 where a class has few pixels), 4 x 4 outputs a thread, over a
//    ring of 4 stages of 16-deep slices of A and B in shared memory.  The
//    reduction runs k-major (k, then the class's taps), so a step's slice of
//    w for one input channel is a few runs of consecutive floats.  A is
//    stored [k][c], so that a 1x1 kernel's rows (w[k, c0 .. c0 + 3]) come by
//    16-byte cp.async; a larger kernel's come element by element, each to
//    its transposed place, by 4-byte cp.async through a table of the
//    slice's weight offsets.  B comes by 16-byte cp.async where a 1x1
//    kernel's class reads dy's pixels densely and aligned; otherwise element
//    by element through registers, through a table of the slice's
//    (k, shift) offsets, with zeros beyond dy's edges.
//  * The reduction K * taps is split over a cluster of up to 16 CTAs
//    sharing one tile, each taking a contiguous share of the 16-deep steps;
//    the wrapper's plan (kernels/conv.py:dgrad_plan) picks the tile and the
//    split from the shape alone.  The partial tiles meet through distributed
//    shared memory, summed in rank order, as in the forward kernel: no
//    atomics, no second pass, no workspace, and every run, eager or replayed
//    in a CUDA graph, gives the same bits.
//  * dy may have any strides.  dx is NCHW, or channels_last where ATen's
//    convolution_backward would give that; the partial tile is laid out with
//    dx's contiguous axis last, so that the stores are coalesced either way.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise; the cluster and shared-memory attributes are set once when
//    the library loads (dynaboa_conv_dgrad_init), never in a graph capture.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_common.cuh"

namespace {

struct DgradArgs {
  const float* dy;
  const float* w;
  float* dx;
  int n;                // images
  int C, H, W;          // input channels and size (dx)
  int K, P, Q;          // output channels and size (dy)
  int R, S, stride, pad;
  int sN, sK, sP, sQ;   // dy's strides, in elements
  int split;            // CTAs of a cluster, one share of the reduction each
  int cl;               // 1: channels_last dx, 0: NCHW
  int vec;              // float4 stores: stride 1 and H * W % 4 == 0 (NCHW),
                        // C % 4 == 0 (channels_last)
  int vec_a;            // 16-byte loads of w: 1x1, C % 4 == 0, aligned
  int vec_b;            // 16-byte loads of dy's pixels (1x1, no padding, rows
                        // contiguous, P * Q % 4 == 0, 16-byte aligned)
};

// One class of the phase split: the pixels (h, w) with h = a mod stride and
// w = b mod stride, Hz x Wz of them, and its taps r = r0, r0 + stride, ...
// (tr of them) and s = s0, ... (ts).
struct Phase {
  int a, b, Hz, Wz, r0, s0, tr, ts;
  __device__ explicit Phase(const DgradArgs& g, int z) {
    a = z / g.stride;
    b = z - a * g.stride;
    Hz = a < g.H ? (g.H - a + g.stride - 1) / g.stride : 0;
    Wz = b < g.W ? (g.W - b + g.stride - 1) / g.stride : 0;
    r0 = (a + g.pad) % g.stride;
    s0 = (b + g.pad) % g.stride;
    tr = r0 < g.R ? (g.R - 1 - r0) / g.stride + 1 : 0;
    ts = s0 < g.S ? (g.S - 1 - s0) / g.stride + 1 : 0;
  }
};

// The offset in dx of the class's column `col` (image, row, column of the
// class's pixels) at channel 0.
__device__ __forceinline__ size_t pixel(const DgradArgs& g, const Phase& ph,
                                        int col) {
  const int hw = ph.Hz * ph.Wz;
  const int n = col / hw, q = col - n * hw;
  const int i = q / ph.Wz, j = q - i * ph.Wz;
  const int h = ph.a + i * g.stride, w = ph.b + j * g.stride;
  return g.cl ? (((size_t)n * g.H + h) * g.W + w) * g.C
              : (size_t)n * g.C * g.H * g.W + (size_t)h * g.W + w;
}

// Channel c, the class's columns col .. col + 3 (NCHW).
__device__ __forceinline__ void store_nchw(const DgradArgs& g,
                                           const Phase& ph, int ncol, int c,
                                           int col, float4 v) {
  if (c >= g.C) return;
  const size_t plane = (size_t)c * g.H * g.W;
  if (g.vec) {  // stride 1: the 4 columns lie in one image, 16-byte aligned
    if (col < ncol)
      *reinterpret_cast<float4*>(g.dx + pixel(g, ph, col) + plane) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < ncol) g.dx[pixel(g, ph, col + i) + plane] = e[i];
}

// The class's column col, channels c .. c + 3 (channels_last).
__device__ __forceinline__ void store_cl(const DgradArgs& g, const Phase& ph,
                                         int ncol, int col, int c, float4 v) {
  if (col >= ncol) return;
  float* p = g.dx + pixel(g, ph, col) + c;
  if (g.vec) {  // C % 4 == 0, so c < C covers all four
    if (c < g.C) *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < g.C) p[i] = e[i];
}

template <int BM, int BN>
__host__ __device__ constexpr int ring_floats() {
  return kStages * (kBK * (BM + 4) + kBK * BN);
}

// Launched as a grid (split * tiles of a class's columns, tiles of C,
// stride^2 classes) of clusters (split, 1, 1): a cluster's CTAs share one
// tile and split its reduction, so a CTA's rank is blockIdx.x % split.
// `kOneByOne`: a 1x1 kernel without padding (no tables; one class has the
// one tap, at no shift, and the others none).
template <int BM, int BN, bool kOneByOne>
__global__ void __launch_bounds__(kThreads, 3)
    dynaboa_conv_dgrad(const DgradArgs g) {
  static_assert(BM * BN == 16 * kThreads, "4 x 4 outputs a thread");
  static_assert(BN % 32 == 0 && BM % 16 == 0, "warps of 16 x 32 outputs");
  static_assert(ring_floats<BM, BN>() >= BM * BN, "the partial tile fits");
  extern __shared__ __align__(16) float smem[];
  // A stored [k][c], rows padded to BM + 4 floats: the sixteen depths that
  // a warp's element-wise copies write fall on different groups of banks
  constexpr int kAPitch = BM + 4;
  constexpr int kAStage = kBK * kAPitch;
  constexpr int kBStage = kBK * BN;
  float* const As = smem;
  float* const Bs = smem + kStages * kAStage;

  const Phase ph(g, (int)blockIdx.z);
  const int ncol = g.n * ph.Hz * ph.Wz;
  const int split = g.split;
  const int rank = (int)blockIdx.x % split;
  const int col0 = ((int)blockIdx.x / split) * BN;
  const int m0 = (int)blockIdx.y * BM;
  // the whole cluster shares col0: a class with fewer columns than the
  // largest leaves its last clusters without a tile
  if (col0 >= ncol) return;
  const int ts = ph.ts;
  const int taps = ph.tr * ts;
  const int kred = g.K * taps;

  constexpr int kChunks = BM * BN / 4;
  const int fast4 = g.cl ? BM / 4 : BN / 4;
  if (kred == 0) {
    // no tap reaches this class's pixels: this rank's share of the tile is
    // zeros, with no reduction to wait for
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int q_hi = (rank + 1) * kChunks / split;
    for (int q = rank * kChunks / split + (int)threadIdx.x; q < q_hi;
         q += kThreads) {
      const int slow = q / fast4, fast = (q - slow * fast4) * 4;
      if (g.cl)
        store_cl(g, ph, ncol, col0 + slow, m0 + fast, zero);
      else
        store_nchw(g, ph, ncol, m0 + slow, col0 + fast, zero);
    }
    return;
  }

  const int tid = threadIdx.x;
  // this rank's share of the 16-deep steps, the floor or the ceiling of
  // steps / split: [k_lo, k_hi) of the class's reduction
  const int steps_all = (kred + kBK - 1) / kBK;
  const int s_lo = rank * steps_all / split;
  const int steps = (rank + 1) * steps_all / split - s_lo;
  const int k_lo = s_lo * kBK;
  const int k_hi = min(k_lo + steps * kBK, kred);
  const int rs_n = g.R * g.S;

  // reduction index kk = k * taps + t -> dy offset of (k, the tap's shift)
  // and the shift packed (dr << 16 | ds & 0xffff); w offset of (k, r, s)
  int2* const tab_b =
      reinterpret_cast<int2*>(smem + ring_floats<BM, BN>());
  int* const tab_a = reinterpret_cast<int*>(tab_b + (k_hi - k_lo));
  if constexpr (!kOneByOne) {
    for (int i = tid; i < k_hi - k_lo; i += kThreads) {
      const int kk = k_lo + i;
      const int k = kk / taps, t = kk - k * taps;
      const int ri = t / ts, si = t - ri * ts;
      const int r = ph.r0 + ri * g.stride, s = ph.s0 + si * g.stride;
      const int dr = (ph.a + g.pad - r) / g.stride;
      const int ds = (ph.b + g.pad - s) / g.stride;
      tab_b[i] = make_int2(k * g.sK + dr * g.sP + ds * g.sQ,
                           (int)((unsigned)dr << 16) | (ds & 0xffff));
      tab_a[i] = k * g.C * rs_n + r * g.S + s;
    }
    __syncthreads();
  }

  // B, element by element: each thread loads one column (its pixel) at
  // kBLoads depths
  constexpr int kBRows = kThreads / BN;
  constexpr int kBLoads = kBK / kBRows;
  const int bj = tid % BN, bk = tid / BN;
  const int col = col0 + bj;
  const bool col_ok = col < ncol;
  int i0 = 0, j0 = 0, base = 0;
  if (col_ok) {
    const int hw = ph.Hz * ph.Wz;
    const int n = col / hw, q = col - n * hw;
    i0 = q / ph.Wz;
    j0 = q - i0 * ph.Wz;
    base = n * g.sN + i0 * g.sP + j0 * g.sQ;
  }
  // B, 16 bytes at a time (1x1 only; the class's pixels are dy's): each
  // thread loads four columns of one depth
  constexpr int kBVecs = kBK * BN / 4;
  const int pq = g.P * g.Q;
  const int vb_k = tid / (BN / 4), vb_c = col0 + (tid % (BN / 4)) * 4;
  const bool vb_ok = tid < kBVecs && vb_c < ncol;
  int vb_base = 0;
  if (vb_ok) {
    const int n = vb_c / pq;
    vb_base = n * g.sN + (vb_c - n * pq);
  }

  // the step's asynchronous copies: A, and B where it comes 16 bytes at a
  // time
  auto copy_async = [&](int slot, int step) {
    const int kb = k_lo + step * kBK;
    float* as = As + slot * kAStage;
    float* bs = Bs + slot * kBStage;
    if (kOneByOne && g.vec_a) {
#pragma unroll
      for (int i = 0; i < BM * kBK / 4 / kThreads; ++i) {
        const int q = tid + i * kThreads;
        const int k = q / (BM / 4), m = (q % (BM / 4)) * 4;
        const bool ok = kb + k < k_hi && m0 + m < g.C;
        cp_async16(as + k * kAPitch + m,
                   ok ? g.w + (size_t)(kb + k) * g.C + m0 + m : g.w, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM / (kThreads / kBK); ++i) {
        const int m = tid / kBK + i * (kThreads / kBK), k = tid % kBK;
        const bool ok = kb + k < k_hi && m0 + m < g.C;
        size_t off = 0;
        if (ok) {
          if constexpr (kOneByOne)
            off = (size_t)(kb + k) * g.C + m0 + m;
          else
            off = (size_t)tab_a[kb + k - k_lo] + (size_t)(m0 + m) * rs_n;
        }
        cp_async4(as + k * kAPitch + m, g.w + off, ok);
      }
    }
    if (kOneByOne && g.vec_b) {
      if (tid < kBVecs) {
        const int kk = kb + vb_k;
        const bool ok = vb_ok && kk < k_hi;
        cp_async16(bs + vb_k * BN + (tid % (BN / 4)) * 4,
                   ok ? g.dy + vb_base + kk * g.sK : g.dy, ok);
      }
    }
  };
  // B element by element goes through registers: loaded (ld.global.nc)
  // when its step is issued, stored to shared memory after the current
  // step's products (into the slot the step before last has freed)
  const bool gather_b = !(kOneByOne && g.vec_b);
  float breg[kBLoads];
  auto gather = [&](int step) {
    const int kb = k_lo + step * kBK;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int kk = kb + bk + i * kBRows;
      bool ok = col_ok && kk < k_hi;
      int off;
      if constexpr (kOneByOne) {
        off = kk * g.sK;
      } else {
        const int2 e = tab_b[ok ? kk - k_lo : 0];
        off = e.x;
        ok = ok && (unsigned)(i0 + (e.y >> 16)) < (unsigned)g.P &&
             (unsigned)(j0 + (int)(short)(e.y & 0xffff)) < (unsigned)g.Q;
      }
      breg[i] = ok ? __ldg(g.dy + base + off) : 0.f;
    }
  };
  auto stage_b = [&](int slot) {
    float* bs = Bs + slot * kBStage;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) bs[(bk + i * kBRows) * BN + bj] = breg[i];
  };

  constexpr int kWarpsN = BN / 32;
  const int warp = tid >> 5, lane = tid & 31;
  // rows tm * 4 .. + 3, columns tn * 4 .. + 3
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
    const float* as = As + (step % kStages) * kAStage + tm * 4;
    const float* bs = Bs + (step % kStages) * kBStage + tn * 4;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(as + k * kAPitch);
      const float4 bv = *reinterpret_cast<const float4*>(bs + k * BN);
      const float ai[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(ai[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(ai[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(ai[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(ai[i], bv.w, acc[i][3]);
      }
    }
    if (gather_b && next < steps) stage_b(next % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partial tile, dx's contiguous axis last: [c][col] for NCHW,
  // [col][c] for channels_last
  float* const part = smem;
  if (g.cl) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(part + (tn * 4 + j) * BM + tm * 4) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(part + (tm * 4 + i) * BN + tn * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster_arrive();
  cluster_wait();

  // this rank's share of the tile's float4s, summed over the ranks in order
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
    if (g.cl)
      store_cl(g, ph, ncol, col0 + slow, m0 + fast, sum);
    else
      store_nchw(g, ph, ncol, m0 + slow, col0 + fast, sum);
  }
  // a CTA's shared memory must outlive its neighbours' reads
  cluster_arrive();
  cluster_wait();
}

template <int BM, int BN, bool kOneByOne>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      dynaboa_conv_dgrad<BM, BN, kOneByOne>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dynaboa_conv_dgrad<BM, BN, kOneByOne>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmemBytes);
}

template <int BM, int BN, bool kOneByOne>
cudaError_t launch(const DgradArgs& g, int tiles_n, int tiles_m,
                   int classes, int smem, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.split * tiles_n, tiles_m, classes);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dynaboa_conv_dgrad<BM, BN, kOneByOne>, g);
}

}  // namespace

// Allows clusters of up to 16 CTAs (8 is the portable limit) and up to
// kMaxSmemBytes of dynamic shared memory for every instance, on `device`.
// Called once per device when the library loads, so that no attribute is
// set inside a graph capture.  Returns a cudaError_t.
extern "C" int dynaboa_conv_dgrad_init(int device) {
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

// Plain C entry for ctypes.  dy is float32 of shape (N, K, P, Q) with the
// element strides g[12..15]; w contiguous float32 (K, C, R, S); dx float32
// (N, C, H, W), contiguous NCHW (g[16] = 0) or channels_last (g[16] = 1).
// g holds device, N, C, H, W, K, P, Q, R, S, stride, pad, the strides of
// dy, dx's layout, BM (64 or 128; BN is 64 or 32) and the cluster's split
// (1 to 16).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dynaboa_conv_dgrad_backward(const void* dy, const void* w,
                                           void* dx, const int* g,
                                           void* stream) {
  DgradArgs a;
  a.dy = static_cast<const float*>(dy);
  a.w = static_cast<const float*>(w);
  a.dx = static_cast<float*>(dx);
  const int device = g[0];
  a.n = g[1];
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
  a.sK = g[13];
  a.sP = g[14];
  a.sQ = g[15];
  a.cl = g[16];
  const int bm = g[17];
  a.split = g[18];
  if (a.n <= 0 || a.C <= 0 || a.K <= 0 || a.R <= 0 || a.S <= 0 ||
      a.stride <= 0 || a.pad < 0 || a.R >= (1 << 14) || a.S >= (1 << 14) ||
      a.P <= 0 || a.Q <= 0 ||
      a.P != (a.H + 2 * a.pad - a.R) / a.stride + 1 ||
      a.Q != (a.W + 2 * a.pad - a.S) / a.stride + 1 ||
      (bm != 64 && bm != 128) || (a.cl != 0 && a.cl != 1) ||
      a.split < 1 || a.split > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  // the longest class's reduction: K times ceil(R / stride) ceil(S / stride)
  const long long tr = (a.R + a.stride - 1) / a.stride;
  const long long ts = (a.S + a.stride - 1) / a.stride;
  const long long kred = (long long)a.K * tr * ts;
  const long long ncol = (long long)a.n * ((a.H + a.stride - 1) / a.stride) *
                         ((a.W + a.stride - 1) / a.stride);
  const long long numel = (long long)a.n * a.C * a.H * a.W;
  if (kred >= (1ll << 31) || numel >= (1ll << 31) ||
      (long long)a.K * a.C * a.R * a.S >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const bool one = a.R == 1 && a.S == 1 && a.pad == 0;
  a.vec = a.cl ? a.C % 4 == 0 : a.stride == 1 && (a.H * a.W) % 4 == 0;
  a.vec_a = one && a.C % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  a.vec_b = one && a.sQ == 1 && a.sP == a.Q && (a.P * a.Q) % 4 == 0 &&
            a.sN % 4 == 0 && a.sK % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  const int bn = bm == 64 ? 64 : 32;
  const long long tiles_n = (ncol + bn - 1) / bn;
  const int tiles_m = (a.C + bm - 1) / bm;
  const int classes = a.stride * a.stride;
  if (tiles_n * a.split > 0x7fffffffll || tiles_m > 65535 || classes > 65535)
    return (int)cudaErrorInvalidValue;
  const int steps_all = (int)((kred + kBK - 1) / kBK);
  const int share = (steps_all + a.split - 1) / a.split * kBK;
  const int ring = bm == 64 ? ring_floats<64, 64>() : ring_floats<128, 32>();
  const int smem = 4 * ring + (one ? 0 : 12 * share);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tn = (int)tiles_n;
  cudaError_t err;
  if (bm == 64)
    err = one ? launch<64, 64, true>(a, tn, tiles_m, classes, smem, s)
              : launch<64, 64, false>(a, tn, tiles_m, classes, smem, s);
  else
    err = one ? launch<128, 32, true>(a, tn, tiles_m, classes, smem, s)
              : launch<128, 32, false>(a, tn, tiles_m, classes, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
