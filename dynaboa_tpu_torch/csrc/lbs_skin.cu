// SMPL pose-blendshape + linear blend skinning for Hopper (sm_90a).
//
// Replaces the Pallas kernel dynaboa_tpu/kernels/lbs.py:_skin_kernel.  Per
// (sample n, vertex v) it computes
//
//   v_posed = v_shaped[n, v] + sum_p pose_feature[n, p] * posedirs[p, :, v]
//   out[n, v] = sum_k w[k, v] * (A[n, k, :3, :3] v_posed + A[n, k, :3, 3])
//
// (the skinning sum taken as (sum_k w A_k[:3, :]) [v_posed; 1], as the plain
// version takes it).
//
// What bounds it.  Counting each input read once and each output written
// once: posedirs 207*3*6890*4 = 17,114,760 B, skinning weights 661,440 B,
// v_shaped and the output 2*82,680 B per sample, pose features and
// transforms 2,364 B per sample: 17.94 MB at N = 1, 19.12 MB at N = 8.  At
// the H100 SXM data sheet's 3.35 TB/s that is 5.36 us and 5.71 us.  The
// work is about 12.5 and 100 MFLOP, 0.19 and 1.5 us at the 67 TFLOP/s fp32
// CUDA-core rate, so memory bounds it.  Tensor cores would need TF32
// (wgmma has no fp32 mode), which keeps about three digits and would break
// the 1e-5 agreement with the plain version; at ~0.7 FLOP/byte CUDA cores
// are fast enough.
//
// What held the previous design back (one CTA of 8 warps per 32 vertices,
// samples in groups of 4 on grid.y): about 55k threads, each with ~6 scalar
// 4-byte loads in flight, ~1.3 MB in flight against the 2-3 MB that
// 3.35 TB/s times ~0.7 us of latency asks for; a prologue that loaded pose
// features and transforms before the first posedirs load; two reductions
// done by warp 0 alone; posedirs read once per group of 4 samples; 4-byte
// output stores strided by 3.  It reached 20-27 % of the bound.
//
// What this design does (each choice was timed against its neighbours on
// the card; chip_smoke.py phase 2 times the result, root PERF.md keeps the
// numbers):
//  * A layout for bulk copies, built once by the wrapper (LBSKernelSMPL):
//    V padded to a multiple of the tile T, posedirs tile-major (V/T, 207, 3,
//    T) and weights (V/T, 24, T).  A tile's rows are one contiguous,
//    16-byte-aligned block, so a stage is one cp.async.bulk copy that
//    completes on an mbarrier with expect_tx.  Padded vertices have zero
//    posedirs and weights and are never stored.
//  * One CTA per tile.  Thread 0 issues the first kInFlight = 2 of
//    kChunks = 3 stages (69 rows, 26.5 KB each at T = 32), and the third as
//    the first lands: 53 KB in flight per CTA, ~106 KB per SM with two
//    CTAs, far above Little's law's ~18 KB per SM.  Stages land in order, so
//    the blend of one overlaps the flight of the next; more, smaller stages
//    (9 or 23) or all at once were slower.  The whole tile stays resident,
//    so each stage barrier completes once per launch (phase parity 0) and
//    never wraps.
//  * The other warps request the weights (16-byte cp.async) and the first
//    group's pose features, transforms and v_shaped (4-byte cp.async) at
//    the same time; waiting on the weights through a bulk copy delayed the
//    skinning set-up below until the stages had landed.
//  * posedirs leaves HBM once per call whatever N: the CTA loops over the
//    samples in groups of 8 on its resident tile.
//  * Grid: T = 32 gives 216 CTAs, all resident at once (two per SM on 84
//    SMs, one on 48), so every CTA streams from the first cycle and the HBM
//    is shared among equal tiles.  T = 64 (108 CTAs, one per SM) and 4 warps
//    per CTA are the other geometries chip_smoke.py times.
//  * Pose blend: a warp owns 32 columns (c, t) of the tile and 4 samples (1
//    when that keeps more warps busy); its lanes are 8 float4 columns x 4 row
//    groups, so a quarter warp reads one 128-byte row segment without bank
//    conflicts.  A lane loads all its rows of a stage before its FMAs, and
//    the 4 row groups meet by a shuffle butterfly.  No phase is left to one
//    warp.
//  * Skinning: a lane owns a (sample, vertex).  Its blended transform
//    sum_k w_k A_k[:3, :] needs only the weights and transforms, so while
//    the tile is in flight the warps that have an item each sum it (in joint
//    order); after the blend only the 3x4 product with v_posed is left.
//  * The (N, T, 3) result is staged in shared memory and leaves with 16-byte
//    stores where a sample's tile is 16-byte aligned, coalesced 4-byte
//    stores otherwise (V = 6890 aligns every other sample).
//  * Deterministic: no atomics, and every sum runs in a fixed order.
//  * What still holds it back: a kernel that only reads the same 17.1 MB
//    takes most of its time under the same timing (chip_smoke.py prints
//    both), and at N = 8 on a warm L2 the blend's FMAs trail the last stage.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kP = 207;                    // pose-blendshape features (23 * 9)
constexpr int kK = 24;                     // joints
constexpr int kChunks = 3;                 // bulk-copy stages per tile
constexpr int kChunkRows = kP / kChunks;   // 69 rows of posedirs per stage
constexpr int kInFlight = 2;               // stages requested ahead
constexpr int kGroup = 8;                  // samples per pass over the tile
constexpr int kRowGroups = 4;              // row groups in a blend warp
constexpr int kRowsPerLane = (kChunkRows + kRowGroups - 1) / kRowGroups;
constexpr int kMaxWarps = 8;
static_assert(kChunks * kChunkRows == kP, "stages must cover the rows");
static_assert(kInFlight <= kChunks, "stages in flight");

// Byte offsets into the dynamic shared memory of a tile-T CTA.
template <int T>
struct Layout {
  static constexpr int kCols = 3 * T;                       // (c, t) columns
  static constexpr size_t pd = 0;                           // (P, 3, T)
  static constexpr size_t w = pd + 4ull * kP * kCols;       // (K, T)
  static constexpr size_t pf = w + 4ull * kK * T;           // (P, kGroup)
  static constexpr size_t A = pf + 4ull * kP * kGroup;      // (kGroup, K, 12)
  static constexpr size_t vp = A + 4ull * kGroup * kK * 12; // (kGroup, 3, T)
  static constexpr size_t out = vp + 4ull * kGroup * kCols; // (kGroup, T, 3)
  static constexpr size_t bytes = out + 4ull * kGroup * kCols;
  static_assert(T % 32 == 0, "warps own 32 columns and 32 vertices");
  static_assert(w % 16 == 0 && pf % 16 == 0 && A % 16 == 0 &&
                vp % 16 == 0 && out % 16 == 0, "16-byte aligned buffers");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the barrier's phase of this parity.  A copy that never lands
// traps (the launch fails with an error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i == (1u << 22)) __trap();
}

// A 4-byte asynchronous copy global -> shared (cp.async, no registers).
__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// A 16-byte asynchronous copy global -> shared.
__device__ __forceinline__ void async_copy16(float* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// One bulk copy global -> shared; completes `bytes` on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

template <int T>
__global__ void __launch_bounds__(32 * kMaxWarps)
lbs_skin_kernel(const float* __restrict__ pose_feature,  // (N, P)
                const float* __restrict__ posedirs,      // (V/T, P, 3, T)
                const float* __restrict__ v_shaped,      // (N, V, 3)
                const float* __restrict__ weights,       // (V/T, K, T)
                const float* __restrict__ rel,           // (N, K, 4, 4)
                float* __restrict__ out,                 // (N, V, 3)
                int N, int V) {
  using L = Layout<T>;
  constexpr int kCols = L::kCols;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kChunks];   // one per stage
  float* s_pd = reinterpret_cast<float*>(smem + L::pd);
  float* s_w = reinterpret_cast<float*>(smem + L::w);
  float* s_pf = reinterpret_cast<float*>(smem + L::pf);
  float* s_A = reinterpret_cast<float*>(smem + L::A);
  float* s_vp = reinterpret_cast<float*>(smem + L::vp);
  float* s_out = reinterpret_cast<float*>(smem + L::out);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockIdx.x;
  const int v0 = tile * T;
  const int nv = min(T, V - v0);   // real vertices of this tile

  // Stage a group's pose features, transforms and v_shaped into shared
  // memory with 4-byte asynchronous copies (pad samples and vertices get
  // zeros), threads first, first + stride, ...; cp.async.wait_all ends it.
  auto stage_group = [&](int n0, int first, int stride) {
    const int nb = min(kGroup, N - n0);
    for (int i = first; i < kGroup * kP; i += stride) {
      const int s = i / kP, p = i - s * kP;
      if (s < nb)
        async_copy4(s_pf + p * kGroup + s,
                    pose_feature + (size_t)(n0 + s) * kP + p);
      else
        s_pf[p * kGroup + s] = 0.f;
    }
    for (int i = first; i < kGroup * kK * 12; i += stride) {
      const int s = i / (kK * 12), r = i - s * (kK * 12);
      const int k = r / 12, e = r - k * 12;   // rows 0..2 of the 4x4
      if (s < nb)
        async_copy4(s_A + i, rel + ((size_t)(n0 + s) * kK + k) * 16 + e);
      else
        s_A[i] = 0.f;
    }
    for (int i = first; i < kGroup * kCols; i += stride) {
      const int s = i / kCols, r = i - s * kCols;
      const int t = r / 3, c = r - t * 3;   // global (n, v, 3) order
      if (s < nb && t < nv)
        async_copy4(s_vp + (s * 3 + c) * T + t,
                    v_shaped + ((size_t)(n0 + s) * V + v0) * 3 + r);
      else
        s_vp[(s * 3 + c) * T + t] = 0.f;
    }
  };

  // Thread 0 starts the tile: it sets up the stage barriers and issues the
  // first kInFlight stages, while the other warps request the weights and
  // the first group's small inputs with cp.async, so that these land before
  // the tile and not behind it.  Thread 0 issues each later stage as an
  // earlier one lands, so stages land in order and the blend of one
  // overlaps the flight of the next.
  auto issue_stage = [&](int c) {
    constexpr uint32_t kStageBytes = 4u * kChunkRows * kCols;
    mbar_arrive_expect_tx(&bars[c], kStageBytes);
    bulk_load(s_pd + c * kChunkRows * kCols,
              posedirs + ((size_t)tile * kP + c * kChunkRows) * kCols,
              kStageBytes, &bars[c]);
  };
  if (tid == 0) {
    for (int c = 0; c < kChunks; ++c) mbar_init(&bars[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kInFlight; ++c) issue_stage(c);
  }
  {
    const int first = nwarps == 1 ? tid : tid - 32;
    const int stride = nwarps == 1 ? 32 : blockDim.x - 32;
    if (first >= 0) {
      stage_group(0, first, stride);
      const float4* w = reinterpret_cast<const float4*>(
          weights + (size_t)tile * kK * T);
      for (int i = first; i < kK * T / 4; i += stride)
        async_copy16(s_w + 4 * i, w + i);
    }
  }

  const int cg = lane & 7;          // blend: float4 column of the warp's 32
  const int rg = lane >> 3;         // blend: row group

  for (int n0 = 0; n0 < N; n0 += kGroup) {
    const int nb = min(kGroup, N - n0);
    if (n0 > 0) {
      __syncthreads();   // the last group's buffers are free
      stage_group(n0, tid, blockDim.x);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // staged inputs and (first pass) barriers visible

    // Skinning items: a lane owns one (sample, vertex), a warp 32 vertices
    // of one sample.  Its blended transform M = sum_k w_k A_k[:3, :] needs
    // only the weights and transforms, so when every item has a warp of its
    // own (item = nwarps - 1 - warp, away from the blend's first warps) M is
    // summed while the tile is in flight, and only M v_posed is left for
    // after the blend.
    const int items = nb * (T / 32);
    auto blended_transform = [&](int item, float (&M)[12]) {
      const int s = item / (T / 32);
      const int t = (item - s * (T / 32)) * 32 + lane;
      const float4* A = reinterpret_cast<const float4*>(s_A + s * kK * 12);
#pragma unroll
      for (int e = 0; e < 12; ++e) M[e] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        const float w = s_w[k * T + t];
        const float4 a[3] = {A[3 * k], A[3 * k + 1], A[3 * k + 2]};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          M[4 * i] = fmaf(w, a[i].x, M[4 * i]);
          M[4 * i + 1] = fmaf(w, a[i].y, M[4 * i + 1]);
          M[4 * i + 2] = fmaf(w, a[i].z, M[4 * i + 2]);
          M[4 * i + 3] = fmaf(w, a[i].w, M[4 * i + 3]);
        }
      }
    };
    auto apply_transform = [&](int item, const float (&M)[12]) {
      const int s = item / (T / 32);
      const int t = (item - s * (T / 32)) * 32 + lane;
      const float* vp = s_vp + s * kCols;
      const float x = vp[t], y = vp[T + t], z = vp[2 * T + t];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        s_out[s * kCols + t * 3 + i] =
            M[4 * i] * x + M[4 * i + 1] * y + M[4 * i + 2] * z + M[4 * i + 3];
    };
    const bool early = items <= nwarps;
    const int my_item = nwarps - 1 - warp;
    float M[12];
    if (early && my_item < items) blended_transform(my_item, M);

    // 1. pose blend, v_posed = v_shaped + pose_feature . posedirs: a warp
    // owns 32 columns and SW samples (4, or 1 when that keeps more warps
    // busy); each lane takes every 4th row of a stage, loading all of its
    // rows before the FMAs
    auto blend = [&](auto samples_per_warp) {
      constexpr int SW = decltype(samples_per_warp)::value;
      const int groups = (nb + SW - 1) / SW;
      for (int item = warp; item < (kCols / 32) * groups; item += nwarps) {
        const int u = item % (kCols / 32), h = item / (kCols / 32);
        const int col = u * 32 + cg * 4;
        float acc[SW][4];
#pragma unroll
        for (int s = 0; s < SW; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][j] = 0.f;
        for (int c = 0; c < kChunks; ++c) {
          mbar_wait(&bars[c], 0);
          if (n0 == 0 && item == 0 && lane == 0 && c + kInFlight < kChunks)
            issue_stage(c + kInFlight);
          float4 d[kRowsPerLane];
          float f[kRowsPerLane][SW];
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r) {
            const int row = r * kRowGroups + rg;   // row within the stage
            const int p = c * kChunkRows + row;
            const bool in = row < kChunkRows;
            d[r] = in ? *reinterpret_cast<const float4*>(s_pd + p * kCols + col)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
            if (SW == 4) {
              const float4 q =
                  in ? *reinterpret_cast<const float4*>(s_pf + p * kGroup + h * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
              const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
              for (int s = 0; s < SW; ++s) f[r][s] = qv[s];
            } else {
              f[r][0] = in ? s_pf[p * kGroup + h] : 0.f;
            }
          }
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r) {
            const float dv[4] = {d[r].x, d[r].y, d[r].z, d[r].w};
#pragma unroll
            for (int s = 0; s < SW; ++s)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[s][j] = fmaf(f[r][s], dv[j], acc[s][j]);
          }
        }
        // the 4 row groups meet; every lane ends with the same sums
#pragma unroll
        for (int s = 0; s < SW; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[s][j] += __shfl_xor_sync(0xffffffffu, acc[s][j], 8);
            acc[s][j] += __shfl_xor_sync(0xffffffffu, acc[s][j], 16);
          }
#pragma unroll
        for (int s = 0; s < SW; ++s) {
          const int n = h * SW + s;
          if (s == rg && n < nb) {   // row group s writes sample s
            float4* dst = reinterpret_cast<float4*>(s_vp + n * kCols + col);
            const float4 v = *dst;
            *dst = make_float4(v.x + acc[s][0], v.y + acc[s][1],
                               v.z + acc[s][2], v.w + acc[s][3]);
          }
        }
      }
    };
    if ((kCols / 32) * nb <= nwarps)
      blend(std::integral_constant<int, 1>{});
    else
      blend(std::integral_constant<int, 4>{});
    __syncthreads();

    // 2. skinning: out = M v_posed
    if (early) {
      if (my_item < items) apply_transform(my_item, M);
    } else {
      for (int item = warp; item < items; item += nwarps) {
        blended_transform(item, M);
        apply_transform(item, M);
      }
    }
    __syncthreads();

    // 3. store (nb, nv, 3): a sample's tile is contiguous in the output
    for (int i = tid; i < nb * (kCols / 4); i += blockDim.x) {
      const int s = i / (kCols / 4), q = i - s * (kCols / 4);
      float* g = out + ((size_t)(n0 + s) * V + v0) * 3;
      const float4 v = reinterpret_cast<const float4*>(s_out + s * kCols)[q];
      if (nv == T && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        reinterpret_cast<float4*>(g)[q] = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q * 4 + j < nv * 3) g[q * 4 + j] = e[j];
      }
    }
  }
}

// Allows the tile's shared memory (above the 48 KB default); once per
// instance and device.
template <int T>
cudaError_t configure() {
  static uint64_t configured = 0;   // bit d: done on device d
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (configured & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      lbs_skin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<T>::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lbs_skin_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured |= bit;
  return err;
}

template <int T>
cudaError_t launch(const float* pf, const float* pd, const float* vs,
                   const float* w, const float* rel, float* out, int n, int v,
                   int warps, cudaStream_t stream) {
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  lbs_skin_kernel<T><<<(v + T - 1) / T, 32 * warps, Layout<T>::bytes,
                       stream>>>(pf, pd, vs, w, rel, out, n, v);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  All tensors are contiguous float32 on `device`;
// posedirs is (ceil(v/tile), p, 3, tile) and weights (ceil(v/tile), k, tile),
// both 16-byte aligned.  `tile` is 32 or 64, `warps` 1..8.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int lbs_skin_forward(const void* pose_feature, const void* posedirs,
                                const void* v_shaped, const void* weights,
                                const void* rel, void* out, int n, int v,
                                int p, int k, int tile, int warps, int device,
                                void* stream) {
  if (n <= 0 || v <= 0 || p != kP || k != kK || warps < 1 ||
      warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(posedirs) |
       reinterpret_cast<uintptr_t>(weights)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* pf = static_cast<const float*>(pose_feature);
  const auto* pd = static_cast<const float*>(posedirs);
  const auto* vs = static_cast<const float*>(v_shaped);
  const auto* w = static_cast<const float*>(weights);
  const auto* a = static_cast<const float*>(rel);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 32: return (int)launch<32>(pf, pd, vs, w, a, o, n, v, warps, s);
    case 64: return (int)launch<64>(pf, pd, vs, w, a, o, n, v, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a tile-`tile` CTA and how many such CTAs of
// `warps` warps an SM holds (for the build report); -1 on error.
extern "C" int lbs_skin_smem_bytes(int tile) {
  switch (tile) {
    case 32: return (int)Layout<32>::bytes;
    case 64: return (int)Layout<64>::bytes;
    default: return -1;
  }
}

extern "C" int lbs_skin_blocks_per_sm(int tile, int warps, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (tile) {
    case 32:
      if ((err = configure<32>()) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, lbs_skin_kernel<32>, 32 * warps, Layout<32>::bytes);
      break;
    case 64:
      if ((err = configure<64>()) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, lbs_skin_kernel<64>, 32 * warps, Layout<64>::bytes);
      break;
  }
  return err == cudaSuccess ? blocks : -1;
}
