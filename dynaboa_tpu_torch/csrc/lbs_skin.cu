// SMPL pose-blendshape + linear blend skinning for Hopper (sm_90a).
//
// Replaces the Pallas kernel dynaboa_tpu/kernels/lbs.py:_skin_kernel.  Per
// (sample n, vertex v) it computes
//
//   v_posed = v_shaped[n, v] + sum_p pose_feature[n, p] * posedirs[p, :, v]
//   out[n, v] = sum_k w[k, v] * (A[n, k, :3, :3] v_posed + A[n, k, :3, 3])
//
// What bounds it: at N = 1 the kernel reads posedirs once, 207 x 3 x 6890
// floats = 17.1 MB, plus 0.66 MB of skinning weights, and does about
// 8.6 MFLOP — about 0.5 FLOP per byte, far below the card's balance point,
// so it is bound by memory bandwidth and latency.  On an H100 SXM (data
// sheet: 3.35 TB/s HBM, 50 MB L2, at its 700 W limit) the HBM floor is about
// 5 us, a derived bound and not a measurement; the 17.1 MB also fit in the
// L2 across the decodes of one frame.
//
// What the design does about it:
//  * posedirs is stored (P, 3, V) at construction, so the 32 lanes of a
//    warp read 32 neighbouring vertices: each warp load is one 128-byte line.
//  * A block covers 32 vertices with 8 warps that split the 207-long
//    pose-feature sum, so ~55k threads keep enough loads in flight to cover
//    memory latency (one thread per vertex would leave most SMs idle).
//    Partial sums meet in shared memory; the 8 warps then split the 24
//    joints of the skinning sum the same way.
//  * Up to kSamples samples run in one block, so posedirs streams once for
//    all of them; pose features and the 24 3x4 transforms of those samples
//    sit in shared memory (broadcast reads).
//  * The output is written (N, V, 3) directly; the ragged tail of V is
//    masked, with no lane padding.
// wgmma, TMA and tuning are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 207;        // pose-blendshape features (23 * 9)
constexpr int kK = 24;         // joints
constexpr int kLanes = 32;     // vertices per block
constexpr int kWarps = 8;      // warps per block, splitting P and then K
constexpr int kPChunk = (kP + kWarps - 1) / kWarps;   // 26
constexpr int kKChunk = kK / kWarps;                  // 3

template <int kSamples>
__global__ void __launch_bounds__(kLanes * kWarps)
lbs_skin_kernel(const float* __restrict__ pose_feature,  // (N, P)
                const float* __restrict__ posedirs,      // (P, 3, V)
                const float* __restrict__ v_shaped,      // (N, V, 3)
                const float* __restrict__ weights,       // (K, V)
                const float* __restrict__ rel,           // (N, K, 4, 4)
                float* __restrict__ out,                 // (N, V, 3)
                int N, int V) {
  __shared__ float s_pf[kSamples][kP];
  __shared__ float s_A[kSamples][kK][12];
  __shared__ float s_part[kWarps][kSamples][3][kLanes];
  __shared__ float s_vp[kSamples][3][kLanes];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int n0 = blockIdx.y * kSamples;
  const int ns = min(kSamples, N - n0);

  for (int i = tid; i < kSamples * kP; i += kLanes * kWarps) {
    const int s = i / kP, p = i % kP;
    s_pf[s][p] = s < ns ? pose_feature[(size_t)(n0 + s) * kP + p] : 0.f;
  }
  for (int i = tid; i < kSamples * kK * 12; i += kLanes * kWarps) {
    const int s = i / (kK * 12), r = i % (kK * 12);
    const int k = r / 12, e = r % 12;   // rows 0..2 of the 4x4, row-major
    s_A[s][k][e] = s < ns ? rel[((size_t)(n0 + s) * kK + k) * 16 + e] : 0.f;
  }
  __syncthreads();

  const int v = blockIdx.x * kLanes + lane;
  const bool valid = v < V;
  const size_t stride_p = (size_t)3 * V;

  // 1. this warp's slice of the pose-blendshape sum
  float acc[kSamples][3];
#pragma unroll
  for (int s = 0; s < kSamples; ++s)
    acc[s][0] = acc[s][1] = acc[s][2] = 0.f;
  if (valid) {
    const int p_end = min(kP, (warp + 1) * kPChunk);
    const float* pd = posedirs + v;
#pragma unroll 2
    for (int p = warp * kPChunk; p < p_end; ++p) {
      const float* row = pd + p * stride_p;
      const float d0 = __ldg(row);
      const float d1 = __ldg(row + V);
      const float d2 = __ldg(row + 2 * (size_t)V);
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const float f = s_pf[s][p];
        acc[s][0] = fmaf(f, d0, acc[s][0]);
        acc[s][1] = fmaf(f, d1, acc[s][1]);
        acc[s][2] = fmaf(f, d2, acc[s][2]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSamples; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) s_part[warp][s][c][lane] = acc[s][c];
  __syncthreads();

  // 2. warp 0 adds the slices to the shaped template
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float t = (valid && s < ns)
                      ? v_shaped[((size_t)(n0 + s) * V + v) * 3 + c] : 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += s_part[w][s][c][lane];
        s_vp[s][c][lane] = t;
      }
    }
  }
  __syncthreads();

  // 3. this warp's joints of the skinning sum
  float o[kSamples][3];
#pragma unroll
  for (int s = 0; s < kSamples; ++s) o[s][0] = o[s][1] = o[s][2] = 0.f;
  if (valid) {
#pragma unroll
    for (int j = 0; j < kKChunk; ++j) {
      const int k = warp * kKChunk + j;
      const float w = __ldg(weights + (size_t)k * V + v);
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const float x = s_vp[s][0][lane], y = s_vp[s][1][lane],
                    z = s_vp[s][2][lane];
        const float* A = s_A[s][k];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float t = A[4 * i] * x + A[4 * i + 1] * y + A[4 * i + 2] * z +
                          A[4 * i + 3];
          o[s][i] = fmaf(w, t, o[s][i]);
        }
      }
    }
  }
  __syncthreads();   // every warp has read s_vp; s_part is free again
#pragma unroll
  for (int s = 0; s < kSamples; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) s_part[warp][s][c][lane] = o[s][c];
  __syncthreads();

  // 4. warp 0 sums the joint slices and writes (N, V, 3)
  if (warp == 0 && valid) {
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      if (s >= ns) break;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += s_part[w][s][c][lane];
        out[((size_t)(n0 + s) * V + v) * 3 + c] = t;
      }
    }
  }
}

template <int kSamples>
void launch(const float* pf, const float* pd, const float* vs, const float* w,
            const float* rel, float* out, int n, int v, cudaStream_t stream) {
  const dim3 block(kLanes, kWarps);
  const dim3 grid((v + kLanes - 1) / kLanes, (n + kSamples - 1) / kSamples);
  lbs_skin_kernel<kSamples><<<grid, block, 0, stream>>>(pf, pd, vs, w, rel,
                                                        out, n, v);
}

}  // namespace

// Plain C entry for ctypes.  All tensors are contiguous float32 on `device`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lbs_skin_forward(const void* pose_feature, const void* posedirs,
                                const void* v_shaped, const void* weights,
                                const void* rel, void* out, int n, int v,
                                int p, int k, int device, void* stream) {
  if (n <= 0 || v <= 0 || p != kP || k != kK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* pf = static_cast<const float*>(pose_feature);
  const auto* pd = static_cast<const float*>(posedirs);
  const auto* vs = static_cast<const float*>(v_shaped);
  const auto* w = static_cast<const float*>(weights);
  const auto* a = static_cast<const float*>(rel);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    launch<1>(pf, pd, vs, w, a, o, n, v, s);
  } else {
    launch<4>(pf, pd, vs, w, a, o, n, v, s);
  }
  return (int)cudaGetLastError();
}
