// Three nearest neighbours, one thread per unknown point.
//
// Replaces: pointrcnn_tpu/ops/pallas_knn.py::_knn_kernel (entry
// three_nn_pallas).  Same contract: for each unknown point the 3 nearest
// known points by direct-difference squared distance
// (dx*dx + dy*dy) + dz*dz, the lowest index on ties, returned as
// sqrt(d2) and int32 indices.
//
// What bounds it on the H100: compute.  FP1 (16384 unknowns x 4096 knowns
// per scene, 4 scenes) is 268M candidate pairs of ~9 FP32 operations each;
// the only device-memory traffic is the coordinates and the (n, 3) outputs.
//
// What the design does about it: the known points stream through shared
// memory in tiles that every thread of the block reuses, so the inner loop
// reads shared memory only, and each thread keeps its running top 3 in
// registers.  Scanning in index order with strict < reproduces the
// lowest-index tie-break of the TPU kernel's three min-extractions.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void three_nn_kernel(const float* __restrict__ unknown,
                                const float* __restrict__ known, int n, int m,
                                float* __restrict__ dist,
                                int* __restrict__ idx) {
  const int b = blockIdx.y;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const float* kb = known + (size_t)b * m * 3;
  __shared__ float sk[kTile * 3];

  float ux = 0.f, uy = 0.f, uz = 0.f;
  if (u < n) {
    const float* up = unknown + ((size_t)b * n + u) * 3;
    ux = up[0];
    uy = up[1];
    uz = up[2];
  }
  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt * 3; t += blockDim.x) {
      sk[t] = kb[(size_t)base * 3 + t];
    }
    __syncthreads();
    if (u < n) {
      for (int k = 0; k < cnt; ++k) {
        const float dx = ux - sk[3 * k];
        const float dy = uy - sk[3 * k + 1];
        const float dz = uz - sk[3 * k + 2];
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < d2) {
          const int j = base + k;
          if (d < d1) {
            d2 = d1;
            i2 = i1;
            if (d < d0) {
              d1 = d0;
              i1 = i0;
              d0 = d;
              i0 = j;
            } else {
              d1 = d;
              i1 = j;
            }
          } else {
            d2 = d;
            i2 = j;
          }
        }
      }
    }
  }
  if (u < n) {
    const size_t o = ((size_t)b * n + u) * 3;
    dist[o] = sqrtf(d0);
    dist[o + 1] = sqrtf(d1);
    dist[o + 2] = sqrtf(d2);
    idx[o] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
  }
}

}  // namespace

extern "C" int three_nn_launch(const float* unknown, const float* known,
                               int batch, int n, int m, float* dist, int* idx,
                               void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, batch);
  three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      unknown, known, n, m, dist, idx);
  return (int)cudaGetLastError();
}
