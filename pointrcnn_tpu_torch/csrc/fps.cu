// Furthest point sampling, one thread block per row.
//
// Replaces: pointrcnn_tpu/ops/pallas_fps.py::_fps_kernel and
// _fps_kernel_striped (entry furthest_point_sample_pallas).  Same contract:
// the first pick is index 0; each step folds the squared distance to the
// last pick, (dx*dx + dy*dy) + dz*dz, into a running minimum (initialised to
// 1e10) and picks its argmax, the lowest index on ties.
//
// What bounds it on the H100: the chain of npoint-1 dependent steps, not
// bytes or FLOPs.  A step is one pass over the row's N points plus a
// block-wide argmax; at RPN SA1 (4 rows of 16384 points, 4095 steps) only 4
// of 132 SMs have work, so the kernel's time is the latency of 4095 steps.
//
// What the design does about it: a row's xyz (192 KB at N=16384) is copied
// once into shared memory and each thread keeps its points' running
// distances in registers (PPT points, strided by blockDim so the copy
// coalesces and the stride-3 shared reads are free of bank conflicts): 16
// per thread at 1024 threads.  Coordinates and cache together (256 KB)
// would not fit the 227 KB of shared memory, and coordinates in registers
// too would exceed 64 registers a thread.  A step then reads only shared
// memory and pays two __syncthreads for the argmax: warp shuffles, then one
// warp over the 32 warp winners.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs.

#include <cuda_runtime.h>
#include <climits>

namespace {

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int PPT>
__global__ void __launch_bounds__(1024) fps_kernel(const float* __restrict__ xyz, int n, int npoint,
                           int* __restrict__ out) {
  const int row = blockIdx.x;
  const float* p = xyz + (size_t)row * n * 3;
  int* o = out + (size_t)row * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_last;
  extern __shared__ float sp[];  // the row's xyz, n x 3

  for (int t = tid; t < 3 * n; t += blockDim.x) sp[t] = p[t];
  float dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    dist[j] = tid + j * blockDim.x < n ? 1e10f : -1.f;
  }
  __syncthreads();
  if (tid == 0) o[0] = 0;

  int last = 0;
  for (int step = 1; step < npoint; ++step) {
    const float lx = sp[3 * last], ly = sp[3 * last + 1], lz = sp[3 * last + 2];
    float best = -2.f;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * blockDim.x;
      if (i < n) {
        const float dx = sp[3 * i] - lx, dy = sp[3 * i + 1] - ly, dz = sp[3 * i + 2] - lz;
        const float d = dx * dx + dy * dy + dz * dz;
        dist[j] = fminf(dist[j], d);
        // indices rise with j: strict > keeps the lowest index on ties
        if (dist[j] > best) {
          best = dist[j];
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      better(best, bi, ov, oi);
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? s_val[lane] : -3.f;
      bi = lane < nwarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        better(best, bi, ov, oi);
      }
      if (lane == 0) {
        s_last = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int rows, int n, int npoint, int* out,
                   int threads, cudaStream_t s) {
  const int smem = n * 3 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<rows, threads, smem, s>>>(xyz, n, npoint, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fps_launch(const float* xyz, int rows, int n, int npoint,
                          int* out, void* stream) {
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const int need = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need <= 1) return (int)launch<1>(xyz, rows, n, npoint, out, threads, s);
  if (need <= 2) return (int)launch<2>(xyz, rows, n, npoint, out, threads, s);
  if (need <= 4) return (int)launch<4>(xyz, rows, n, npoint, out, threads, s);
  if (need <= 8) return (int)launch<8>(xyz, rows, n, npoint, out, threads, s);
  if (need <= 16) return (int)launch<16>(xyz, rows, n, npoint, out, threads, s);
  return (int)cudaErrorInvalidValue;
}
