// Three nearest neighbours: a split, register-blocked scan of the known
// points.
//
// Replaces: pointrcnn_tpu/ops/pallas_knn.py::_knn_kernel (entry
// three_nn_pallas).  Same contract: for each unknown point the 3 nearest
// known points by direct-difference squared distance
// (dx*dx + dy*dy) + dz*dz, the lowest index on ties, returned as
// sqrt(d2) and int32 indices.
//
// What bounds it on the H100: operations.  FP1 (16384 unknowns x 4096
// knowns per scene, 4 scenes) is 268M candidate pairs of 9 f32 operations
// each (3 sub, 3 mul, 2 add, a compare; --fmad=false fuses none of them);
// the only device-memory traffic is the coordinates and the (n, 3) outputs.
//
// What the design does about it:
// - The known points stream through shared memory in tiles of float4
//   (x, y, z, pad), so one 16-byte broadcast load feeds a candidate.
// - Register blocking: a thread keeps U unknowns (1 or 2) and their
//   running top 3, so each shared-memory load feeds U distances.  On the
//   H100 the loads were not what held the scan back: more unknowns a warp
//   make some lane's insertion (a divergent branch) likelier at every
//   candidate, so U = 2 pays only at the largest launch.
// - Split scan: a group of G lanes (1..8, chosen by shape in
//   ops/cuda_knn.py, so that small launches still fill the card) shares
//   the same U unknowns; lane r scans knowns r, r + G, ... in index order
//   with strict <, which keeps the lowest index among its equal distances,
//   and the G lanes of a warp read G neighbouring float4s at a time (one
//   shared-memory wavefront).  The group then merges its sorted top-3 lists
//   with butterfly shuffles, ordering on (d2, index) lexicographically: the
//   lanes' index sets are disjoint, so the merge keeps the lowest index
//   among equal distances whatever lane holds it.
// - The insertion is branch-light: the common path is one compare against
//   the third distance.
// - sqrtf (correctly rounded: no --use_fast_math) is taken once, on the
//   kept squared distances, after the scan.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

// candidates arrive in rising index order: strict < keeps the earlier one
__device__ __forceinline__ void insert(Top3& t, float d, int j) {
  if (d < t.d2) {
    if (d < t.d1) {
      t.d2 = t.d1;
      t.i2 = t.i1;
      if (d < t.d0) {
        t.d1 = t.d0;
        t.i1 = t.i0;
        t.d0 = d;
        t.i0 = j;
      } else {
        t.d1 = d;
        t.i1 = j;
      }
    } else {
      t.d2 = d;
      t.i2 = j;
    }
  }
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// the first 3 of two lists sorted on (d2, index) with disjoint indices
__device__ __forceinline__ Top3 merge(const Top3& a, const Top3& b) {
  Top3 r;
  const bool fa = before(a.d0, a.i0, b.d0, b.i0);
  r.d0 = fa ? a.d0 : b.d0;
  r.i0 = fa ? a.i0 : b.i0;
  // the heads after the first pick
  const float ha = fa ? a.d1 : a.d0, hb = fa ? b.d0 : b.d1;
  const int hia = fa ? a.i1 : a.i0, hib = fa ? b.i0 : b.i1;
  const bool sa = before(ha, hia, hb, hib);
  r.d1 = sa ? ha : hb;
  r.i1 = sa ? hia : hib;
  // the heads after the second pick: (a2, b0), (a1, b1), (a1, b1), (a0, b2)
  const float ta = fa ? (sa ? a.d2 : a.d1) : (sa ? a.d1 : a.d0);
  const int tia = fa ? (sa ? a.i2 : a.i1) : (sa ? a.i1 : a.i0);
  const float tb = fa ? (sa ? b.d0 : b.d1) : (sa ? b.d1 : b.d2);
  const int tib = fa ? (sa ? b.i0 : b.i1) : (sa ? b.i1 : b.i2);
  const bool ua = before(ta, tia, tb, tib);
  r.d2 = ua ? ta : tb;
  r.i2 = ua ? tia : tib;
  return r;
}

__device__ __forceinline__ Top3 shfl_xor(const Top3& t, int off) {
  Top3 o;
  o.d0 = __shfl_xor_sync(0xffffffffu, t.d0, off);
  o.d1 = __shfl_xor_sync(0xffffffffu, t.d1, off);
  o.d2 = __shfl_xor_sync(0xffffffffu, t.d2, off);
  o.i0 = __shfl_xor_sync(0xffffffffu, t.i0, off);
  o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
  o.i2 = __shfl_xor_sync(0xffffffffu, t.i2, off);
  return o;
}

// block: kThreads / G groups of G lanes; group g holds the block's unknowns
// g, g + groups, ..., U of them
template <int U, int G>
__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int n,
                    int m, float* __restrict__ dist, int* __restrict__ idx) {
  constexpr int kGroups = kThreads / G;
  const int b = blockIdx.y;
  const int grp = threadIdx.x / G, r = threadIdx.x % G;
  const int u0 = blockIdx.x * kGroups * U + grp;
  const float* kb = known + (size_t)b * m * 3;
  __shared__ float4 sk[kTile];

  float ux[U], uy[U], uz[U];
  Top3 t[U];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    const int u = u0 + q * kGroups;
    const float* up = unknown + ((size_t)b * n + min(u, n - 1)) * 3;
    ux[q] = up[0];
    uy[q] = up[1];
    uz[q] = up[2];
    t[q] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, INT_MAX, INT_MAX, INT_MAX};
  }
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* p = kb + (size_t)(base + k) * 3;
      sk[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = r; k < cnt; k += G) {
      const float4 c = sk[k];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const float dx = ux[q] - c.x, dy = uy[q] - c.y, dz = uz[q] - c.z;
        insert(t[q], dx * dx + dy * dy + dz * dz, base + k);
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < U; ++q) t[q] = merge(t[q], shfl_xor(t[q], off));
  }
  if (r == 0) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * kGroups;
      if (u < n) {
        const size_t o = ((size_t)b * n + u) * 3;
        dist[o] = sqrtf(t[q].d0);
        dist[o + 1] = sqrtf(t[q].d1);
        dist[o + 2] = sqrtf(t[q].d2);
        idx[o] = t[q].i0;
        idx[o + 1] = t[q].i1;
        idx[o + 2] = t[q].i2;
      }
    }
  }
}

template <int U, int G>
cudaError_t launch(const float* unknown, const float* known, int batch, int n, int m,
                   float* dist, int* idx, cudaStream_t s) {
  constexpr int per_block = kThreads / G * U;
  dim3 grid((n + per_block - 1) / per_block, batch);
  three_nn_kernel<U, G><<<grid, kThreads, 0, s>>>(unknown, known, n, m, dist, idx);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch_g(const float* unknown, const float* known, int batch, int n, int m,
                     float* dist, int* idx, int g, cudaStream_t s) {
  switch (g) {
    case 1: return launch<U, 1>(unknown, known, batch, n, m, dist, idx, s);
    case 2: return launch<U, 2>(unknown, known, batch, n, m, dist, idx, s);
    case 4: return launch<U, 4>(unknown, known, batch, n, m, dist, idx, s);
    case 8: return launch<U, 8>(unknown, known, batch, n, m, dist, idx, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// unknown (batch, n, 3), known (batch, m, 3) f32, m >= 3 -> dist, idx
// (batch, n, 3).  u unknowns a thread in {1, 2}, g lanes an unknown in
// {1, 2, 4, 8} (ops/cuda_knn.py::plan chooses them).
extern "C" int three_nn_launch(const float* unknown, const float* known, int batch, int n,
                               int m, float* dist, int* idx, int u, int g, void* stream) {
  if (batch < 1 || n < 1 || m < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u) {
    case 1: return (int)launch_g<1>(unknown, known, batch, n, m, dist, idx, g, s);
    case 2: return (int)launch_g<2>(unknown, known, batch, n, m, dist, idx, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
