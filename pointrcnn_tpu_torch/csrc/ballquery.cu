// Stride-class ball-query candidate selection, full scan and banded, one
// thread block per centroid.
//
// Replaces: pointrcnn_tpu/ops/pallas_ballquery.py::_make_kernel (entry
// _ball_query_pallas: ball_query_pallas, ball_query_multi_grouped_pallas) and
// ::_make_banded_kernel (entry _ball_query_pallas_banded:
// ball_query_multi_grouped_banded).  Same contract:
//
// - stride class j (one per thread, W of them) scans candidates j, j+W,
//   j+2W, ... of its range in order and keeps the nearest by direct-difference
//   squared distance (dx*dx + dy*dy) + dz*dz, replacing only on a strictly
//   smaller one (3e38 to start), so the lower index wins a tie;
// - the W class minima fold pairwise to 128 lanes, a tie keeping the lower
//   class;
// - kmax ascending extractions over the 128 lanes, each taking the smallest
//   value and the lowest lane among equals, then marking that lane 3e38; once
//   the real candidates run out the lowest lane (0) repeats;
// - outputs dist2, the candidate index, and optionally xyz[idx] - centroid
//   (bit-equal to the TPU kernel's carried coordinates minus the centroid).
//
// The full scan's range is the whole row (N points).  The banded kernel's
// table is z-sorted and its centroids band-ordered (S / n_bands per band):
// the range of a centroid in band b is band b-1, band b, band b+1 (Ns points
// each, in that order); a band past either edge is skipped, which is what the
// TPU kernel's 3e38 penalty on a clamped band amounts to.
//
// What bounds it on the H100: the scan's FP32 operations, about 9 per
// (centroid, candidate) pair: at the RPN SA1 fallback (4 x 4096 centroids x
// 16384 points) 2.4 GFLOP; the inputs and outputs are a few MB.
//
// What the design does about it: little yet (a simple kernel).  A block
// holds one centroid and W threads, so every block streams its candidate
// range from L2 (the whole row for the full scan: 192 KB at N=16384) and the
// scan's loads, not its arithmetic, set the pace.  Several centroids per
// block reusing each loaded point is the next step.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kMaxW = 512;
constexpr int kXW = 128;

// running minimum of class threadIdx.x over candidates
// start + p*W + threadIdx.x, p = 0 .. passes-1, of one batch row ``tab``
__device__ __forceinline__ void scan(const float* __restrict__ tab, int start, int passes,
                                     float cx, float cy, float cz, float& v, int& g) {
  const int W = blockDim.x;
  for (int p = 0; p < passes; ++p) {
    const int q = start + p * W + threadIdx.x;
    const float dx = cx - tab[3 * q];
    const float dy = cy - tab[3 * q + 1];
    const float dz = cz - tab[3 * q + 2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < v) {
      v = d2;
      g = q;
    }
  }
}

// fold the block's W class minima to kXW lanes, then extract kmax ascending
// with warp 0; writes row ``o`` of the outputs
__device__ void fold_extract(float v, int g, const float* __restrict__ tab, float cx, float cy,
                             float cz, int kmax, size_t o, float* __restrict__ dist2,
                             int* __restrict__ idx, float* __restrict__ rel) {
  __shared__ float sv[kMaxW];
  __shared__ int sg[kMaxW];
  const int t = threadIdx.x;
  sv[t] = v;
  sg[t] = g;
  __syncthreads();
  for (int w = blockDim.x / 2; w >= kXW; w /= 2) {
    if (t < w) {
      const float a = sv[t], b = sv[t + w];
      if (!(a <= b)) {
        sv[t] = b;
        sg[t] = sg[t + w];
      }
    }
    __syncthreads();
  }
  if (t >= 32) return;
  // lane t holds folded lanes t, t+32, t+64, t+96
  float lv[kXW / 32];
#pragma unroll
  for (int i = 0; i < kXW / 32; ++i) lv[i] = sv[t + 32 * i];
  for (int k = 0; k < kmax; ++k) {
    float bv = lv[0];
    int bi = t;
#pragma unroll
    for (int i = 1; i < kXW / 32; ++i) {
      if (lv[i] < bv) {
        bv = lv[i];
        bi = t + 32 * i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int i = 0; i < kXW / 32; ++i) {
      if (bi == t + 32 * i) lv[i] = kBig;
    }
    if (t == 0) {
      const int q = sg[bi];
      const size_t ok = o * kmax + k;
      dist2[ok] = bv;
      idx[ok] = q;
      if (rel != nullptr) {
        rel[3 * ok] = tab[3 * q] - cx;
        rel[3 * ok + 1] = tab[3 * q + 1] - cy;
        rel[3 * ok + 2] = tab[3 * q + 2] - cz;
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxW) ball_query_kernel(
    const float* __restrict__ xyz, const float* __restrict__ cent, int n, int s, int kmax,
    float* __restrict__ dist2, int* __restrict__ idx, float* __restrict__ rel) {
  const int b = blockIdx.y;
  const size_t o = (size_t)b * s + blockIdx.x;
  const float* tab = xyz + (size_t)b * n * 3;
  const float cx = cent[3 * o], cy = cent[3 * o + 1], cz = cent[3 * o + 2];
  float v = kBig;
  int g = 0;
  scan(tab, 0, n / blockDim.x, cx, cy, cz, v, g);
  fold_extract(v, g, tab, cx, cy, cz, kmax, o, dist2, idx, rel);
}

__global__ void __launch_bounds__(kMaxW) ball_query_banded_kernel(
    const float* __restrict__ xyz, const float* __restrict__ cent, int n, int s, int n_bands,
    int kmax, float* __restrict__ dist2, int* __restrict__ idx, float* __restrict__ rel) {
  const int b = blockIdx.y;
  const size_t o = (size_t)b * s + blockIdx.x;
  const float* tab = xyz + (size_t)b * n * 3;
  const float cx = cent[3 * o], cy = cent[3 * o + 1], cz = cent[3 * o + 2];
  const int ns = n / n_bands;
  const int band = blockIdx.x / (s / n_bands);
  const int passes = ns / blockDim.x;
  float v = kBig;
  int g = 0;
  for (int nb = band - 1; nb <= band + 1; ++nb) {
    if (nb >= 0 && nb < n_bands) scan(tab, nb * ns, passes, cx, cy, cz, v, g);
  }
  fold_extract(v, g, tab, cx, cy, cz, kmax, o, dist2, idx, rel);
}

}  // namespace

// xyz (B, N, 3), cent (B, S, 3) f32 -> dist2 (B, S, kmax) f32, idx (B, S,
// kmax) int32, rel (B, S, kmax, 3) f32 or null; W classes (128, 256 or 512)
// divide N
extern "C" int ball_query_launch(const float* xyz, const float* cent, int batch, int n, int s,
                                 int w, int kmax, float* dist2, int* idx, float* rel,
                                 void* stream) {
  ball_query_kernel<<<dim3(s, batch), w, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, cent, n, s, kmax, dist2, idx, rel);
  return (int)cudaGetLastError();
}

// the same over a z-sorted table of n_bands equal bands; W divides N / n_bands
extern "C" int ball_query_banded_launch(const float* xyz, const float* cent, int batch, int n,
                                        int s, int n_bands, int w, int kmax, float* dist2,
                                        int* idx, float* rel, void* stream) {
  ball_query_banded_kernel<<<dim3(s, batch), w, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, cent, n, s, n_bands, kmax, dist2, idx, rel);
  return (int)cudaGetLastError();
}
