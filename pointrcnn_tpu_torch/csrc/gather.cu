// Neighbourhood gather (QueryAndGroup): the forward, one warp per output
// row, and its backward, a deterministic scatter-add.
//
// Forward.  Replaces: pointrcnn_tpu/ops/pallas_gather.py::_make_fwd_kernel
// (entry group_points_pallas, table from _pack_table).  Same contract: for
// row (b, s, k) with j = idx[b, s, k] the output is
//   [ bf16((hi(x_j) + lo(x_j)) - c_s),  features_bf16[j] ]
// where hi is x's f32 bit pattern truncated to its top 16 bits and
// lo = bf16(x - hi): the TPU kernel gathers that hi/lo pair through a bf16
// one-hot matmul, and this kernel rebuilds it bit for bit.
//
// What bounds it on the H100: device-memory bytes.  At RPN SA2 (4 x 1024
// centroids x 32 neighbours x (3 + 96) bf16) the output is 26 MB and the
// reads are random rows of a 0.8 MB feature table that stays in L2.
//
// What the design does about it: a direct index gather replaces the TPU's
// one-hot matmul, so no FLOPs are spent; a warp copies one row with
// neighbouring lanes on neighbouring channels.
//
// Backward.  Replaces: pointrcnn_tpu/ops/pallas_gather.py::_make_bwd_kernel
// (_bwd_pallas_call, custom VJP _group_bwd).  For a bf16 cotangent ct
// (B, S, K, 3 + C):
//   dtable[b, n, :] = sum over (s, k) with idx[b, s, k] == n of f32(ct[b, s, k, :])
//   dcent[b, s, :]  = -sum over k of f32(ct[b, s, k, 0:3])
// The TPU accumulates dtable as a one-hot^T @ ct matmul per centroid chunk.
//
// What bounds it: device-memory bytes (read ct once, write dtable once);
// at RPN SA2 in training (16 x 1024 x 32 rows of 99 bf16) ct is 104 MB.
//
// What the design does about it: no atomics, so the sums are deterministic
// and in ascending (s, k) order per table row, the order of a sequential
// index_add_: the compacting scatter of scatter.cuh (shared with the fused
// MLP backward).  dcent is a second small kernel, one thread per (b, s,
// coordinate), k ascending.
//
// Compiled with --fmad=false like the other geometry kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter.cuh"

namespace {

__global__ void group_gather_kernel(const float* __restrict__ xyz,
                                    const __nv_bfloat16* __restrict__ feats,
                                    const float* __restrict__ cent,
                                    const int* __restrict__ idx, int n, int s,
                                    int k, int c, long long rows,
                                    __nv_bfloat16* __restrict__ out) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bs = row / k;  // b * s + s_local
  const long long b = bs / s;
  const long long src = b * n + idx[row];
  __nv_bfloat16* o = out + row * (3 + c);
  if (lane < 3) {
    const float x = xyz[src * 3 + lane];
    const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
    const float lo = __bfloat162float(__float2bfloat16_rn(x - hi));
    o[lane] = __float2bfloat16_rn((hi + lo) - cent[bs * 3 + lane]);
  }
  const __nv_bfloat16* f = feats + src * c;
  for (int ch = lane; ch < c; ch += 32) o[3 + ch] = f[ch];
}

// dcent[b, s, j] = -sum_k ct[b, s, k, j], j < 3, k ascending
__global__ void group_gather_dcent_kernel(const __nv_bfloat16* __restrict__ ct,
                                          long long bs_total, int k, int cout,
                                          float* __restrict__ dcent) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= bs_total * 3) return;
  const long long bs = t / 3;
  const int j = (int)(t - bs * 3);
  const __nv_bfloat16* c = ct + bs * k * cout + j;
  float sum = 0.0f;
  for (int kk = 0; kk < k; ++kk) sum += __bfloat162float(c[(long long)kk * cout]);
  dcent[t] = -sum;
}

}  // namespace

extern "C" int group_gather_launch(const float* xyz, const void* feats,
                                   const float* cent, const int* idx,
                                   int batch, int n, int s, int k, int c,
                                   void* out, void* stream) {
  const long long rows = (long long)batch * s * k;
  const int threads = 256;
  const long long blocks = (rows * 32 + threads - 1) / threads;
  group_gather_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xyz, static_cast<const __nv_bfloat16*>(feats), cent, idx, n, s, k, c,
      rows, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// ct: (batch, s, k, cout) bf16; idx: (batch, s, k) int32 in [0, n);
// dtable: (batch, n, cout) f32; dcent: (batch, s, 3) f32.  cout <= 1024.
extern "C" int group_gather_bwd_launch(const int* idx, const void* ct, int batch,
                                       int n, int s, int k, int cout,
                                       float* dtable, float* dcent,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* ctb = static_cast<const __nv_bfloat16*>(ct);
  cudaError_t err = scatter::scatter_rows(idx, ctb, batch, n, s * k, k, k, cout, dtable, st);
  if (err != cudaSuccess) return (int)err;
  const long long bs_total = (long long)batch * s;
  const int t2 = 256;
  const long long blocks = (bs_total * 3 + t2 - 1) / t2;
  if (blocks > 0)
    group_gather_dcent_kernel<<<(unsigned)blocks, t2, 0, st>>>(ctb, bs_total, k,
                                                               cout, dcent);
  return (int)cudaGetLastError();
}
