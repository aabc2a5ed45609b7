// Neighbourhood gather (QueryAndGroup), one warp per output row.
//
// Replaces: pointrcnn_tpu/ops/pallas_gather.py::_make_fwd_kernel (entry
// group_points_pallas, table from _pack_table).  Same contract: for row
// (b, s, k) with j = idx[b, s, k] the output is
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
// Compiled with --fmad=false like the other geometry kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
