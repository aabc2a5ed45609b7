// Fused neighbourhood gather + shared MLP stack + max over K (forward).
//
// Replaces: pointrcnn_tpu/ops/pallas_mlp.py::_make_kernel (entry
// _fused_group, operands from _prepare_operands).  Same contract and the
// same rounding points:
//   layer 0, mode "hilo":  x = P[j] + bf16(hi(x_j) - c) @ w0x + lo(x_j) @ w0x
//                          (P = bf16(features @ w0_feat) rides in the table)
//   layer 0, mode "fold":  x = table[j] - cent,  table = bf16(P + xyz @ w0x),
//                          cent = c @ w0x in f32
//   every layer:           x = relu(x + b); deeper layers take bf16 operands
//                          and accumulate in f32
//   output:                max over the K neighbours of the last layer's f32
//                          activations.
//
// What bounds it on the H100: tensor-core FLOPs.  The RCNN SA stacks run
// 400 rois x 128 centroids x 64 neighbours = 3.3M rows through two 128-wide
// layers (~110 GFLOP per batch of 4 scenes); the inputs (a bf16 table of a
// few MB per stage and the indices) and the (B, S, Cout) output are small.
// The TPU version spent as many FLOPs again on its one-hot gather matmul.
//
// What the design does about it: rows are gathered by index (no one-hot
// matmul); a block takes 64 neighbour rows (1, 2 or 4 centroids), keeps their
// activations in shared memory as bf16 between layers, and runs each layer
// as 16x16x16 bf16 WMMA tiles with f32 accumulation, eight warps over the
// output tiles, weights read from L2.  The max over K is taken from the last
// layer's accumulators, so no (rows, Cout) tensor reaches device memory.
// Speed (wgmma, TMA, larger tiles) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;

struct Layers {
  const __nv_bfloat16* w[kMaxLayers];  // w[j]: (width[j-1], width[j]), j >= 1
  const float* b[kMaxLayers];          // b[j]: (width[j])
  int width[kMaxLayers];               // padded to multiples of 16
  int n_layers;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(kThreads)
fused_group_mlp_kernel(int fold, const __nv_bfloat16* __restrict__ table,
                       const float* __restrict__ xyz,
                       const float* __restrict__ cent,
                       const __nv_bfloat16* __restrict__ w0x,
                       const int* __restrict__ idx, int n, int s, int kp,
                       int ca, Layers L, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);                  // kWarps*256
  __nv_bfloat16* act0 = reinterpret_cast<__nv_bfloat16*>(stage + kWarps * 256);
  __nv_bfloat16* act1 = act0 + kRows * ca;
  int* rid = reinterpret_cast<int*>(act1 + kRows * ca);           // kRows
  float* geo = reinterpret_cast<float*>(rid + kRows);             // kRows*6

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int cpb = kRows / kp;  // centroids per block
  const int s0 = blockIdx.x * cpb;
  const int f0p = L.width[0];

  if (tid < kRows) {
    const int sc = s0 + tid / kp;
    const int j = sc < s ? idx[((size_t)b * s + sc) * kp + tid % kp] : 0;
    rid[tid] = j;
    if (!fold) {
      // relative geometry exactly as the TPU kernel forms it:
      // bf16(hi - c) in lanes 0:3 and lo (already bf16) in lanes 3:6
      for (int c = 0; c < 3; ++c) {
        const float x = xyz[((size_t)b * n + j) * 3 + c];
        const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
        const float lo = bf(__float2bfloat16_rn(x - hi));
        const float cc = sc < s ? cent[((size_t)b * s + sc) * 3 + c] : 0.f;
        geo[tid * 6 + c] = bf(__float2bfloat16_rn(hi - cc));
        geo[tid * 6 + 3 + c] = lo;
      }
    }
  }
  __syncthreads();

  // layer 0: gathered table row, geometry term, bias, ReLU -> bf16
  for (int e = tid; e < kRows * f0p; e += kThreads) {
    const int r = e / f0p;
    const int f = e - r * f0p;
    const float t = bf(table[((size_t)b * n + rid[r]) * f0p + f]);
    float x;
    if (fold) {
      const int sc = s0 + r / kp;
      x = t - (sc < s ? cent[((size_t)b * s + sc) * f0p + f] : 0.f);
    } else {
      const float* g = geo + r * 6;
      const float wx = bf(w0x[f]), wy = bf(w0x[f0p + f]), wz = bf(w0x[2 * f0p + f]);
      const float acc =
          g[0] * wx + g[1] * wy + g[2] * wz + g[3] * wx + g[4] * wy + g[5] * wz;
      x = t + acc;
    }
    act0[r * ca + f] = __float2bfloat16_rn(fmaxf(x + L.b[0][f], 0.f));
  }
  __syncthreads();

  float* st = stage + warp * 256;
  for (int j = 1; j < L.n_layers; ++j) {
    const int cin = L.width[j - 1];
    const int cout = L.width[j];
    const __nv_bfloat16* in = (j & 1) ? act0 : act1;
    __nv_bfloat16* nxt = (j & 1) ? act1 : act0;
    const __nv_bfloat16* W = L.w[j];
    const float* bias = L.b[j];
    const int ctiles = cout / 16;
    const bool last = j == L.n_layers - 1;

    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;

    if (!last) {
      for (int t = warp; t < (kRows / 16) * ctiles; t += kWarps) {
        const int rt = t % (kRows / 16);
        const int ct = t / (kRows / 16);
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < cin / 16; ++kk) {
          wmma::load_matrix_sync(fa, in + rt * 16 * ca + kk * 16, ca);
          wmma::load_matrix_sync(fb, W + (size_t)kk * 16 * cout + ct * 16, cout);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int q = 0; q < 8; ++q) {
          const int e = lane + 32 * q;
          const int rr = e >> 4, cc = e & 15;
          const float v = fmaxf(st[e] + bias[ct * 16 + cc], 0.f);
          nxt[(rt * 16 + rr) * ca + ct * 16 + cc] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    } else {
      // last layer: max over each centroid's kp rows, straight from the
      // f32 accumulators (ReLU outputs are >= 0, so 0 starts the max)
      for (int t = warp; t < cpb * ctiles; t += kWarps) {
        const int cl = t % cpb;
        const int ct = t / cpb;
        float m = 0.f;
        for (int rt = cl * kp / 16; rt < (cl + 1) * kp / 16; ++rt) {
          wmma::fill_fragment(acc, 0.f);
          for (int kk = 0; kk < cin / 16; ++kk) {
            wmma::load_matrix_sync(fa, in + rt * 16 * ca + kk * 16, ca);
            wmma::load_matrix_sync(fb, W + (size_t)kk * 16 * cout + ct * 16, cout);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
          __syncwarp();
          if (lane < 16) {
            const float bb = bias[ct * 16 + lane];
            for (int rr = 0; rr < 16; ++rr) {
              m = fmaxf(m, fmaxf(st[rr * 16 + lane] + bb, 0.f));
            }
          }
          __syncwarp();
        }
        const int sc = s0 + cl;
        if (lane < 16 && sc < s) {
          out[((size_t)b * s + sc) * cout + ct * 16 + lane] = m;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fused_group_mlp_launch(int fold, const void* table,
                                      const float* xyz, const float* cent,
                                      const void* w0x, const int* idx,
                                      int batch, int n, int s, int kp,
                                      int n_layers, const void* const* ws,
                                      const float* const* bs,
                                      const int* widths, float* out,
                                      void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || kp % 16 != 0 || kp > kRows ||
      kRows % kp != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Layers L;
  int ca = 0;
  for (int j = 0; j < kMaxLayers; ++j) {
    L.w[j] = j < n_layers ? static_cast<const __nv_bfloat16*>(ws[j]) : nullptr;
    L.b[j] = j < n_layers ? bs[j] : nullptr;
    L.width[j] = j < n_layers ? widths[j] : 0;
    if (j < n_layers && widths[j] % 16 != 0) return (int)cudaErrorInvalidValue;
    if (j < n_layers - 1 && widths[j] > ca) ca = widths[j];
  }
  L.n_layers = n_layers;
  const size_t smem = kWarps * 256 * sizeof(float) +
                      2 * (size_t)kRows * ca * sizeof(__nv_bfloat16) +
                      kRows * sizeof(int) + kRows * 6 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_group_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = kRows / kp;
  dim3 grid((s + cpb - 1) / cpb, batch);
  fused_group_mlp_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      fold, static_cast<const __nv_bfloat16*>(table), xyz, cent,
      static_cast<const __nv_bfloat16*>(w0x), idx, n, s, kp, ca, L, out);
  return (int)cudaGetLastError();
}
