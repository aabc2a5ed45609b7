// Fused neighbourhood gather + shared MLP stack + max over K: the forward
// and its backward.
//
// Forward replaces: pointrcnn_tpu/ops/pallas_mlp.py::_make_kernel (entry
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
//
// Backward replaces: pointrcnn_tpu/ops/pallas_mlp.py::_make_bwd_kernel
// (entry _pallas_bwd).  It recomputes the forward with the SAME device
// functions as the forward kernel (load_rows, layer0, hidden_layer,
// last_tile), so every activation is bit-identical to the one the forward
// took its max from, then backpropagates in-block with the TPU kernel's
// rounding points:
//   tie split:  the cotangent of (centroid, channel) is split evenly among
//               the neighbours whose last-layer activation equals the stored
//               forward output; a (centroid, channel) with no equal
//               activation is counted in `nomatch` (it must stay 0)
//   ReLU:       dz_L = da * [a_L > 0];
//               dz_{i-1} = (bf16(dz_i) @ bf16(W_i)^T) * [a_{i-1} > 0]
//   weights:    dW_i = bf16(a_{i-1})^T @ bf16(dz_i); db_i = sum dz_i (f32)
//   layer 0:    dtable = scatter-add of bf16(dz_0) over idx (f32);
//               fold: dcent = -sum_K dz_0;
//               hilo: drel = bf16(dz_0) @ bf16(w0x)^T, dcent = -sum_K drel,
//               dw0x rows (hi - c, lo) = geo^T @ bf16(dz_0), and dxyz the
//               scatter-add of bf16(drel) (the table's hi lanes in JAX).
// Padded neighbours (k >= K, the forward repeats neighbour 0) and the
// centroids past S of a ragged last block carry no cotangent.
//
// What bounds the backward: tensor-core FLOPs again (the recompute plus four
// products per hidden layer: ~412 GFLOP at RCNN SA1, batch 4).  Design: one
// block per batch row walks that row's 64-row chunks in order.  It owns the
// row's slice of dtable (and dxyz), so the scatter needs no atomics: thread f
// adds lane f of the chunk's rows in ascending (s, k) order, in global memory
// (a batch row's f32 table, 256 KB at RCNN SA1, does not fit in shared
// memory).  dW and db go to a per-block partial in global memory (the WMMA
// accumulators are loaded from and stored back to it per chunk), summed over
// the blocks in block order by a second kernel.  Every sum has a fixed
// order, so the backward is deterministic.  The partials' traffic (a dW
// read and write per chunk, served from L2) and one block per batch row are
// what a faster version would remove.

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
constexpr size_t kMaxSmem = 232448;

struct Layers {
  const __nv_bfloat16* w[kMaxLayers];  // w[j]: (width[j-1], width[j]), j >= 1
  const float* b[kMaxLayers];          // b[j]: (width[j])
  int width[kMaxLayers];               // padded to multiples of 16
  int n_layers;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The block's rows: centroids s0 .. s0 + kRows/kp - 1 of batch row b, row r
// is neighbour r % kp of centroid s0 + r / kp.  rid[r] is its table row;
// in hilo mode geo[r] holds bf16(hi - c) in 0:3 and lo in 3:6.
__device__ __forceinline__ void load_rows(int fold, const float* __restrict__ xyz,
                                          const float* __restrict__ cent,
                                          const int* __restrict__ idx, int b, int n,
                                          int s, int s0, int kp, int* rid, float* geo) {
  const int tid = threadIdx.x;
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
}

// layer 0: gathered table row, geometry term, bias, ReLU -> bf16 act
__device__ __forceinline__ void layer0(int fold, const __nv_bfloat16* __restrict__ table,
                                       const float* __restrict__ cent,
                                       const __nv_bfloat16* __restrict__ w0x,
                                       const float* __restrict__ b0, int b, int n, int s,
                                       int s0, int kp, int f0p, const int* rid,
                                       const float* geo, __nv_bfloat16* act, int ca) {
  for (int e = threadIdx.x; e < kRows * f0p; e += kThreads) {
    const int r = e / f0p;
    const int f = e - r * f0p;
    const float t = bf(table[((size_t)b * n + rid[r]) * f0p + f]);
    float x;
    if (fold) {
      const int sc = s0 + r / kp;
      x = t - (sc < s ? cent[((size_t)b * s + sc) * f0p + f] : 0.f);
    } else {
      // products of bf16 values are exact in f32, so a contracted FMA
      // rounds as the separate multiply and add do
      const float* g = geo + r * 6;
      const float wx = bf(w0x[f]), wy = bf(w0x[f0p + f]), wz = bf(w0x[2 * f0p + f]);
      const float acc =
          g[0] * wx + g[1] * wy + g[2] * wz + g[3] * wx + g[4] * wy + g[5] * wz;
      x = t + acc;
    }
    act[r * ca + f] = __float2bfloat16_rn(fmaxf(x + b0[f], 0.f));
  }
}

// a hidden layer: in (kRows x cin) -> nxt (kRows x cout), bf16 ReLU outputs;
// st is this warp's 16x16 f32 staging tile
__device__ __forceinline__ void hidden_layer(const __nv_bfloat16* in, __nv_bfloat16* nxt,
                                             const __nv_bfloat16* __restrict__ W,
                                             const float* __restrict__ bias, int cin,
                                             int cout, int ca, float* st) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ctiles = cout / 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
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
}

// the last layer's f32 accumulator tile (rows rt*16.., channels ct*16..),
// before bias and ReLU -> st
__device__ __forceinline__ void last_tile(const __nv_bfloat16* in,
                                          const __nv_bfloat16* __restrict__ W, int cin,
                                          int cout, int ca, int rt, int ct, float* st) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < cin / 16; ++kk) {
    wmma::load_matrix_sync(fa, in + rt * 16 * ca + kk * 16, ca);
    wmma::load_matrix_sync(fb, W + (size_t)kk * 16 * cout + ct * 16, cout);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
  __syncwarp();
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

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int cpb = kRows / kp;  // centroids per block
  const int s0 = blockIdx.x * cpb;

  load_rows(fold, xyz, cent, idx, b, n, s, s0, kp, rid, geo);
  __syncthreads();
  layer0(fold, table, cent, w0x, L.b[0], b, n, s, s0, kp, L.width[0], rid, geo, act0, ca);
  __syncthreads();

  float* st = stage + warp * 256;
  for (int j = 1; j < L.n_layers; ++j) {
    const int cin = L.width[j - 1];
    const int cout = L.width[j];
    const __nv_bfloat16* in = (j & 1) ? act0 : act1;
    __nv_bfloat16* nxt = (j & 1) ? act1 : act0;
    if (j < L.n_layers - 1) {
      hidden_layer(in, nxt, L.w[j], L.b[j], cin, cout, ca, st);
    } else {
      // last layer: max over each centroid's kp rows, straight from the
      // f32 accumulators (ReLU outputs are >= 0, so 0 starts the max)
      const int ctiles = cout / 16;
      for (int t = warp; t < cpb * ctiles; t += kWarps) {
        const int cl = t % cpb;
        const int ct = t / cpb;
        float m = 0.f;
        for (int rt = cl * kp / 16; rt < (cl + 1) * kp / 16; ++rt) {
          last_tile(in, L.w[j], cin, cout, ca, rt, ct, st);
          if (lane < 16) {
            const float bb = L.b[j][ct * 16 + lane];
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

// Offsets (in floats) of the backward's parameter gradients in one partial
// slot: dW_1 .. dW_{L-1}, then db_0 .. db_{L-1}, then the six dw0x rows.
struct GradLayout {
  int dw[kMaxLayers];
  int db[kMaxLayers];
  int dw0x;
  int size;
};

__host__ __device__ inline GradLayout grad_layout(const int* width, int n_layers) {
  GradLayout g;
  int off = 0;
  for (int j = 0; j < kMaxLayers; ++j) g.dw[j] = g.db[j] = 0;
  for (int j = 1; j < n_layers; ++j) {
    g.dw[j] = off;
    off += width[j - 1] * width[j];
  }
  for (int j = 0; j < n_layers; ++j) {
    g.db[j] = off;
    off += width[j];
  }
  g.dw0x = off;
  off += 6 * width[0];
  g.size = off;
  return g;
}

__global__ void __launch_bounds__(kThreads)
fused_group_mlp_bwd_kernel(int fold, const __nv_bfloat16* __restrict__ table,
                           const float* __restrict__ xyz,
                           const float* __restrict__ cent,
                           const __nv_bfloat16* __restrict__ w0x,
                           const int* __restrict__ idx, int n, int s, int kp,
                           int k_real, int ca, int cmax, Layers L,
                           const float* __restrict__ fwd_out,
                           const float* __restrict__ ct_in,
                           float* __restrict__ dtable, float* __restrict__ dxyz,
                           float* __restrict__ dcent, float* __restrict__ part,
                           int* __restrict__ nomatch) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);                  // kWarps*256
  float* dzf = stage + kWarps * 256;                              // kRows*cmax
  __nv_bfloat16* dzb0 = reinterpret_cast<__nv_bfloat16*>(dzf + kRows * cmax);
  __nv_bfloat16* dzb1 = dzb0 + kRows * cmax;
  __nv_bfloat16* acts = dzb1 + kRows * cmax;                      // (L-1)*kRows*ca
  int* rid = reinterpret_cast<int*>(acts + (L.n_layers - 1) * kRows * ca);
  float* geo = reinterpret_cast<float*>(rid + kRows);             // kRows*6
  float* drel = geo + kRows * 6;                                  // kRows*3

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int cpb = kRows / kp;
  const int f0p = L.width[0];
  const int nl = L.n_layers;
  const int coutl = L.width[nl - 1];
  const GradLayout G = grad_layout(L.width, nl);
  float* pb = part + (size_t)b * G.size;
  float* st = stage + warp * 256;

  for (int s0 = 0; s0 < s; s0 += cpb) {
    // ---- recompute the forward, bit-identical to the forward kernel ----
    load_rows(fold, xyz, cent, idx, b, n, s, s0, kp, rid, geo);
    __syncthreads();
    layer0(fold, table, cent, w0x, L.b[0], b, n, s, s0, kp, f0p, rid, geo, acts, ca);
    __syncthreads();
    for (int j = 1; j < nl - 1; ++j) {
      hidden_layer(acts + (j - 1) * kRows * ca, acts + j * kRows * ca, L.w[j], L.b[j],
                   L.width[j - 1], L.width[j], ca, st);
      __syncthreads();
    }
    {
      // the last layer's activations, f32, into dzf
      const __nv_bfloat16* in = acts + (nl - 2) * kRows * ca;
      const int cin = L.width[nl - 2];
      for (int t = warp; t < (kRows / 16) * (coutl / 16); t += kWarps) {
        const int rt = t % (kRows / 16);
        const int ct = t / (kRows / 16);
        last_tile(in, L.w[nl - 1], cin, coutl, ca, rt, ct, st);
        for (int q = 0; q < 8; ++q) {
          const int e = lane + 32 * q;
          const int rr = e >> 4, cc = e & 15;
          dzf[(rt * 16 + rr) * cmax + ct * 16 + cc] =
              fmaxf(st[e] + L.b[nl - 1][ct * 16 + cc], 0.f);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- max over K: the cotangent split evenly among tied maxima ----
    for (int e = tid; e < cpb * coutl; e += kThreads) {
      const int cl = e / coutl;
      const int c = e - cl * coutl;
      const int sc = s0 + cl;
      float g = 0.f, o = 0.f;
      if (sc < s) {
        o = fwd_out[((size_t)b * s + sc) * coutl + c];
        int cnt = 0;
        for (int k = 0; k < k_real; ++k) cnt += dzf[(cl * kp + k) * cmax + c] == o;
        if (cnt == 0) atomicAdd(nomatch, 1);
        g = ct_in[((size_t)b * s + sc) * coutl + c] / (float)(cnt > 0 ? cnt : 1);
      }
      for (int k = 0; k < kp; ++k) {
        const int r = (cl * kp + k) * cmax + c;
        const float a = dzf[r];
        const float d = (sc < s && k < k_real && a == o && a > 0.f) ? g : 0.f;
        dzf[r] = d;
        dzb0[r] = __float2bfloat16_rn(d);
      }
    }
    __syncthreads();

    // ---- back through the hidden layers ----
    __nv_bfloat16* dzb = dzb0;
    __nv_bfloat16* dzn = dzb1;
    for (int i = nl - 1; i >= 1; --i) {
      const int cin = L.width[i - 1];
      const int cout = L.width[i];
      const __nv_bfloat16* a_prev = acts + (i - 1) * kRows * ca;
      // db_i: this chunk's rows in order, added to the block's partial
      for (int c = tid; c < cout; c += kThreads) {
        float sum = 0.f;
        for (int r = 0; r < kRows; ++r) sum += dzf[r * cmax + c];
        pb[G.db[i] + c] += sum;
      }
      // dW_i += bf16(a_prev)^T @ bf16(dz), tiles accumulated in the partial
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        const int mtiles = cin / 16;
        for (int t = warp; t < mtiles * (cout / 16); t += kWarps) {
          const int mt = t % mtiles;
          const int nt = t / mtiles;
          float* P = pb + G.dw[i] + mt * 16 * cout + nt * 16;
          wmma::load_matrix_sync(acc, P, cout, wmma::mem_row_major);
          for (int kk = 0; kk < kRows / 16; ++kk) {
            wmma::load_matrix_sync(fa, a_prev + kk * 16 * ca + mt * 16, ca);
            wmma::load_matrix_sync(fb, dzb + kk * 16 * cmax + nt * 16, cmax);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(P, acc, cout, wmma::mem_row_major);
        }
      }
      __syncthreads();
      // dz_{i-1} = (bf16(dz) @ bf16(W_i)^T) * [a_prev > 0]
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        const __nv_bfloat16* W = L.w[i];
        for (int t = warp; t < (kRows / 16) * (cin / 16); t += kWarps) {
          const int rt = t % (kRows / 16);
          const int nt = t / (kRows / 16);
          wmma::fill_fragment(acc, 0.f);
          for (int kk = 0; kk < cout / 16; ++kk) {
            wmma::load_matrix_sync(fa, dzb + rt * 16 * cmax + kk * 16, cmax);
            wmma::load_matrix_sync(fb, W + (size_t)nt * 16 * cout + kk * 16, cout);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
          __syncwarp();
          for (int q = 0; q < 8; ++q) {
            const int e = lane + 32 * q;
            const int r = rt * 16 + (e >> 4), c = nt * 16 + (e & 15);
            const float d = bf(a_prev[r * ca + c]) > 0.f ? st[e] : 0.f;
            dzf[r * cmax + c] = d;
            dzn[r * cmax + c] = __float2bfloat16_rn(d);
          }
          __syncwarp();
        }
      }
      __syncthreads();
      __nv_bfloat16* tmp = dzb;
      dzb = dzn;
      dzn = tmp;
    }

    // ---- layer 0 ----
    for (int c = tid; c < f0p; c += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < kRows; ++r) sum += dzf[r * cmax + c];
      pb[G.db[0] + c] += sum;
    }
    if (fold) {
      for (int e = tid; e < cpb * f0p; e += kThreads) {
        const int cl = e / f0p;
        const int f = e - cl * f0p;
        const int sc = s0 + cl;
        if (sc >= s) continue;
        float sum = 0.f;
        for (int k = 0; k < k_real; ++k) sum += dzf[(cl * kp + k) * cmax + f];
        dcent[((size_t)b * s + sc) * f0p + f] = -sum;
      }
    } else {
      for (int e = tid; e < kRows * 3; e += kThreads) {
        const int r = e / 3;
        const int c = e - r * 3;
        float sum = 0.f;
        for (int f = 0; f < f0p; ++f) sum += bf(dzb[r * cmax + f]) * bf(w0x[c * f0p + f]);
        drel[e] = sum;
      }
      for (int e = tid; e < 6 * f0p; e += kThreads) {
        const int c = e / f0p;
        const int f = e - c * f0p;
        float sum = 0.f;
        for (int r = 0; r < kRows; ++r) sum += geo[r * 6 + c] * bf(dzb[r * cmax + f]);
        pb[G.dw0x + e] += sum;
      }
      __syncthreads();
      for (int e = tid; e < cpb * 3; e += kThreads) {
        const int cl = e / 3;
        const int c = e - cl * 3;
        const int sc = s0 + cl;
        if (sc >= s) continue;
        float sum = 0.f;
        for (int k = 0; k < k_real; ++k) sum += drel[(cl * kp + k) * 3 + c];
        dcent[((size_t)b * s + sc) * 3 + c] = -sum;
      }
    }
    // transposed gather: thread f adds lane f of each real row, in order
    const int lanes = f0p + (fold ? 0 : 3);
    for (int f = tid; f < lanes; f += kThreads) {
      for (int r = 0; r < kRows; ++r) {
        if (s0 + r / kp >= s || r % kp >= k_real) continue;
        const size_t row = (size_t)b * n + rid[r];
        if (f < f0p) {
          dtable[row * f0p + f] += bf(dzb[r * cmax + f]);
        } else {
          dxyz[row * 3 + (f - f0p)] += bf(__float2bfloat16_rn(drel[r * 3 + (f - f0p)]));
        }
      }
    }
    __syncthreads();
  }
}

// grads[e] = sum over the blocks' partials, in block order
__global__ void sum_partials_kernel(const float* __restrict__ part, int slots, int size,
                                    float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float sum = 0.f;
  for (int i = 0; i < slots; ++i) sum += part[(size_t)i * size + e];
  grads[e] = sum;
}

// Layers from the C arguments; ca = the widest input of a layer with a
// successor, cmax = the widest layer.  Returns false on a shape the kernels
// do not take.
bool make_layers(int n_layers, int kp, const void* const* ws, const float* const* bs,
                 const int* widths, Layers* L, int* ca, int* cmax) {
  if (n_layers < 2 || n_layers > kMaxLayers || kp % 16 != 0 || kp > kRows ||
      kRows % kp != 0) {
    return false;
  }
  *ca = *cmax = 0;
  for (int j = 0; j < kMaxLayers; ++j) {
    L->w[j] = j < n_layers ? static_cast<const __nv_bfloat16*>(ws[j]) : nullptr;
    L->b[j] = j < n_layers ? bs[j] : nullptr;
    L->width[j] = j < n_layers ? widths[j] : 0;
    if (j < n_layers && (widths[j] % 16 != 0 || widths[j] <= 0)) return false;
    if (j < n_layers - 1 && widths[j] > *ca) *ca = widths[j];
    if (j < n_layers && widths[j] > *cmax) *cmax = widths[j];
  }
  L->n_layers = n_layers;
  return true;
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
  Layers L;
  int ca, cmax;
  if (!make_layers(n_layers, kp, ws, bs, widths, &L, &ca, &cmax)) {
    return (int)cudaErrorInvalidValue;
  }
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

// The size in floats of one partial slot (and of `grads`) for these widths.
extern "C" int fused_group_mlp_grad_size(int n_layers, const int* widths) {
  return grad_layout(widths, n_layers).size;
}

// The backward.  idx: (batch, s, kp) int32 in [0, n), padded as the forward
// took it, k_real <= kp real neighbours; fwd_out, ct: (batch, s, cout) f32.
// Outputs: dtable (batch, n, f0p) and dxyz (batch, n, 3, hilo) zeroed by the
// caller and accumulated; dcent (batch, s, f0p | 3) written; part (batch,
// grad size) zeroed scratch; grads (grad size) written; nomatch incremented.
extern "C" int fused_group_mlp_bwd_launch(
    int fold, const void* table, const float* xyz, const float* cent,
    const void* w0x, const int* idx, int batch, int n, int s, int kp, int k_real,
    int n_layers, const void* const* ws, const float* const* bs,
    const int* widths, const float* fwd_out, const float* ct, float* dtable,
    float* dxyz, float* dcent, float* part, float* grads, int* nomatch,
    void* stream) {
  Layers L;
  int ca, cmax;
  if (!make_layers(n_layers, kp, ws, bs, widths, &L, &ca, &cmax) || k_real < 1 ||
      k_real > kp) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = kWarps * 256 * sizeof(float) +
                      (size_t)kRows * cmax * sizeof(float) +
                      2 * (size_t)kRows * cmax * sizeof(__nv_bfloat16) +
                      (size_t)(n_layers - 1) * kRows * ca * sizeof(__nv_bfloat16) +
                      kRows * sizeof(int) + kRows * 9 * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_group_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_group_mlp_bwd_kernel<<<batch, kThreads, smem, st>>>(
      fold, static_cast<const __nv_bfloat16*>(table), xyz, cent,
      static_cast<const __nv_bfloat16*>(w0x), idx, n, s, kp, k_real, ca, cmax, L,
      fwd_out, ct, dtable, dxyz, dcent, part, nomatch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = grad_layout(widths, n_layers).size;
  sum_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(part, batch, size, grads);
  return (int)cudaGetLastError();
}
