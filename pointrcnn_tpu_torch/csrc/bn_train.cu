// Batch-statistics batch norm for the training SharedMLP stacks: the
// element-wise and reduction passes around each layer's GEMM.
//
// Replaces: the generic training route of models/layers.py::SharedMLP
// (batch_stats, the running update, (y - mean) * inv + bias, relu, amax
// and autograd's passes back through each), which the TPU reference gets
// fused by XLA (pointrcnn_tpu/models/layers.py:219-248).  Same contract as
// the plain versions in ops/cuda_bn.py:
//
// - stats (the finalize): from the batch's mean and mean of y^2 per
//   channel (f32, by PyTorch's own reductions, as the generic route takes
//   them), var = max(E[y^2] - mean^2, 0), r = rsqrt(var + eps), inv = r *
//   scale, and the running update (1 - m) * mean_r + m * mean,
//   (1 - m) * var_r + (m * var) * n / (n - 1), all in f32 as the generic
//   route's tensor operations, m passed by value;
// - apply: bf16_round?(relu((y - mean) * inv + bias)); with the max over K,
//   the max of K rows of a group and how many rows tie at it;
// - bwd sums: dz = the cotangent (bf16-rounded on load where autograd
//   rounds it) where z > 0, at the max layer g / count where a row ties
//   the max; the f64 sums of dz and dz * (y - mean) -> dbias, dscale = S2 *
//   r, and the coefficients of dy = inv * dz + b + c * (y - mean);
// - bwd apply: dy in f32.
//
// What bounds it on the H100: bytes.  Every kernel but the C-sized finalize
// reads (and the applies write) each element once in float4s.
//
// What the design does about it:
// - A block is C / 4 threads across a row's float4s times `lanes` rows, so
//   each thread keeps its four channels' parameters and sums in registers.
// - The forward's output is bit for bit the generic route's: the
//   statistics come from the same reductions and the element-wise
//   operations round as its tensor operations do.  A max over K makes the
//   gradients of the layers below jump where a rounding moves which
//   neighbour wins, so a forward that rounded otherwise would move them by
//   several percent (the benchmark's check reads 0.05-0.13 of a leaf).
// - No float atomics in the backward: its reduction writes per-block
//   partial sums in f64 (a fixed partition of the rows, a fixed tree over
//   the lanes), and a finalize (a block of 32 channels x 32 strided lanes)
//   sums them in a fixed order, so a run is deterministic.  Under data
//   parallel the host all-reduces the 2C sums between the two.
// - At the max layer the forward also stores each (group, channel)'s count
//   of tied rows, so the backward splits the cotangent in one pass over the
//   group's rows instead of two.
//
// Compiled with --fmad=false: the element-wise arithmetic rounds after each
// operation, as the plain versions' separate tensor operations do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalizeLanes = 32;
// rows (or groups) a thread of a reduction sums at least: fewer, larger
// blocks keep the partial rows (G x 2C f64, read back by the finalize) small
// beside the activation
constexpr int kMinPerThread = 16;

// +0 for z <= 0, NaN passes, as torch.relu
__device__ __forceinline__ float relu(float z) { return z <= 0.f ? 0.f : z; }

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the max that keeps a NaN, as torch.amax
__device__ __forceinline__ float max_nan(float m, float a) { return (a > m || a != a) ? a : m; }

struct Chan {
  float4 mean, inv, bias;
};

__device__ __forceinline__ float4 ld4(const float* p, int c4) {
  return reinterpret_cast<const float4*>(p)[c4];
}

__device__ __forceinline__ Chan load_chan(const float* stats, const float* bias, int C, int c4) {
  return {ld4(stats, c4), ld4(stats + C, c4), ld4(bias, c4)};
}

// y -> z = (y - mean) * inv + bias, component by component
__device__ __forceinline__ float bn1(float y, float mean, float inv, float bias) {
  return (y - mean) * inv + bias;
}

__device__ __forceinline__ float4 bn4(float4 y, const Chan& p) {
  return {bn1(y.x, p.mean.x, p.inv.x, p.bias.x), bn1(y.y, p.mean.y, p.inv.y, p.bias.y),
          bn1(y.z, p.mean.z, p.inv.z, p.bias.z), bn1(y.w, p.mean.w, p.inv.w, p.bias.w)};
}

__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

// the block's per-thread sums (8 a thread: S1 and S2 of its four channels)
// summed over the lanes by a fixed tree; lane 0 writes the block's partial
// row part[block, 0:C] = S1, part[block, C:2C] = S2
__device__ void block_partial(double (&acc)[8], int c4, int lane, int lanes, int C,
                              double* __restrict__ part) {
  __shared__ double sh[kThreads * 8];
  const int t = lane * (C / 4) + c4;
#pragma unroll
  for (int j = 0; j < 8; ++j) sh[t * 8 + j] = acc[j];
  __syncthreads();
  int span = 1;
  while (span < lanes) span <<= 1;
  for (int half = span >> 1; half >= 1; half >>= 1) {
    if (lane < half && lane + half < lanes) {
      const int o = (lane + half) * (C / 4) + c4;
#pragma unroll
      for (int j = 0; j < 8; ++j) sh[t * 8 + j] += sh[o * 8 + j];
    }
    __syncthreads();
  }
  if (lane == 0) {
    double* row = part + (size_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      row[4 * c4 + j] = sh[t * 8 + j];
      row[C + 4 * c4 + j] = sh[t * 8 + 4 + j];
    }
  }
}

// the 2C sums of G partial rows, summed in a fixed order by kFinalizeLanes
// strided lanes and a fixed tree; block x holds channels 32x .. 32x + 31
__device__ bool finalize_sums(const double* __restrict__ part, int G, int C, double& s1,
                              double& s2) {
  __shared__ double sh[kFinalizeLanes][32][2];
  const int c = blockIdx.x * 32 + threadIdx.x, gl = threadIdx.y;
  s1 = 0.0;
  s2 = 0.0;
  if (c < C) {
#pragma unroll 4
    for (int g = gl; g < G; g += kFinalizeLanes) {
      s1 += part[(size_t)g * 2 * C + c];
      s2 += part[(size_t)g * 2 * C + C + c];
    }
  }
  sh[gl][threadIdx.x][0] = s1;
  sh[gl][threadIdx.x][1] = s2;
  __syncthreads();
  for (int half = kFinalizeLanes / 2; half >= 1; half >>= 1) {
    if (gl < half) {
      sh[gl][threadIdx.x][0] += sh[gl + half][threadIdx.x][0];
      sh[gl][threadIdx.x][1] += sh[gl + half][threadIdx.x][1];
    }
    __syncthreads();
  }
  s1 = sh[0][threadIdx.x][0];
  s2 = sh[0][threadIdx.x][1];
  return gl == 0 && c < C;
}

// the statistics (mean, inv, r, the clamp's gate) from the batch's mean
// and mean of y^2, and the running update
__global__ void stats_finalize(const float* __restrict__ mean, const float* __restrict__ ex2,
                               int C, float momentum, float factor, float eps,
                               const float* __restrict__ scale, float* __restrict__ run_mean,
                               float* __restrict__ run_var, float* __restrict__ stats) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float mu = mean[c], d = ex2[c] - mu * mu;
  const float var = d < 0.f ? 0.f : d;  // NaN passes, as torch.clamp
  const float r = rsqrtf(var + eps);
  stats[c] = mu;
  stats[C + c] = r * scale[c];
  stats[2 * C + c] = r;
  // clamp's backward passes the variance's cotangent where var >= 0
  stats[3 * C + c] = d >= 0.f ? 1.f : 0.f;
  const float m = momentum, om = 1.f - m;
  run_mean[c] = om * run_mean[c] + m * mu;
  run_var[c] = om * run_var[c] + (m * var) * factor;
}

// out = bf16_round?(relu(bn(y))), rows of C
__global__ void __launch_bounds__(kThreads)
    apply_rows(const float* __restrict__ y, long long rows, int C, int lanes,
               const float* __restrict__ stats, const float* __restrict__ bias, int round_out,
               float* __restrict__ out) {
  const int c4n = C / 4, c4 = threadIdx.x % c4n, lane = threadIdx.x / c4n;
  const Chan p = load_chan(stats, bias, C, c4);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long step = (long long)gridDim.x * lanes;
#pragma unroll 4
  for (long long r = (long long)blockIdx.x * lanes + lane; r < rows; r += step) {
    float4 a = bn4(y4[r * c4n + c4], p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = relu(get(a, j));
      set(a, j, round_out ? bf16r(v) : v);
    }
    o4[r * c4n + c4] = a;
  }
}

// out[s] = max over the K rows of group s of relu(bn(y)), cnt[s] the rows
// at that max
__global__ void __launch_bounds__(kThreads)
    apply_max(const float* __restrict__ y, long long groups, int K, int C, int lanes,
              const float* __restrict__ stats, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ cnt) {
  const int c4n = C / 4, c4 = threadIdx.x % c4n, lane = threadIdx.x / c4n;
  const Chan p = load_chan(stats, bias, C, c4);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const long long step = (long long)gridDim.x * lanes;
  for (long long s = (long long)blockIdx.x * lanes + lane; s < groups; s += step) {
    float4 m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* g4 = y4 + (s * K) * c4n + c4;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 a = bn4(g4[(long long)k * c4n], p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = relu(get(a, j)), mj = get(m, j);
        set(n, j, v == mj ? get(n, j) + 1.f : (v > mj || v != v) ? 1.f : get(n, j));
        set(m, j, max_nan(mj, v));
      }
    }
    reinterpret_cast<float4*>(out)[s * c4n + c4] = m;
    reinterpret_cast<float4*>(cnt)[s * c4n + c4] = n;
  }
}

// the cotangent of z at one row: the incoming one where z > 0 (rounded to
// bf16 on load where autograd rounds it); at the max layer g / count
// where the row ties the group's max
template <bool MAX>
__device__ __forceinline__ float4 dz4(const float4& z, const float4& g, const float4& m,
                                      int round_g) {
  float4 d;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float zj = get(z, j);
    float gj = get(g, j);
    if (!MAX && round_g) gj = bf16r(gj);
    const bool on = MAX ? (relu(zj) == get(m, j) && zj > 0.f) : zj > 0.f;
    set(d, j, on ? gj : 0.f);
  }
  return d;
}

// the groups [b * per, (b + 1) * per) of K rows (K = 1 without the max):
// the f64 sums of dz and dz * (y - mean) per channel
template <bool MAX>
__global__ void __launch_bounds__(kThreads)
    bwd_partial(const float* __restrict__ y, const float* __restrict__ g, long long groups, int K,
                int C, int lanes, long long per, const float* __restrict__ stats,
                const float* __restrict__ bias, const float* __restrict__ out,
                const float* __restrict__ cnt, int round_g, double* __restrict__ part) {
  const int c4n = C / 4, c4 = threadIdx.x % c4n, lane = threadIdx.x / c4n;
  const Chan p = load_chan(stats, bias, C, c4);
  double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long s0 = (long long)blockIdx.x * per;
  const long long s1 = min(groups, s0 + per);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const float4* gi4 = reinterpret_cast<const float4*>(g);
  for (long long s = s0 + lane; s < s1; s += lanes) {
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f), gs = m;
    if (MAX) {
      m = reinterpret_cast<const float4*>(out)[s * c4n + c4];
      const float4 n = reinterpret_cast<const float4*>(cnt)[s * c4n + c4];
      const float4 gv = gi4[s * c4n + c4];
      gs = make_float4(gv.x / n.x, gv.y / n.y, gv.z / n.z, gv.w / n.w);
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const long long at = (s * K + k) * c4n + c4;
      const float4 yv = y4[at];
      const float4 d = dz4<MAX>(bn4(yv, p), MAX ? gs : gi4[at], m, round_g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double dj = get(d, j);
        acc[j] += dj;
        acc[4 + j] += dj * (double)(get(yv, j) - get(p.mean, j));
      }
    }
  }
  block_partial(acc, c4, lane, lanes, C, part);
}

// from the sums of dz and dz * (y - mean): dbias = S1 and dscale = S2 * r
// (dscale set; the rank's own sums), the 2C sums (sums_out set, for the
// all-reduce), and the coefficients a = inv, b = -inv S1 / n,
// c = -inv r^2 S2 / n (gated by the variance's clamp) of the global sums
// (coef set)
__global__ void bwd_finalize(const double* __restrict__ part, int G, int C, double n,
                             const float* __restrict__ stats, float* __restrict__ dscale,
                             float* __restrict__ dbias, double* __restrict__ sums_out,
                             float* __restrict__ coef) {
  double s1, s2;
  if (!finalize_sums(part, G, C, s1, s2)) return;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const double inv = stats[C + c], r = stats[2 * C + c];
  if (dscale != nullptr) {
    dbias[c] = (float)s1;
    dscale[c] = (float)(s2 * r);
  }
  if (sums_out != nullptr) {
    sums_out[c] = s1;
    sums_out[C + c] = s2;
  }
  if (coef != nullptr) {
    coef[c] = (float)inv;
    coef[C + c] = (float)(-inv * s1 / n);
    coef[2 * C + c] = (float)(-inv * r * r * s2 / n) * stats[3 * C + c];
  }
}

// dy = (a * dz + b) + c * (y - mean)
template <bool MAX>
__global__ void __launch_bounds__(kThreads)
    bwd_apply(const float* __restrict__ y, const float* __restrict__ g, long long groups, int K,
              int C, int lanes, const float* __restrict__ stats, const float* __restrict__ bias,
              const float* __restrict__ coef, const float* __restrict__ out,
              const float* __restrict__ cnt, int round_g, float* __restrict__ dy) {
  const int c4n = C / 4, c4 = threadIdx.x % c4n, lane = threadIdx.x / c4n;
  const Chan p = load_chan(stats, bias, C, c4);
  const float4 ca = ld4(coef, c4), cb = ld4(coef + C, c4), cc = ld4(coef + 2 * C, c4);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const float4* gi4 = reinterpret_cast<const float4*>(g);
  float4* d4 = reinterpret_cast<float4*>(dy);
  const long long step = (long long)gridDim.x * lanes;
  for (long long s = (long long)blockIdx.x * lanes + lane; s < groups; s += step) {
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f), gs = m;
    if (MAX) {
      m = reinterpret_cast<const float4*>(out)[s * c4n + c4];
      const float4 n = reinterpret_cast<const float4*>(cnt)[s * c4n + c4];
      const float4 gv = gi4[s * c4n + c4];
      gs = make_float4(gv.x / n.x, gv.y / n.y, gv.z / n.z, gv.w / n.w);
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const long long at = (s * K + k) * c4n + c4;
      const float4 yv = y4[at];
      const float4 d = dz4<MAX>(bn4(yv, p), MAX ? gs : gi4[at], m, round_g);
      float4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        set(o, j, (get(ca, j) * get(d, j) + get(cb, j)) +
                      get(cc, j) * (get(yv, j) - get(p.mean, j)));
      d4[at] = o;
    }
  }
}

int lanes_of(int C) { return C / 4 >= kThreads ? 1 : kThreads / (C / 4); }

bool bad_width(int C) { return C < 4 || C % 4 != 0 || C / 4 > kThreads; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// element-wise grids: enough blocks to fill the card several times over
int apply_grid(long long groups, int lanes) {
  return (int)min(ceil_div(groups, lanes), 8LL * 132);
}

}  // namespace

extern "C" {

// the number of partial rows the reductions write for `groups` of C
int bn_train_partials(long long groups, int C) {
  if (bad_width(C) || groups < 1) return 0;
  return (int)min(ceil_div(groups, (long long)lanes_of(C) * kMinPerThread), 1024LL);
}

// the statistics and running update from the batch's mean and mean of y^2
int bn_train_stats_launch(const float* mean, const float* ex2, int C, float momentum,
                          float factor, float eps, const float* scale, float* run_mean,
                          float* run_var, float* stats, void* stream) {
  if (bad_width(C)) return (int)cudaErrorInvalidValue;
  stats_finalize<<<(C + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      mean, ex2, C, momentum, factor, eps, scale, run_mean, run_var, stats);
  return (int)cudaGetLastError();
}

// K == 0: rows of C -> bf16_round?(relu(bn(y))); K >= 1: groups of K rows
// -> their max and the count of rows at it
int bn_train_apply_launch(const float* y, long long groups, int K, int C, const float* stats,
                          const float* bias, int round_out, float* out, float* cnt,
                          void* stream) {
  if (bad_width(C) || groups < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = lanes_of(C), grid = apply_grid(groups, lanes);
  if (K == 0)
    apply_rows<<<grid, lanes * (C / 4), 0, st>>>(y, groups, C, lanes, stats, bias, round_out,
                                                 out);
  else
    apply_max<<<grid, lanes * (C / 4), 0, st>>>(y, groups, K, C, lanes, stats, bias, out, cnt);
  return (int)cudaGetLastError();
}

// partial sums of dz and dz * (y - mean) + their finalize (see
// bwd_finalize); K == 0: rows with their own cotangent, K >= 1: groups of
// K rows with the max layer's
int bn_train_bwd_sums_launch(const float* y, const float* g, long long groups, int K, int C,
                             const float* stats, const float* bias, const float* out,
                             const float* cnt, int round_g, double* part, double n,
                             float* dscale, float* dbias, double* sums_out, float* coef,
                             void* stream) {
  const int G = bn_train_partials(groups, C);
  if (G == 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = lanes_of(C);
  const long long per = ceil_div(groups, G);
  if (K == 0)
    bwd_partial<false><<<G, lanes * (C / 4), 0, st>>>(y, g, groups, 1, C, lanes, per, stats,
                                                      bias, out, cnt, round_g, part);
  else
    bwd_partial<true><<<G, lanes * (C / 4), 0, st>>>(y, g, groups, K, C, lanes, per, stats,
                                                     bias, out, cnt, round_g, part);
  bwd_finalize<<<(C + 31) / 32, dim3(32, kFinalizeLanes), 0, st>>>(part, G, C, n, stats, dscale,
                                                                  dbias, sums_out, coef);
  return (int)cudaGetLastError();
}

// the coefficients from all-reduced sums (2C f64)
int bn_train_bwd_finalize_launch(const double* sums, int C, double n, const float* stats,
                                 float* coef, void* stream) {
  if (bad_width(C)) return (int)cudaErrorInvalidValue;
  bwd_finalize<<<(C + 31) / 32, dim3(32, kFinalizeLanes), 0,
                 static_cast<cudaStream_t>(stream)>>>(sums, 1, C, n, stats, nullptr, nullptr,
                                                      nullptr, coef);
  return (int)cudaGetLastError();
}

int bn_train_bwd_apply_launch(const float* y, const float* g, long long groups, int K, int C,
                              const float* stats, const float* bias, const float* coef,
                              const float* out, const float* cnt, int round_g, float* dy,
                              void* stream) {
  if (bad_width(C) || groups < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = lanes_of(C), grid = apply_grid(groups, lanes);
  if (K == 0)
    bwd_apply<false><<<grid, lanes * (C / 4), 0, st>>>(y, g, groups, 1, C, lanes, stats, bias,
                                                       coef, out, cnt, round_g, dy);
  else
    bwd_apply<true><<<grid, lanes * (C / 4), 0, st>>>(y, g, groups, K, C, lanes, stats, bias,
                                                      coef, out, cnt, round_g, dy);
  return (int)cudaGetLastError();
}

}  // extern "C"
