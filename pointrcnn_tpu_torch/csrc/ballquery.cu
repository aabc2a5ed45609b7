// Stride-class ball-query candidate selection, full scan (K5) and banded
// (K6): a warp per centroid (or a few), over candidates staged once per block.
//
// Replaces: pointrcnn_tpu/ops/pallas_ballquery.py::_make_kernel (entry
// _ball_query_pallas: ball_query_pallas, ball_query_multi_grouped_pallas) and
// ::_make_banded_kernel (entry _ball_query_pallas_banded:
// ball_query_multi_grouped_banded), and the lax.cond of
// pointrcnn_tpu/ops/grouping.py::fps_group_banded that picks between them.
// Same contract:
//
// - stride class j (W of them: 512, 256 or 128) scans candidates j, j+W,
//   j+2W, ... of its range in order and keeps the nearest by direct-difference
//   squared distance (dx*dx + dy*dy) + dz*dz, replacing only on a strictly
//   smaller one (3e38 to start), so the lower index wins a tie and a NaN or
//   inf distance never enters;
// - the W class minima fold pairwise to 128 lanes, a tie keeping the lower
//   class;
// - kmax ascending extractions over the 128 lanes, each taking the smallest
//   value and the lowest lane among equals, then marking that lane 3e38; once
//   the finite candidates run out the lowest lane whose value is 3e38 repeats,
//   which is folded lane 0 (every lane is 3e38 by then);
// - outputs dist2, the candidate index (0 for a lane that kept none), and
//   optionally xyz[idx] - centroid (0 - centroid for a lane that kept none,
//   the TPU kernel's carried zeros).
//
// The full scan's range is the whole row (N points).  The banded kernel's
// table is z-sorted and its centroids band-ordered (S / n_bands per band):
// the range of a centroid in band b is band b-1, band b, band b+1 (Ns points
// each, in that order, which is ascending index order); a band past either
// edge is skipped.  Its thin-band flag lives on the device: a block that
// reads it false scans its whole row instead, with W = pick_w(N).
//
// What bounds it on the H100: the scan's FP32 operations, 9 per (centroid,
// candidate) pair (3 sub, 3 mul, 2 add, a compare) at one a lane a clock
// (--fmad=false, so none fuse; 33.5 T op/s on an H100 SXM at 700 W): 0.0131
// ms at the eval forward's RPN SA1 (banded, 4 x 4096 centroids x 2048-3072
// candidates), 0.0046 ms at RPN SA2 (full scan, 4 x 1024 x 4096).  Tables
// and outputs move in less time.
//
// What the design does about it:
// - a warp takes U centroids (1 or 2) of one batch row; lane t holds
//   classes 4t + r + 128 i (r < 4) in registers, W / 32 values and passes a
//   centroid, so four candidates cost three 16-byte shared-memory loads,
//   shared by the U centroids, beside their 9 operations and 2 selects
//   each, and the fold (classes j and j + W/2 sit on one lane) needs no
//   barrier;
// - a block's warps share its candidates: 2048-point tiles are copied into
//   shared memory by TMA bulk copies (one thread, an mbarrier a buffer, two
//   buffers, so the next tile lands while this one is scanned).  The tile
//   stays (x, y, z) interleaved, so one copy stages it with no transposing
//   pass: a lane's four points are 48 contiguous bytes, and the 16-byte
//   pieces of 8 lanes at that stride fall in distinct banks.  K6's block
//   holds centroids of one band, so it stages bands b-1..b+1 once; K5's
//   block streams its batch row;
// - the extraction is one sort of the 128 folded lanes by (value, lane),
//   the order the kmax extractions take them in: a bitonic network in the
//   warp's registers and shuffles (each slot's 32 keys sorted across the
//   lanes, then two rounds that keep the 32 smallest of two sorted runs),
//   25 dependent steps of four independent exchanges where kmax serial
//   warp-wide minima would each wait on the last; lane k ends with
//   extraction k, so the outputs are stored coalesced, a lane an entry.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kTile = 2048;  // points a staged tile (a multiple of every W)
constexpr int kTileFloats = 3 * kTile;
constexpr int kStageBytes = 2 * kTileFloats * 4;  // two buffers
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bars_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar + 1)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// thread 0: copy tile ``tile`` of the range [start, start + count) of the
// batch row ``tab`` into buffer tile & 1, completing on its mbarrier
__device__ __forceinline__ void stage_tile(const float* tab, int start, int count, int tile,
                                           float* stage, uint64_t* bar) {
  const int first = tile * kTile;
  const unsigned bytes = 12u * (unsigned)min(kTile, count - first);
  uint64_t* b = bar + (tile & 1);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(stage + (tile & 1) * kTileFloats)),
      "l"(tab + 3 * (size_t)(start + first)), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// one compare-exchange of a bitonic network between this lane and lane ^
// d: the smaller key where ``keep_min``, else the larger (keys are distinct)
__device__ __forceinline__ unsigned long long exchange(unsigned long long a, int d,
                                                       bool keep_min) {
  const unsigned long long b = __shfl_xor_sync(kFull, a, d);
  return (b < a) == keep_min ? b : a;
}

// fold the first N of a lane's M class minima to 4: classes j and j + W/2
// sit on the same lane, in slots s and s + N/2; a tie keeps the lower class
template <int N, int M, int U>
__device__ __forceinline__ void fold(float (&v)[U][M], int (&g)[U][M]) {
  if constexpr (N > 4) {
    constexpr int h = N / 2;
#pragma unroll
    for (int j = 0; j < U; ++j) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        if (v[j][i + h] < v[j][i]) {
          v[j][i] = v[j][i + h];
          g[j][i] = g[j][i + h];
        }
      }
    }
    fold<h, M, U>(v, g);
  }
}

struct Out {
  const float* cent;
  int s, kmax;
  float* dist2;
  int* idx;
  float* rel;
};

// The selection of the warp's U centroids (c, rows ``crow`` of the batch
// row's S; ``ok`` false for a padding centroid past S) over the candidates
// [start, start + count) of the batch row ``tab``, W classes; the block's
// threads all call it with the same range.
template <int W, int U>
__device__ __forceinline__ void select_range(const float* __restrict__ tab, int start, int count,
                                             const float (&c)[U][3], const int (&crow)[U],
                                             const bool (&ok)[U], size_t orow, const Out& o,
                                             float* stage, uint64_t* bar) {
  constexpr int M = W / 32;
  const int lane = threadIdx.x & 31;
  float v[U][M];
  int g[U][M];  // the pass a class's minimum came from, -1 for none
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      v[j][i] = kBig;
      g[j][i] = -1;
    }
  }

  const int tiles = (count + kTile - 1) / kTile;
  if (threadIdx.x == 0) stage_tile(tab, start, count, 0, stage, bar);
  for (int tile = 0; tile < tiles; ++tile) {
    // the other buffer was last read in the previous tile, behind its barrier
    if (threadIdx.x == 0 && tile + 1 < tiles) stage_tile(tab, start, count, tile + 1, stage, bar);
    bar_wait(bar + (tile & 1), (tile >> 1) & 1);
    // this lane's four consecutive points of each 128: three 16-byte loads
    const float4* sp = reinterpret_cast<const float4*>(stage + (tile & 1) * kTileFloats) + 3 * lane;
    const int passes = min(kTile, count - tile * kTile) / W;
    const int p0 = tile * (kTile / W);
    for (int p = 0; p < passes; ++p, sp += 3 * W / 4) {
#pragma unroll
      for (int i = 0; i < M / 4; ++i) {
        const float4 a = sp[96 * i], b = sp[96 * i + 1], e = sp[96 * i + 2];
        const float px[4] = {a.x, a.w, b.z, e.y}, py[4] = {a.y, b.x, b.w, e.z},
                    pz[4] = {a.z, b.y, e.x, e.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int j = 0; j < U; ++j) {
            const float dx = c[j][0] - px[r], dy = c[j][1] - py[r], dz = c[j][2] - pz[r];
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < v[j][4 * i + r]) {
              v[j][4 * i + r] = d2;
              g[j][4 * i + r] = p0 + p;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // passes -> candidate indices (-1 for a class that kept none), then fold
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (g[j][i] >= 0) g[j][i] = start + g[j][i] * W + 128 * (i / 4) + 4 * lane + i % 4;
  }
  fold<M, M, U>(v, g);

  // the kmax extractions as one sort: key (value bits, folded lane 4t + s)
  // orders as the extraction picks (v >= +0, so its bits order as unsigned
  // integers; folded lanes are distinct, so no two keys are equal); lane k
  // ends with the k-th smallest
  unsigned long long key[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      key[j][i] = (unsigned long long)__float_as_uint(v[j][i]) << 32 | (unsigned)(4 * lane + i);
  }
  // each slot's 32 keys across the warp: slots 0 and 2 ascending, 1 and 3
  // descending (a bitonic sort, every comparison flipped for descending)
#pragma unroll
  for (int lk = 1; lk <= 5; ++lk) {
#pragma unroll
    for (int ld = lk - 1; ld >= 0; --ld) {
      const bool up = ((lane >> ld) & 1) == ((lane >> lk) & 1);
#pragma unroll
      for (int j = 0; j < U; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) key[j][i] = exchange(key[j][i], 1 << ld, up != (i & 1));
      }
    }
  }
  // an ascending and a descending run of 32: the 32 smallest of both are
  // their elementwise minima, a bitonic run; sorted, then the same again
  unsigned long long lo[U], hi[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    lo[j] = key[j][1] < key[j][0] ? key[j][1] : key[j][0];
    hi[j] = key[j][3] < key[j][2] ? key[j][3] : key[j][2];
  }
#pragma unroll
  for (int ld = 4; ld >= 0; --ld) {
    const bool lower = ((lane >> ld) & 1) == 0;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      lo[j] = exchange(lo[j], 1 << ld, lower);
      hi[j] = exchange(hi[j], 1 << ld, !lower);
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) lo[j] = hi[j] < lo[j] ? hi[j] : lo[j];
#pragma unroll
  for (int ld = 4; ld >= 0; --ld) {
    const bool lower = ((lane >> ld) & 1) == 0;
#pragma unroll
    for (int j = 0; j < U; ++j) lo[j] = exchange(lo[j], 1 << ld, lower);
  }
  // past the finite candidates every lane is 3e38 and folded lane 0 repeats
  const unsigned big = __float_as_uint(kBig);
  unsigned od[U], ow[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    od[j] = (unsigned)(lo[j] >> 32);
    ow[j] = od[j] == big ? 0u : (unsigned)lo[j];
  }

  // the winners' candidate indices, then a lane an output entry; a lane that
  // kept none gives index 0 and, for rel, the coordinates 0
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int src = ow[j] >> 2, slot = ow[j] & 3;
    int q = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = __shfl_sync(kFull, g[j][i], src);
      if (slot == i) q = gi;
    }
    if (ok[j] && lane < o.kmax) {
      const size_t e = (orow + crow[j]) * o.kmax + lane;
      o.dist2[e] = __uint_as_float(od[j]);
      o.idx[e] = max(q, 0);
      if (o.rel != nullptr) {
        const float* p = tab + 3 * max(q, 0);
        o.rel[3 * e] = (q < 0 ? 0.0f : p[0]) - c[j][0];
        o.rel[3 * e + 1] = (q < 0 ? 0.0f : p[1]) - c[j][1];
        o.rel[3 * e + 2] = (q < 0 ? 0.0f : p[2]) - c[j][2];
      }
    }
  }
}

// the warp's U centroids: rows c0 .. c0 + U - 1 of batch row b (clamped to
// the last row past S, and then not stored)
template <int U>
__device__ __forceinline__ void load_centroids(const Out& o, int b, float (&c)[U][3],
                                              int (&crow)[U], bool (&ok)[U]) {
  const int c0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * U;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    ok[j] = c0 + j < o.s;
    crow[j] = ok[j] ? c0 + j : o.s - 1;
    const float* p = o.cent + ((size_t)b * o.s + crow[j]) * 3;
    c[j][0] = p[0];
    c[j][1] = p[1];
    c[j][2] = p[2];
  }
}

template <int W, int U>
__global__ void __launch_bounds__(32 * kMaxWarps) ball_query_kernel(const float* __restrict__ xyz,
                                                                     int n, Out o) {
  extern __shared__ __align__(128) float stage[];
  __shared__ uint64_t bar[2];
  bars_init(bar);
  const int b = blockIdx.y;
  float c[U][3];
  int crow[U];
  bool ok[U];
  load_centroids<U>(o, b, c, crow, ok);
  select_range<W, U>(xyz + (size_t)b * n * 3, 0, n, c, crow, ok, (size_t)b * o.s, o, stage, bar);
}

template <int WB, int WF, int U>
__global__ void __launch_bounds__(32 * kMaxWarps) ball_query_banded_kernel(
    const float* __restrict__ xyz, int n, int n_bands, const unsigned char* __restrict__ bands_ok,
    Out o) {
  extern __shared__ __align__(128) float stage[];
  __shared__ uint64_t bar[2];
  bars_init(bar);
  const int b = blockIdx.y;
  float c[U][3];
  int crow[U];
  bool ok[U];
  load_centroids<U>(o, b, c, crow, ok);
  const float* tab = xyz + (size_t)b * n * 3;
  if (*bands_ok) {
    // the block's centroids lie in one band (the launcher checks)
    const int ns = n / n_bands;
    const int band = (blockIdx.x * (blockDim.x / 32) * U) / (o.s / n_bands);
    const int lo = max(band - 1, 0), hi = min(band + 1, n_bands - 1);
    select_range<WB, U>(tab, lo * ns, (hi - lo + 1) * ns, c, crow, ok, (size_t)b * o.s, o, stage,
                        bar);
  } else {
    select_range<WF, U>(tab, 0, n, c, crow, ok, (size_t)b * o.s, o, stage, bar);
  }
}

// the launch plans ops/cuda_ballquery.py::plan picks, (U centroids a warp,
// warps a block); the launchers refuse any other
constexpr int kFullPlans[][2] = {{2, 16}, {2, 8}, {2, 4}, {1, 4}};
constexpr int kBandedPlans[][2] = {{1, 8}, {2, 4}, {1, 4}};

template <int P>
bool plan_in(const int (&plans)[P][2], int u, int warps) {
  for (int i = 0; i < P; ++i)
    if (plans[i][0] == u && plans[i][1] == warps) return true;
  return false;
}

bool w_ok(int w) { return w == 128 || w == 256 || w == 512; }

struct FullArgs {
  const float* xyz;
  int n;
  Out o;
};

struct BandedArgs {
  const float* xyz;
  int n, n_bands;
  const unsigned char* bands_ok;
  Out o;
};

// lets ``kernel`` take the two stage buffers (past the 48 KB default), once
template <typename K>
cudaError_t allow_stage(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  done = e == cudaSuccess;
  return e;
}

template <int W, int U>
int full_launch(dim3 grid, int warps, cudaStream_t stream, const FullArgs& a) {
  static bool done = false;
  if (const cudaError_t e = allow_stage(ball_query_kernel<W, U>, done)) return (int)e;
  ball_query_kernel<W, U><<<grid, 32 * warps, kStageBytes, stream>>>(a.xyz, a.n, a.o);
  return (int)cudaGetLastError();
}

template <int WB, int WF, int U>
int banded_launch(dim3 grid, int warps, cudaStream_t stream, const BandedArgs& a) {
  static bool done = false;
  if (const cudaError_t e = allow_stage(ball_query_banded_kernel<WB, WF, U>, done)) return (int)e;
  ball_query_banded_kernel<WB, WF, U><<<grid, 32 * warps, kStageBytes, stream>>>(
      a.xyz, a.n, a.n_bands, a.bands_ok, a.o);
  return (int)cudaGetLastError();
}

template <int U>
int full_w(int w, dim3 grid, int warps, cudaStream_t stream, const FullArgs& a) {
  switch (w) {
    case 128: return full_launch<128, U>(grid, warps, stream, a);
    case 256: return full_launch<256, U>(grid, warps, stream, a);
    case 512: return full_launch<512, U>(grid, warps, stream, a);
  }
  return (int)cudaErrorInvalidValue;
}

// W of the full-row branch is at least the bands' (N is a multiple of Ns)
template <int U, int WB>
int banded_wf(int wf, dim3 grid, int warps, cudaStream_t stream, const BandedArgs& a) {
  switch (wf) {
    case 128:
      if constexpr (WB == 128) return banded_launch<WB, 128, U>(grid, warps, stream, a);
      break;
    case 256:
      if constexpr (WB <= 256) return banded_launch<WB, 256, U>(grid, warps, stream, a);
      break;
    case 512: return banded_launch<WB, 512, U>(grid, warps, stream, a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int U>
int banded_w(int wb, int wf, dim3 grid, int warps, cudaStream_t stream, const BandedArgs& a) {
  switch (wb) {
    case 128: return banded_wf<U, 128>(wf, grid, warps, stream, a);
    case 256: return banded_wf<U, 256>(wf, grid, warps, stream, a);
    case 512: return banded_wf<U, 512>(wf, grid, warps, stream, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xyz (B, N, 3), cent (B, S, 3) f32 -> dist2 (B, S, kmax) f32, idx (B, S,
// kmax) int32, rel (B, S, kmax, 3) f32 or null; W classes (128, 256 or 512)
// divide N; xyz 16-byte aligned; plan (u, warps) one of kFullPlans
extern "C" int ball_query_launch(const float* xyz, const float* cent, int batch, int n, int s,
                                 int w, int kmax, int u, int warps, float* dist2, int* idx,
                                 float* rel, void* stream) {
  if (!plan_in(kFullPlans, u, warps) || !w_ok(w) || n % w != 0 || kmax < 1 || kmax > 32 ||
      s < 1 || reinterpret_cast<uintptr_t>(xyz) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = u * warps;
  const dim3 grid((s + per_block - 1) / per_block, batch);
  const FullArgs a{xyz, n, Out{cent, s, kmax, dist2, idx, rel}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (u) {
    case 1: return full_w<1>(w, grid, warps, st, a);
    case 2: return full_w<2>(w, grid, warps, st, a);
  }
  return (int)cudaErrorInvalidValue;
}

// the same over a z-sorted table of n_bands equal bands (W = wb classes,
// dividing N / n_bands), with band-ordered centroids and rel; ``bands_ok``
// a device byte: where it reads 0 every block scans its whole row with W =
// wf classes (dividing N); plan (u, warps) one of kBandedPlans, a block's u
// * warps centroids dividing the S / n_bands of a band
extern "C" int ball_query_banded_launch(const float* xyz, const float* cent,
                                        const unsigned char* bands_ok, int batch, int n, int s,
                                        int n_bands, int wb, int wf, int kmax, int u, int warps,
                                        float* dist2, int* idx, float* rel, void* stream) {
  const int per_block = u * warps;
  if (!plan_in(kBandedPlans, u, warps) || bands_ok == nullptr || !w_ok(wb) || !w_ok(wf) ||
      wf < wb || n_bands < 1 || n % n_bands != 0 || s % n_bands != 0 ||
      (s / n_bands) % per_block != 0 || (n / n_bands) % wb != 0 || n % wf != 0 || kmax < 1 ||
      kmax > 32 || rel == nullptr || reinterpret_cast<uintptr_t>(xyz) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(s / per_block, batch);
  const BandedArgs a{xyz, n, n_bands, bands_ok, Out{cent, s, kmax, dist2, idx, rel}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (u) {
    case 1: return banded_w<1>(wb, wf, grid, warps, st, a);
    case 2: return banded_w<2>(wb, wf, grid, warps, st, a);
  }
  return (int)cudaErrorInvalidValue;
}
