// ball_query_first_k (K10): the exact method's selection for every (radius,
// nsample) spec of a stage in one launch.  Per centre and spec: the first
// nsample points, in point order, whose d2 = (dx*dx + dy*dy) + dz*dz (dx =
// c.x - p.x, each operation rounded to f32, no FMA) is below r2; slots past
// the hit count repeat the first hit; a centre without hits gets an
// all-zero row; nsample may exceed N.
//
// Replaces no Pallas kernel: the JAX package's exact query is XLA's top_k
// over order keys (pointrcnn_tpu/ops/grouping.py::ball_query_multi), and
// the port's plain version of it (ops/cuda_ballquery.py::
// ball_query_first_k_plain) chunks the centres into (centres x N) distance
// blocks and a radix topk a spec.
//
// What bounds it on the H100: the scan's FP32 operations, 3 sub, 3 mul, 2 add
// and a compare a spec per (centre, point) pair up to the point where every
// spec holds its nsample hits, at one a lane a clock (--fmad=false): about
// 0.1 ms for 3DSSD's four stages at batch 4 if no centre stops early (287 M
// pairs).  The table (12 bytes a point) and the indices (4 bytes a slot)
// move in less time.
//
// What the design does about it:
// - a warp a centre, a block kFkWarps centres of one frame: the block stages
//   the frame's table through shared memory in tiles of kFkTile points,
//   double-buffered with cp.async (4-byte copies, so any N and any offset
//   of a frame stage; the copy turns (x, y, z) rows into three arrays, so a
//   lane's reads are conflict-free);
// - in each step a lane takes one point; the nested radii share its
//   distance; per spec a __ballot_sync of d2 < r2 and a __popc of the lanes
//   below give each hit its slot, so hits land in point order;
// - a warp stops testing once every spec holds its nsample hits (the counts
//   come from ballots, so the test is warp-uniform), and the block stops
//   staging once all its warps have;
// - a pass after the scan fills the backfill slots; nothing is read back
//   to the host and nothing allocated.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs: a
// point at the edge of the radius falls on the same side as in the plain
// version.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSpecs = 4;  // ops/cuda_ballquery.py::FIRST_K_SPECS
constexpr int kFkWarps = 16;  // centres a block
constexpr int kFkTile = 1024;
// a coordinate array's stride: 11 mod 32, so the staging copies of 32
// consecutive floats (about 11 points' three coordinates) meet few bank
// conflicts
constexpr int kFkStride = kFkTile + 11;

struct FirstKArgs {
  const float* xyz;
  const float* cent;
  int n, s, nspec, blocks_per_row;
  float r2[kMaxSpecs];
  int ns[kMaxSpecs];
  int* out[kMaxSpecs];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// every thread: its share of the copies of points [first, first + count)
// of the batch row ``tab`` into the three coordinate arrays of ``buf``, as
// one cp.async group
__device__ __forceinline__ void stage_first_k(const float* tab, int first, int count, float* buf) {
  const float* src = tab + 3 * (size_t)first;
  for (int e = threadIdx.x; e < 3 * count; e += blockDim.x) {
    const int p = e / 3, coord = e - 3 * p;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(buf + coord * kFkStride + p)),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(32 * kFkWarps) ball_query_first_k_kernel(FirstKArgs a) {
  __shared__ __align__(16) float stage[2][3 * kFkStride];
  const int b = blockIdx.x / a.blocks_per_row;
  const int row = (blockIdx.x - b * a.blocks_per_row) * kFkWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const bool live = row < a.s;
  const float* tab = a.xyz + (size_t)b * a.n * 3;
  const size_t orow = (size_t)b * a.s + row;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (live) {
    const float* c = a.cent + orow * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  int cnt[kMaxSpecs], first[kMaxSpecs];
#pragma unroll
  for (int i = 0; i < kMaxSpecs; ++i) cnt[i] = first[i] = 0;
  bool done = !live;  // warp-uniform

  const int tiles = (a.n + kFkTile - 1) / kFkTile;
  if (tiles > 0) stage_first_k(tab, 0, min(kFkTile, a.n), stage[0]);
  for (int t = 0; t < tiles; ++t) {
    // the other buffer was last read in the previous tile, behind its barrier
    if (t + 1 < tiles) {
      const int next = (t + 1) * kFkTile;
      stage_first_k(tab, next, min(kFkTile, a.n - next), stage[(t + 1) & 1]);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int base = t * kFkTile, count = min(kFkTile, a.n - base);
    const float* px = stage[t & 1];
    const float* py = px + kFkStride;
    const float* pz = py + kFkStride;
    for (int j = 0; j < count && !done; j += 32) {
      const int k = j + lane;
      const bool valid = k < count;
      const float dx = cx - px[k], dy = cy - py[k], dz = cz - pz[k];
      const float d2 = dx * dx + dy * dy + dz * dz;
      bool more = false;
#pragma unroll
      for (int i = 0; i < kMaxSpecs; ++i) {
        if (i < a.nspec && cnt[i] < a.ns[i]) {
          const unsigned m = __ballot_sync(kFull, valid && d2 < a.r2[i]);
          if (m != 0u) {
            const int slot = cnt[i] + __popc(m & ((1u << lane) - 1u));
            if (((m >> lane) & 1u) && slot < a.ns[i]) a.out[i][orow * a.ns[i] + slot] = base + k;
            if (cnt[i] == 0) first[i] = base + j + __ffs((int)m) - 1;
            cnt[i] += __popc(m);
          }
          more |= cnt[i] < a.ns[i];
        }
      }
      done = !more;
    }
    // every warp of the block done: no more tiles
    if (!__syncthreads_or(!done)) break;
  }
  // a block that stopped early leaves no copy in flight
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kMaxSpecs; ++i) {
    if (i < a.nspec) {
      const int fill = cnt[i] > 0 ? first[i] : 0;
      for (int slot = cnt[i] + lane; slot < a.ns[i]; slot += 32)
        a.out[i][orow * a.ns[i] + slot] = fill;
    }
  }
}

}  // namespace

// xyz (B, N, 3), cent (B, S, 3) f32 -> for each of the nspec (1 to
// kMaxSpecs) specs (r2[i], ns[i]) the int32 selection out[i] (B, S, ns[i])
extern "C" int ball_query_first_k_launch(const float* xyz, const float* cent, int batch, int n,
                                         int s, int nspec, const float* r2, const int* ns,
                                         int* const* out, void* stream) {
  if (batch < 1 || n < 0 || s < 1 || nspec < 1 || nspec > kMaxSpecs)
    return (int)cudaErrorInvalidValue;
  FirstKArgs a{xyz, cent, n, s, nspec, (s + kFkWarps - 1) / kFkWarps, {}, {}, {}};
  for (int i = 0; i < nspec; ++i) {
    if (ns[i] < 1 || out[i] == nullptr) return (int)cudaErrorInvalidValue;
    a.r2[i] = r2[i];
    a.ns[i] = ns[i];
    a.out[i] = out[i];
  }
  if ((long long)a.blocks_per_row * batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_query_first_k_kernel<<<a.blocks_per_row * batch, 32 * kFkWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
