// Furthest point sampling: a row belongs to one warp or a few, several rows
// a block.
//
// Replaces: pointrcnn_tpu/ops/pallas_fps.py::_fps_kernel and
// _fps_kernel_striped (entry furthest_point_sample_pallas).  Same contract:
// the first pick is index 0; each step folds the squared distance to the
// last pick, (dx*dx + dy*dy) + dz*dz, into a running minimum (initialised to
// 1e10) and picks its argmax, the lowest index on ties.
//
// What bounds it on the H100: the chain of npoint-1 dependent steps, not
// bytes or operations.  A step cannot start before the previous pick is
// known, so a row costs (npoint-1) x (one step's latency) however many SMs
// are free; fps_step_probe below times the shortest such step (one warp,
// one point a lane) and chip_smoke.py takes it as the latency term of the
// kernel's bound.
//
// What the design does about it:
// - For N <= 1024 (every row of the eval forward and both training stages)
//   a row belongs to wpr warps, one or four (chosen by shape in
//   ops/cuda_fps.py); each lane keeps its PPL points' coordinates and
//   running minima in registers, point i = lane + 32 * (w + wpr * j) for
//   warp w of the row.  A block holds two one-warp rows or one four-warp
//   row, so 400 RCNN rows or 256 training rows spread over the SMs.
// - A step's argmax needs no block barrier: a lane-local argmax (a tree
//   over rising j with strict >, so the lower index keeps ties), then
//   __reduce_max_sync on the distances' bits (d >= +0.0, so the bits order
//   as the floats do) and __reduce_min_sync over the indices of the lanes
//   holding that maximum (the lowest global index, not the lowest lane).
//   Where a row spans several warps, the warps' winners meet as
//   (key << 32 | ~index) in a double-buffered shared slot behind one named
//   barrier of the row's threads; four warps' slots every lane scans for
//   the largest (measured faster than a second pair of reductions), the
//   32 of a long row go through __reduce_*_sync again.  Four warps a row
//   was the faster plan for rows of 1024 points (a step about 3.5 x the
//   probe's), a warp a row for rows of 512 points or fewer.
// - The winner's coordinates come from the row's copy in shared memory (a
//   lane cannot index its own registers by a run-time j).
// - Padded points (past N, up to PPL * 32 * wpr) hold -1 as running minimum
//   and never win the lane-local argmax against a real point (>= +0.0); a
//   lane with no real point offers key 0 and an index >= N, which loses
//   every tie to a real point.
// - N > 1024 (the exact setting's 16384 and 4096): one row a block of 1024
//   threads, the same single-barrier step, coordinates read from shared
//   memory each step (at 16 points a thread, coordinates and minima would
//   not fit 64 registers).
//
// - 16384 < N <= 131072 (car_2x's 32768-point rows in the exact setting):
//   the row's xyz (384 KB at 32768 points) no longer fits one block's
//   shared memory, so fps_cluster_kernel splits the row over a thread-block
//   cluster of 2, 4 or 8 blocks of 1024 threads, each holding its share
//   (at most 16384 points) in shared memory and its minima in registers.
//   A step is the single-block step on each share (a lane's argmax a scan
//   in ascending index with strict >, then the 32 warps' winners behind one
//   block barrier), then each block publishes its winner (key, index and
//   coordinates) in its own shared memory, one cluster barrier, and every
//   warp reads the blocks' winners through distributed shared memory and
//   takes the largest key, the lowest index on ties.
// - N > 131072: fps_wide_kernel, one block of 1024 threads a row, the first
//   16384 points' coordinates in shared memory, the rest read from global
//   memory (L2) each step, the running minima in a global scratch row.
//
// Compiled with --fmad=false so the distance is not contracted into FMAs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// the warp's largest key, and the lowest index among the lanes holding it
__device__ __forceinline__ void warp_argmax(unsigned& key, int& idx) {
  const unsigned mx = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == mx ? idx : INT_MAX);
  key = mx;
}

template <int PPL, bool REG_XYZ, bool MULTI, int MAXT>
__global__ void __launch_bounds__(MAXT)
    fps_kernel(const float* __restrict__ xyz, int rows, int n, int npoint, int wpr,
               int* __restrict__ out) {
  extern __shared__ float smem[];
  const int stride = 32 * wpr;
  const int padded = PPL * stride;  // points per row in shared memory
  const int rpb = blockDim.x / stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rib = warp / wpr;  // row in block
  const int w = warp - rib * wpr;
  const int row0 = blockIdx.x * rpb;
  const int row = row0 + rib;
  // each row's two slot buffers of wpr (key << 32 | ~index), 8-byte aligned
  unsigned long long* slot =
      reinterpret_cast<unsigned long long*>(smem + rpb * padded * 3 + (rpb * padded * 3) % 2) +
      rib * 2 * wpr;

  // the block's rows, zero-padded to `padded` points each; unpadded rows
  // on a 16-byte boundary (every row of the forward) copy as float4s, so a
  // thread's loads are all in flight at once
  const int nrows = min(rpb, rows - row0);
  const float* src = xyz + (size_t)row0 * n * 3;
  const int count = nrows * n * 3;
  if (padded == n && (reinterpret_cast<size_t>(src) & 15) == 0 && (count & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(smem);
#pragma unroll 4
    for (int t = threadIdx.x; t < count / 4; t += blockDim.x) d4[t] = s4[t];
  } else {
    for (int t = threadIdx.x; t < nrows * padded * 3; t += blockDim.x) {
      const int r = t / (padded * 3), e = t - r * padded * 3;
      smem[t] = e < n * 3 ? src[(size_t)r * n * 3 + e] : 0.f;
    }
  }
  __syncthreads();
  if (row >= rows) return;
  const float* sp = smem + rib * padded * 3;
  int* o = out + (size_t)row * npoint;
  const int base = lane + 32 * w;

  float px[REG_XYZ ? PPL : 1], py[REG_XYZ ? PPL : 1], pz[REG_XYZ ? PPL : 1];
  float dist[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    const int i = base + stride * j;
    if (REG_XYZ) {
      px[j] = sp[3 * i];
      py[j] = sp[3 * i + 1];
      pz[j] = sp[3 * i + 2];
    }
    dist[j] = i < n ? 1e10f : -1.f;
  }

  if (base == 0) o[0] = 0;
  int last = 0;
  for (int step = 1; step < npoint; ++step) {
    const float lx = sp[3 * last], ly = sp[3 * last + 1], lz = sp[3 * last + 2];
    float v[PPL];
    int id[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int i = base + stride * j;
      const float x = REG_XYZ ? px[j] : sp[3 * i];
      const float y = REG_XYZ ? py[j] : sp[3 * i + 1];
      const float z = REG_XYZ ? pz[j] : sp[3 * i + 2];
      const float dx = x - lx, dy = y - ly, dz = z - lz;
      dist[j] = fminf(dist[j], dx * dx + dy * dy + dz * dz);
      v[j] = dist[j];
      id[j] = i;
    }
    // lane-local argmax: a tree over contiguous ranges of j, so the right
    // operand always holds the higher indices and strict > keeps ties low
#pragma unroll
    for (int h = 1; h < PPL; h <<= 1) {
#pragma unroll
      for (int j = 0; j + h < PPL; j += 2 * h) {
        if (v[j + h] > v[j]) {
          v[j] = v[j + h];
          id[j] = id[j + h];
        }
      }
    }
    unsigned key = v[0] < 0.f ? 0u : __float_as_uint(v[0]);
    int idx = id[0];
    warp_argmax(key, idx);
    if (MULTI) {
      // the warps' winners as (key << 32 | ~index): the largest is the
      // largest key, then the lowest index.  Every lane stores the same
      // value (no divergent branch); the buffer alternates by step, so a
      // slot is rewritten only after every warp has passed the next barrier
      unsigned long long* sl = slot + (step & 1) * wpr;
      sl[w] = (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~idx);
      named_barrier(1 + rib, stride);
      if (wpr == 4) {
        unsigned long long best = sl[0];
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          if (sl[q] > best) best = sl[q];
        }
        idx = ~static_cast<int>(static_cast<unsigned>(best));
      } else {
        const unsigned long long e = lane < wpr ? sl[lane] : 0x80000000ull;  // key 0, INT_MAX
        key = static_cast<unsigned>(e >> 32);
        idx = ~static_cast<int>(static_cast<unsigned>(e));
        warp_argmax(key, idx);
      }
    }
    last = idx;
    if (base == 0) o[step] = last;
  }
}

// points of a wide row whose coordinates stay in shared memory (a cluster
// block's share at most)
constexpr int kWideSmemPoints = 16384;

// a cluster block's winner of a step: (key << 32 | ~index) and coordinates
struct alignas(32) Winner {
  unsigned long long kv;
  float x, y, z;
};

// One row a cluster of CS blocks of 1024 threads; block r holds points
// [r m, r m + m) of the row, m = (n / CS rounded up to 4) <= 16384; thread
// t takes the block's points t + 1024 j, j < 16.
template <int CS>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(1024)
    fps_cluster_kernel(const float* __restrict__ xyz, int n, int m, int npoint,
                       int* __restrict__ out) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];  // 3 m floats, then the warp slots, then the winners
  constexpr int PPL = kWideSmemPoints / 1024;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.x / CS;
  const int p0 = rank * m;
  const int cnt = max(0, min(m, n - p0));
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(smem + 3 * m);
  Winner* win = reinterpret_cast<Winner*>(slot + 2 * 32);
  const float* src = xyz + (size_t)row * n * 3;
  const float* share = src + 3 * (size_t)p0;
  if ((reinterpret_cast<size_t>(share) & 15) == 0 && (cnt & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(share);
    float4* d4 = reinterpret_cast<float4*>(smem);
    for (int t = tid; t < 3 * cnt / 4; t += 1024) d4[t] = s4[t];
  } else {
    for (int t = tid; t < 3 * cnt; t += 1024) smem[t] = share[t];
  }
  float dist[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) dist[j] = tid + 1024 * j < cnt ? 1e10f : -1.f;
  float lx = src[0], ly = src[1], lz = src[2];  // the first pick, point 0
  int* o = out + (size_t)row * npoint;
  if (rank == 0 && tid == 0) o[0] = 0;
  __syncthreads();
  for (int step = 1; step < npoint; ++step) {
    float best = -1.f;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int i = tid + 1024 * j;
      if (i < cnt) {
        const float dx = smem[3 * i] - lx, dy = smem[3 * i + 1] - ly, dz = smem[3 * i + 2] - lz;
        dist[j] = fminf(dist[j], dx * dx + dy * dy + dz * dz);
        if (dist[j] > best) {  // ascending i: strict > keeps the lowest index on ties
          best = dist[j];
          bi = p0 + i;
        }
      }
    }
    unsigned key = best < 0.f ? 0u : __float_as_uint(best);
    int idx = bi;
    warp_argmax(key, idx);
    unsigned long long* sl = slot + (step & 1) * 32;
    if (lane == 0) sl[warp] = (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~idx);
    __syncthreads();
    unsigned long long e = sl[lane];
    key = static_cast<unsigned>(e >> 32);
    idx = ~static_cast<int>(static_cast<unsigned>(e));
    warp_argmax(key, idx);
    // this block's winner, published for the cluster (double-buffered by
    // step: a buffer is rewritten only after every block has passed the
    // next step's cluster barrier, so after every read of it)
    if (tid == 0) {
      Winner w;
      w.kv = (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~idx);
      const bool real = idx >= p0 && idx < p0 + cnt;
      w.x = real ? smem[3 * (idx - p0)] : 0.f;
      w.y = real ? smem[3 * (idx - p0) + 1] : 0.f;
      w.z = real ? smem[3 * (idx - p0) + 2] : 0.f;
      win[step & 1] = w;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    // every warp: lane l < CS reads block l's winner, the largest key (the
    // lowest index on ties) wins; its lane hands out the coordinates
    Winner w{};
    if (lane < CS) w = *cluster.map_shared_rank(win + (step & 1), lane);
    key = lane < CS ? static_cast<unsigned>(w.kv >> 32) : 0u;
    idx = lane < CS ? ~static_cast<int>(static_cast<unsigned>(w.kv)) : INT_MAX;
    const unsigned mine = key;
    const int my_idx = idx;
    warp_argmax(key, idx);
    const int from = __ffs(__ballot_sync(0xffffffffu, mine == key && my_idx == idx)) - 1;
    lx = __shfl_sync(0xffffffffu, w.x, from);
    ly = __shfl_sync(0xffffffffu, w.y, from);
    lz = __shfl_sync(0xffffffffu, w.z, from);
    if (rank == 0 && tid == 0) o[step] = idx;
  }
  // no block leaves while another may still read its winners
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One row a block of 1024 threads, n > kWideSmemPoints; thread t takes
// points t + 1024 j, their minima in mind (rows, n) f32.
__global__ void __launch_bounds__(1024)
    fps_wide_kernel(const float* __restrict__ xyz, int n, int npoint, int* __restrict__ out,
                    float* __restrict__ mind) {
  extern __shared__ float smem[];  // 3 * kWideSmemPoints floats, then the slots
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(smem + 3 * kWideSmemPoints);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.x;
  const float* src = xyz + (size_t)row * n * 3;
  int* o = out + (size_t)row * npoint;
  float* md = mind + (size_t)row * n;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(smem);
    for (int t = tid; t < 3 * kWideSmemPoints / 4; t += 1024) d4[t] = s4[t];
  } else {
    for (int t = tid; t < 3 * kWideSmemPoints; t += 1024) smem[t] = src[t];
  }
  for (int i = tid; i < n; i += 1024) md[i] = 1e10f;
  __syncthreads();
  if (tid == 0) o[0] = 0;
  int last = 0;
  for (int step = 1; step < npoint; ++step) {
    const float* lp = last < kWideSmemPoints ? smem + 3 * last : src + 3 * (size_t)last;
    const float lx = lp[0], ly = lp[1], lz = lp[2];
    float best = -1.f;
    int bi = INT_MAX;
    auto visit = [&](int i, float& dj) {
      const float* p = i < kWideSmemPoints ? smem + 3 * i : src + 3 * (size_t)i;
      const float dx = p[0] - lx, dy = p[1] - ly, dz = p[2] - lz;
      dj = fminf(dj, dx * dx + dy * dy + dz * dz);
      if (dj > best) {  // ascending i: strict > keeps the lowest index on ties
        best = dj;
        bi = i;
      }
    };
    for (int i = tid; i < n; i += 1024) {
      float dj = md[i];
      visit(i, dj);
      md[i] = dj;
    }
    unsigned key = best < 0.f ? 0u : __float_as_uint(best);
    int idx = bi;
    warp_argmax(key, idx);
    // the warps' winners as (key << 32 | ~index), double-buffered by step
    unsigned long long* sl = slot + (step & 1) * 32;
    if (lane == 0) sl[warp] = (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~idx);
    __syncthreads();
    const unsigned long long e = sl[lane];
    key = static_cast<unsigned>(e >> 32);
    idx = ~static_cast<int>(static_cast<unsigned>(e));
    warp_argmax(key, idx);
    last = idx;
    if (tid == 0) o[step] = last;
  }
}

template <int PPL, bool REG_XYZ, bool MULTI, int MAXT>
cudaError_t launch(const float* xyz, int rows, int n, int npoint, int* out, int wpr, int rpb,
                   cudaStream_t s) {
  const int floats = rpb * PPL * 32 * wpr * 3;
  const int smem = (floats + floats % 2) * (int)sizeof(float) + 2 * rpb * wpr * 8;
  auto kernel = fps_kernel<PPL, REG_XYZ, MULTI, MAXT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + rpb - 1) / rpb, 32 * wpr * rpb, smem, s>>>(xyz, rows, n, npoint, wpr, out);
  return cudaGetLastError();
}

// One warp, one point a lane, `steps` dependent FPS steps and nothing else:
// the distance, the min, the warp argmax by redux.sync and the winner's
// coordinates by shuffle.  Its time per step is the least a step of any
// design can take.
__global__ void fps_step_probe_kernel(const float* __restrict__ xyz, int steps,
                                      int* __restrict__ out) {
  const int lane = threadIdx.x;
  const float x = xyz[3 * lane], y = xyz[3 * lane + 1], z = xyz[3 * lane + 2];
  float dist = 1e10f;
  float lx = __shfl_sync(0xffffffffu, x, 0), ly = __shfl_sync(0xffffffffu, y, 0),
        lz = __shfl_sync(0xffffffffu, z, 0);
  int last = 0;
  for (int s = 0; s < steps; ++s) {
    const float dx = x - lx, dy = y - ly, dz = z - lz;
    dist = fminf(dist, dx * dx + dy * dy + dz * dz);
    unsigned key = __float_as_uint(dist);
    last = lane;
    warp_argmax(key, last);
    lx = __shfl_sync(0xffffffffu, x, last);
    ly = __shfl_sync(0xffffffffu, y, last);
    lz = __shfl_sync(0xffffffffu, z, last);
  }
  if (lane == 0) out[0] = last;
}

template <int CS>
cudaError_t launch_cluster(const float* xyz, int rows, int n, int npoint, int* out,
                           cudaStream_t s) {
  const int m = ((n + CS - 1) / CS + 3) / 4 * 4;
  const int smem = 3 * m * (int)sizeof(float) + 2 * 32 * 8 + 2 * (int)sizeof(Winner);
  auto kernel = fps_cluster_kernel<CS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows * CS, 1024, smem, s>>>(xyz, n, m, npoint, out);
  return cudaGetLastError();
}

// The cluster size for rows of n > 16384 points: the least of 2, 4, 8
// whose shares hold at most 16384 points; 0 past 131072 (the global-memory
// kernel).
int cluster_size(int n) {
  for (int cs = 2; cs <= 8; cs *= 2) {
    if (((n + cs - 1) / cs + 3) / 4 * 4 <= kWideSmemPoints) return cs;
  }
  return 0;
}

}  // namespace

// xyz (rows, n, 3) f32 -> out (rows, npoint) int32.  (wpr warps a row, rpb
// rows a block), as ops/cuda_fps.py::plan chooses them: (1, 2) or (4, 1)
// for n <= 1024, (32, 1) for n > 1024 (up to 16384).
extern "C" int fps_launch(const float* xyz, int rows, int n, int npoint, int* out, int wpr,
                          int rpb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || n < 1 || npoint < 1 || npoint > n || n > 16384) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 1024 && wpr == 32 && rpb == 1) {
    const int need = (n + 1023) / 1024;
    if (need <= 2) return (int)launch<2, false, true, 1024>(xyz, rows, n, npoint, out, 32, 1, s);
    if (need <= 4) return (int)launch<4, false, true, 1024>(xyz, rows, n, npoint, out, 32, 1, s);
    if (need <= 8) return (int)launch<8, false, true, 1024>(xyz, rows, n, npoint, out, 32, 1, s);
    return (int)launch<16, false, true, 1024>(xyz, rows, n, npoint, out, 32, 1, s);
  }
  if (n <= 1024 && wpr == 4 && rpb == 1) {
    const int need = (n + 127) / 128;
    if (need <= 1) return (int)launch<1, true, true, 1024>(xyz, rows, n, npoint, out, 4, 1, s);
    if (need <= 2) return (int)launch<2, true, true, 1024>(xyz, rows, n, npoint, out, 4, 1, s);
    if (need <= 4) return (int)launch<4, true, true, 1024>(xyz, rows, n, npoint, out, 4, 1, s);
    return (int)launch<8, true, true, 512>(xyz, rows, n, npoint, out, 4, 1, s);
  }
  if (n <= 1024 && wpr == 1 && rpb == 2) {
    const int need = (n + 31) / 32;
    if (need <= 1) return (int)launch<1, true, false, 1024>(xyz, rows, n, npoint, out, 1, 2, s);
    if (need <= 2) return (int)launch<2, true, false, 1024>(xyz, rows, n, npoint, out, 1, 2, s);
    if (need <= 4) return (int)launch<4, true, false, 1024>(xyz, rows, n, npoint, out, 1, 2, s);
    if (need <= 8) return (int)launch<8, true, false, 512>(xyz, rows, n, npoint, out, 1, 2, s);
    if (need <= 16) return (int)launch<16, true, false, 256>(xyz, rows, n, npoint, out, 1, 2, s);
    return (int)launch<32, true, false, 256>(xyz, rows, n, npoint, out, 1, 2, s);
  }
  return (int)cudaErrorInvalidValue;
}

// xyz (rows, n, 3) f32 with n > 16384 -> out (rows, npoint) int32: a
// cluster of blocks a row up to 131072 points, else a block of 1024 threads
// a row with its minima in mind, a (rows, n) f32 scratch.
extern "C" int fps_wide_launch(const float* xyz, int rows, int n, int npoint, int* out,
                               float* mind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cs = cluster_size(n);
  if (rows < 1 || n <= kWideSmemPoints || npoint < 1 || npoint > n || !mind) {
    return (int)cudaErrorInvalidValue;
  }
  if (cs == 2) return (int)launch_cluster<2>(xyz, rows, n, npoint, out, s);
  if (cs == 4) return (int)launch_cluster<4>(xyz, rows, n, npoint, out, s);
  if (cs == 8) return (int)launch_cluster<8>(xyz, rows, n, npoint, out, s);
  const int smem = 3 * kWideSmemPoints * (int)sizeof(float) + 2 * 32 * 8;
  auto kernel = fps_wide_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, 1024, smem, s>>>(xyz, n, npoint, out, mind);
  return (int)cudaGetLastError();
}

// The latency probe: one warp over xyz (32, 3) f32, `steps` steps; out[0]
// the last pick (kept so the chain is not optimised away).
extern "C" int fps_step_probe(const float* xyz, int steps, int* out, void* stream) {
  fps_step_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(xyz, steps, out);
  return (int)cudaGetLastError();
}
