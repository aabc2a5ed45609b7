// Neighbourhood gather (QueryAndGroup): the forward (K4), runs of output rows
// assembled in shared memory and stored in whole sectors, and its backward
// (K8), a bucketed, order-keeping scatter-add.
//
// Forward.  Replaces: pointrcnn_tpu/ops/pallas_gather.py::_make_fwd_kernel
// (entry group_points_pallas, table from _pack_table).  Same contract: for
// row (b, s, k) with j = idx[b, s, k] the output is
//   [ bf16((hi(x_j) + lo(x_j)) - c_s),  bf16(features[j]) ]
// where hi is x's f32 bit pattern truncated to its top 16 bits and
// lo = bf16(x - hi): the TPU kernel gathers that hi/lo pair through a bf16
// one-hot matmul, and this kernel rebuilds it bit for bit.  Features arrive
// in f32 or bf16; an f32 value is rounded to nearest even in the kernel, as
// Tensor.to(torch.bfloat16) rounds it.
//
// What bounds it on the H100: device-memory bytes.  At RPN SA2 of the rpn
// step (16 x 1024 centroids x 32 neighbours x (3 + 96) bf16) the output is
// 104 MB; the reads are random rows of a 6-25 MB feature table that stays in
// L2.
//
// What the design does about it: no FLOPs on a one-hot; a block owns a run of
// R consecutive output rows (R a multiple of 8), so the run is one
// contiguous, 16-byte-aligned span of the output whatever the parity of
// 3 + C.  The block reads the run's R indices in one load (an index outside
// [0, N) prints and traps: the check costs the host nothing), gathers each
// feature row with 16-byte loads into the span's image in shared memory, at
// its output offset, and then stores the image with 16-byte coalesced
// streaming stores (evict-first, so the table keeps its place in L2), so
// every output sector is written whole, once.  A row width that
// is not a multiple of 8 channels, or a ragged last run, takes a scalar path
// for the part that does not fit.
//
// Backward.  Replaces: pointrcnn_tpu/ops/pallas_gather.py::_make_bwd_kernel
// (_bwd_pallas_call, custom VJP _group_bwd).  For a bf16 cotangent ct
// (B, S, K, 3 + C):
//   dtable[b, n, :] = sum over (s, k) with idx[b, s, k] == n of f32(ct[b, s, k, :])
//   dcent[b, s, :]  = -sum over k of f32(ct[b, s, k, 0:3])
// The TPU accumulates dtable as a one-hot^T @ ct matmul per centroid chunk.
//
// What bounds it: device-memory bytes (read ct once, write dtable once);
// at RPN SA2 in training ct is 104 MB.
//
// What the design does about it: no atomics on floats, so the sums are
// deterministic and in ascending position p = s * K + k per table row, the
// order of a sequential index_add_.  Each cotangent row is read once, in
// 16-byte pieces, and each index a bounded number of times.  Four kernels:
//   1. count (skipped where a batch row is one chunk): integer counts of each
//      chunk's positions per bucket, a bucket being a tile of table rows
//      that fits in shared memory;
//   2. place: a stable partition of each batch row's positions by bucket.
//      A warp ranks each step of 32 positions among same-bucket peers with
//      __match_any_sync and advances a (bucket, warp) cursor that starts
//      after earlier chunks' and warps' entries;
//   3. accumulate: a block per (bucket, b, channel chunk of at most 1024)
//      walks its bucket's list, which is in ascending p: it stages the
//      chunk of the listed cotangent rows in shared memory (the next
//      sub-stage's pieces in flight while this one is added), and thread c
//      adds channel c of the chunk into the tile's f32 sum of the row, in
//      list order (no two threads touch one sum); the first chunk's blocks
//      copy each row's first three channels to a small side buffer;
//   4. dcent: a thread per (b, s, coordinate) sums that buffer, k ascending.
//
// Compiled with --fmad=false like the other geometry kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

// ---------------------------------------------------------------- forward

constexpr int kFwdThreads = 128;
// a run's shared-memory image is at most this many bytes, and at most
// kMaxRun rows (multiples of 8)
constexpr int kRunBytes = 16 * 1024;
constexpr int kMaxRun = 64;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight channels of a feature row as bf16, from a 16-byte-aligned address
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) { return __float2bfloat16_rn(x); }

// eight bf16 (v, element 0 in v.x's low half) into the image at element e:
// four 4-byte stores where e is even, else a 2-byte store, three 4-byte
// stores of neighbouring halves, a 2-byte store
__device__ __forceinline__ void put8(__nv_bfloat16* img, int e, uint4 v) {
  if ((e & 1) == 0) {
    uint32_t* w = reinterpret_cast<uint32_t*>(img + e);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    uint16_t* h = reinterpret_cast<uint16_t*>(img + e);
    uint32_t* w = reinterpret_cast<uint32_t*>(img + e + 1);
    h[0] = (uint16_t)(v.x & 0xFFFFu);
    w[0] = __funnelshift_r(v.x, v.y, 16);
    w[1] = __funnelshift_r(v.y, v.z, 16);
    w[2] = __funnelshift_r(v.z, v.w, 16);
    h[7] = (uint16_t)(v.w >> 16);
  }
}

// grid: one block a run of `run` output rows (the last may be ragged);
// dynamic shared memory: the run's image, run * (3 + c) bf16, rounded to 16
// bytes.  vec: c % 8 == 0 and feats 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    group_gather_kernel(const float* __restrict__ xyz, const T* __restrict__ feats,
                        const float* __restrict__ cent, const int* __restrict__ idx, int n,
                        int sk, int k, int c, int rows, int run, int vec,
                        __nv_bfloat16* __restrict__ out) {
  __shared__ int src[kMaxRun];  // b * n + j of each row of the run
  extern __shared__ uint4 img4[];
  __nv_bfloat16* img = reinterpret_cast<__nv_bfloat16*>(img4);
  const int tid = threadIdx.x;
  const int cout = 3 + c;
  const int r0 = blockIdx.x * run;
  const int nr = min(run, rows - r0);

  // 1. the run's indices, checked: a bad index stops the kernel loudly
  if (tid < nr) {
    const int row = r0 + tid;
    const int j = idx[row];
    const int b = row / sk;
    if ((unsigned)j >= (unsigned)n) {
      printf("group_gather: index %d outside [0, %d) at (batch %d, centroid %d, neighbour %d)\n",
             j, n, b, (row - b * sk) / k, row % k);
      __trap();
    }
    src[tid] = b * n + j;
  }
  __syncthreads();

  // 2a. relative coordinates, bit for bit the TPU's hi/lo recipe
  for (int t = tid; t < nr * 3; t += kFwdThreads) {
    const int i = t / 3, d = t - 3 * i;
    const float x = xyz[(long long)src[i] * 3 + d];
    const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
    const float lo = __bfloat162float(__float2bfloat16_rn(x - hi));
    img[i * cout + d] = __float2bfloat16_rn((hi + lo) - cent[(long long)((r0 + i) / k) * 3 + d]);
  }
  // 2b. feature rows into the image at their output offsets
  if (vec) {
    const int ppr = c >> 3;  // pieces a row
    // item t is (row t / ppr, piece t % ppr); stepping (i, q) by the block's
    // width keeps the division out of the loop
    int i = tid / ppr, q = tid - (tid / ppr) * ppr;
    const int di = kFwdThreads / ppr, dq = kFwdThreads - di * ppr;
    for (int t = tid; t < nr * ppr; t += kFwdThreads) {
      put8(img, i * cout + 3 + q * 8, load8(feats + (long long)src[i] * c + q * 8));
      i += di;
      q += dq;
      if (q >= ppr) {
        q -= ppr;
        ++i;
      }
    }
  } else {
    for (int t = tid; t < nr * c; t += kFwdThreads) {
      const int i = t / c, ch = t - i * c;
      img[i * cout + 3 + ch] = to_bf16(feats[(long long)src[i] * c + ch]);
    }
  }
  __syncthreads();

  // 3. the span: whole 16-byte pieces (all of it unless the run is ragged),
  // then the ragged tail's elements
  const int n_el = nr * cout;
  const int n_vec = n_el >> 3;
  __nv_bfloat16* dst = out + (long long)r0 * cout;
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int t = tid; t < n_vec; t += kFwdThreads) __stcs(dst4 + t, img4[t]);
  for (int t = (n_vec << 3) + tid; t < n_el; t += kFwdThreads) dst[t] = img[t];
}

// ---------------------------------------------------------------- backward

// positions a count or place block takes, 8 a thread (a warp's 256 in
// order)
constexpr int kChunkThreads = 256;
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kPerLane = 8;
constexpr int kChunk = kChunkThreads * kPerLane;
// buckets of a batch row at most; bstart holds kMaxBuckets + 1 ints a row
constexpr int kMaxBuckets = 128;
// a bucket's tile: about kTileBytes of f32 sums (more rows where N /
// kMaxBuckets needs them)
constexpr int kTileBytes = 16 * 1024;
// the accumulate block: a thread per channel; list entries kStage at a
// time, in sub-stages of at most kMaxSub entries whose rows fit kStageBytes
// of shared memory and kPrefetch 16-byte pieces a thread
constexpr int kStage = 1024;
constexpr int kMaxSub = 64;
constexpr int kStageBytes = 16 * 1024;
constexpr int kPrefetch = 2;

// 1. count: grid (chunks, B); cnt[b, chunk, t] = positions of the chunk in
// bucket t = idx / tile_rows
__global__ void __launch_bounds__(kChunkThreads)
    gather_bwd_count_kernel(const int* __restrict__ idx, int sk, int tile_rows, int nb,
                            int* __restrict__ cnt) {
  __shared__ int hist[kMaxBuckets];
  const int tid = threadIdx.x;
  const int c = blockIdx.x, b = blockIdx.y;
  for (int t = tid; t < nb; t += kChunkThreads) hist[t] = 0;
  const int* bidx = idx + (long long)b * sk + c * kChunk;
  const int len = min(kChunk, sk - c * kChunk);
  int j[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int p = e * kChunkThreads + tid;
    j[e] = p < len ? bidx[p] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    if (j[e] >= 0) atomicAdd(&hist[j[e] / tile_rows], 1);
  __syncthreads();
  for (int t = tid; t < nb; t += kChunkThreads)
    cnt[((long long)b * gridDim.x + c) * nb + t] = hist[t];
}

// 2. place: grid (chunks, B).  list[b, :] = the batch row's positions p,
// bucket major, p ascending inside a bucket, each packed as
// (p << shift) | (idx[p] - t * tile_rows); bstart[b, t] = bucket t's first
// entry, bstart[b, nb] = sk.  A warp ranks its step's 32 positions among
// their bucket peers (lane order is position order), per (bucket, warp)
// cursor; the cursors start where earlier chunks' and warps' entries end
// (the count kernel's cnt; a batch row of one chunk counts its own).
__global__ void __launch_bounds__(kChunkThreads)
    gather_bwd_place_kernel(const int* __restrict__ idx, const int* __restrict__ cnt, int sk,
                            int tile_rows, int nb, int shift, int* __restrict__ list,
                            int* __restrict__ bstart) {
  __shared__ int cell[kMaxBuckets * kChunkWarps];  // (bucket, warp)
  __shared__ int start[kMaxBuckets];
  __shared__ int before[kMaxBuckets];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  for (int i = tid; i < nb * kChunkWarps; i += kChunkThreads) cell[i] = 0;
  // this warp's positions, and their ranks inside (bucket, warp)
  const int base = c * kChunk + w * 32 * kPerLane;
  const int* bidx = idx + (long long)b * sk;
  int packed[kPerLane], bucket[kPerLane], rank[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int p = base + e * 32 + lane;
    const int j = p < sk ? bidx[p] : -1;
    bucket[e] = j >= 0 ? j / tile_rows : -1;
    packed[e] = j >= 0 ? (p << shift) | (j - bucket[e] * tile_rows) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int t = bucket[e];
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    const int leader = __ffs(peers) - 1;
    int prev = 0;
    if (t >= 0 && lane == leader) {
      prev = cell[t * kChunkWarps + w];
      cell[t * kChunkWarps + w] = prev + __popc(peers);
    }
    rank[e] = __shfl_sync(0xffffffffu, prev, leader) + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();
  // each bucket's total over the batch row, and its count in earlier chunks
  for (int t = tid; t < nb; t += kChunkThreads) {
    int total = 0, earlier = 0;
    if (nchunks == 1) {
      for (int ww = 0; ww < kChunkWarps; ++ww) total += cell[t * kChunkWarps + ww];
    } else {
      const int* ct = cnt + (long long)b * nchunks * nb + t;
#pragma unroll 16
      for (int cc = 0; cc < nchunks; ++cc) {
        const int v = ct[(long long)cc * nb];
        total += v;
        earlier += cc < c ? v : 0;
      }
    }
    start[t] = total;
    before[t] = earlier;
  }
  __syncthreads();
  if (w == 0) {  // exclusive scan of the totals over buckets: bucket starts
    constexpr int kPer = kMaxBuckets / 32;
    int v[kPer], sum = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = lane * kPer + e;
      v[e] = t < nb ? start[t] : 0;
      sum += v[e];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    int run = incl - sum;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = lane * kPer + e;
      if (t < nb) start[t] = run;
      run += v[e];
    }
  }
  __syncthreads();
  // (bucket, warp) cursors: the bucket's start, earlier chunks, earlier warps
  for (int t = tid; t < nb; t += kChunkThreads) {
    int o = start[t] + before[t];
#pragma unroll
    for (int ww = 0; ww < kChunkWarps; ++ww) {
      const int v = cell[t * kChunkWarps + ww];
      cell[t * kChunkWarps + ww] = o;
      o += v;
    }
    if (c == 0) bstart[b * (kMaxBuckets + 1) + t] = start[t];
  }
  if (c == 0 && tid == 0) bstart[b * (kMaxBuckets + 1) + nb] = sk;
  __syncthreads();
  int* blist = list + (long long)b * sk;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    if (bucket[e] >= 0) blist[cell[bucket[e] * kChunkWarps + w] + rank[e]] = packed[e];
}

// 3. accumulate: grid (nb, B, channel chunks), a thread per channel of the
// chunk, channels [c0, c0 + cw) with c0 = 1024 z.  The block walks its
// bucket's list, which is in ascending p, a sub-stage of `sub` entries at a
// time: the chunk of the entries' cotangent rows is copied into shared
// memory in 16-byte pieces (the next sub-stage's pieces are loaded into
// registers while this one is added), then thread c adds channel c of each
// staged row, in list order, onto its tile row's sum (acc[tile_rows][cw]
// f32 in shared memory; a run of entries on one row adds in a register).
// The first chunk's blocks copy the first three channels of every
// cotangent row to rel (B, sk, 3) bf16 on the way, for dcent.  Every tile
// row of dtable is written once, a row with no entries as zeros.
__global__ void __launch_bounds__(1024)
    gather_bwd_accumulate_kernel(const int* __restrict__ list, const int* __restrict__ bstart,
                                 const __nv_bfloat16* __restrict__ ct, int n, int sk, int cout,
                                 int tile_rows, int shift, int sub, float* __restrict__ dtable,
                                 __nv_bfloat16* __restrict__ rel) {
  const int c0 = blockIdx.z * 1024;
  const int cw = min(1024, cout - c0);
  extern __shared__ uint4 dyn[];
  __shared__ int ent[kStage];     // the stage's list entries
  __shared__ int soff[kMaxSub];   // byte offset of a staged row's channel 0
  __shared__ int srow[kMaxSub];   // its tile row
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int t = blockIdx.x, b = blockIdx.y;
  const int r0 = t * tile_rows;
  const int rows = min(tile_rows, n - r0);
  const int cps = (2 * cw + 15) / 16 + 1;  // 16-byte pieces a staged row
  uint4* staging = dyn;
  float* acc = reinterpret_cast<float*>(staging + sub * cps);
  for (int i = tid; i < rows * cw; i += nthr) acc[i] = 0.0f;

  const int m0 = bstart[b * (kMaxBuckets + 1) + t], m1 = bstart[b * (kMaxBuckets + 1) + t + 1];
  const int* blist = list + (long long)b * sk;
  const char* bct = reinterpret_cast<const char*>(ct + (long long)b * sk * cout);
  __nv_bfloat16* brel = rel + (long long)b * sk * 3;
  const int mask = (1 << shift) - 1;
  // piece tid + nthr * i of a sub-stage is (entry, piece) = (pe + i * de
  // + carries, pj + i * dj)
  const int pe = tid / cps, pj = tid - (tid / cps) * cps;
  const int de = nthr / cps, dj = nthr - de * cps;

  for (int m = m0; m < m1; m += kStage) {
    const int len = min(kStage, m1 - m);
    __syncthreads();  // the previous stage is consumed
    for (int i = tid; i < len; i += nthr) ent[i] = blist[m + i];
    __syncthreads();
    uint4 x[kPrefetch];
    auto prefetch = [&](int lo) {
      const int ne = min(sub, len - lo);
      int e = pe, j = pj;
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        if (e < ne) {
          const char* row = bct + ((long long)(ent[lo + e] >> shift) * cout + c0) * 2;
          const uintptr_t first = reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)15;
          const uintptr_t last = reinterpret_cast<uintptr_t>(row + 2 * cw - 1) & ~(uintptr_t)15;
          if (first + 16 * j <= last) x[i] = __ldg(reinterpret_cast<const uint4*>(first + 16 * j));
        }
        e += de;
        j += dj;
        if (j >= cps) {
          j -= cps;
          ++e;
        }
      }
    };
    prefetch(0);
    for (int lo = 0; lo < len; lo += sub) {
      const int ne = min(sub, len - lo);
      __syncthreads();  // the previous sub-stage is added
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i)
        if (tid + nthr * i < ne * cps) staging[tid + nthr * i] = x[i];
      if (tid < ne) {
        const int v = ent[lo + tid];
        const char* row = bct + ((long long)(v >> shift) * cout + c0) * 2;
        soff[tid] = tid * cps * 16 + (int)(reinterpret_cast<uintptr_t>(row) & 15);
        srow[tid] = v & mask;
      }
      __syncthreads();
      if (lo + sub < len) prefetch(lo + sub);  // in flight while this one adds
      const char* stg = reinterpret_cast<const char*>(staging);
      for (int i = tid; c0 == 0 && i < 3 * ne; i += nthr) {
        const int e = i / 3, j = i - 3 * e;
        brel[(long long)(ent[lo + e] >> shift) * 3 + j] =
            *reinterpret_cast<const __nv_bfloat16*>(stg + soff[e] + 2 * j);
      }
      if (tid < cw) {
        int cur = -1;  // the tile row whose running sum `val` holds
        float val = 0.0f;
        for (int e = 0; e < ne; ++e) {
          const float y = __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(stg + soff[e] + 2 * tid));
          const int r = srow[e];
          if (r != cur) {
            if (cur >= 0) acc[cur * cw + tid] = val;
            val = acc[r * cw + tid];
            cur = r;
          }
          val += y;
        }
        if (cur >= 0) acc[cur * cw + tid] = val;
      }
    }
  }
  __syncthreads();
  float* out = dtable + ((long long)b * n + r0) * cout + c0;
  if (cw == cout) {
    for (int i = tid; i < rows * cout; i += nthr) out[i] = acc[i];
  } else {
    for (int i = tid; i < rows * cw; i += nthr) out[(long long)(i / cw) * cout + i % cw] = acc[i];
  }
}

// 4. dcent[b, s, j] = -sum_k rel[b, s, k, j], j < 3, k ascending: a thread
// per (b, s, j)
__global__ void gather_bwd_dcent_kernel(const __nv_bfloat16* __restrict__ rel,
                                        long long bs_total, int k, float* __restrict__ dcent) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bs_total * 3) return;
  const long long bs = i / 3;
  const __nv_bfloat16* r = rel + bs * k * 3 + (i - bs * 3);
  float sum = 0.0f;
  for (int kk = 0; kk < k; ++kk) sum += __bfloat162float(r[kk * 3]);
  dcent[i] = -sum;
}

int bits_for(int x) {  // least s with x <= 2^s
  int s = 0;
  while ((1LL << s) < x) ++s;
  return s;
}

// K8's plan: rows a bucket's tile, buckets a batch row, position chunks,
// and the workspace's ints
struct BwdPlan {
  int tile_rows, nb, nchunks, shift;
  long long list, bstart, cnt, rel, total;
};

BwdPlan bwd_plan(int batch, int n, long long sk, int cout) {
  BwdPlan p;
  int tile = kTileBytes / ((cout < 1024 ? cout : 1024) * 4);  // a channel chunk's sums
  const int min_rows = (n + kMaxBuckets - 1) / kMaxBuckets;
  tile = tile < min_rows ? min_rows : tile;
  tile = tile < 1 ? 1 : (tile > n ? n : tile);
  p.tile_rows = tile;
  p.nb = (n + tile - 1) / tile;
  p.nchunks = (int)((sk + kChunk - 1) / kChunk);
  p.shift = bits_for(tile);
  p.list = (long long)batch * sk;
  p.bstart = (long long)batch * (kMaxBuckets + 1);
  p.cnt = (long long)batch * p.nchunks * p.nb;
  p.rel = ((long long)batch * sk * 3 + 1) / 2;  // bf16 pairs
  p.total = p.list + p.bstart + p.cnt + p.rel;
  return p;
}

// K4's launch for features of type T
template <typename T>
int launch_forward(const float* xyz, const void* feats, const float* cent, const int* idx,
                   int n, int s, int k, int c, long long rows, int run, size_t smem, int vec,
                   void* out, cudaStream_t st) {
  auto kern = group_gather_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)((rows + run - 1) / run), kFwdThreads, smem, st>>>(
      xyz, static_cast<const T*>(feats), cent, idx, n, s * k, k, c, (int)rows, run, vec,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (batch, n, 3) f32; feats (batch, n, c) f32 (feats_bf16 = 0) or bf16
// (1); cent (batch, s, 3) f32; idx (batch, s, k) int32; out (batch, s, k,
// 3 + c) bf16, 16-byte aligned.  An index outside [0, n) traps in the kernel.
extern "C" int group_gather_launch(const float* xyz, const void* feats, int feats_bf16,
                                   const float* cent, const int* idx, int batch, int n, int s,
                                   int k, int c, void* out, void* stream) {
  const long long rows = (long long)batch * s * k;
  if (batch <= 0 || n <= 0 || c < 0 || rows + kMaxRun >= (1LL << 31) ||
      (long long)batch * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int cout = 3 + c;
  int run = kRunBytes / (cout * 2) / 8 * 8;
  run = run < 8 ? 8 : (run > kMaxRun ? kMaxRun : run);
  const size_t smem = ((size_t)run * cout * 2 + 15) / 16 * 16;
  const int vec = c % 8 == 0 && c > 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return feats_bf16 ? launch_forward<__nv_bfloat16>(xyz, feats, cent, idx, n, s, k, c, rows,
                                                    run, smem, vec, out, st)
                    : launch_forward<float>(xyz, feats, cent, idx, n, s, k, c, rows, run, smem,
                                            vec, out, st);
}

// The int32 workspace K8 needs at a shape.
extern "C" long long group_gather_bwd_workspace_ints(int batch, int n, int s, int k, int cout) {
  return bwd_plan(batch, n, (long long)s * k, cout).total;
}

// ct: (batch, s, k, cout) bf16; idx: (batch, s, k) int32 in [0, n) (the
// forward checked them); dtable: (batch, n, cout) f32; dcent: (batch, s, 3)
// f32; work: group_gather_bwd_workspace_ints() int32.
extern "C" int group_gather_bwd_launch(const int* idx, const void* ct, int batch, int n, int s,
                                       int k, int cout, int* work, float* dtable, float* dcent,
                                       void* stream) {
  const long long sk = (long long)s * k;
  if (batch <= 0 || n <= 0 || cout <= 0 || sk >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const BwdPlan pl = bwd_plan(batch, n, sk, cout);
  if (sk > 0 && ((sk - 1) << pl.shift) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* ctb = static_cast<const __nv_bfloat16*>(ct);
  int* list = work;
  int* bstart = list + pl.list;
  int* cnt = bstart + pl.bstart;
  __nv_bfloat16* rel = reinterpret_cast<__nv_bfloat16*>(cnt + pl.cnt);
  cudaError_t err;
  if (sk > 0) {
    const dim3 grid(pl.nchunks, batch);
    if (pl.nchunks > 1)
      gather_bwd_count_kernel<<<grid, kChunkThreads, 0, st>>>(idx, (int)sk, pl.tile_rows, pl.nb,
                                                              cnt);
    gather_bwd_place_kernel<<<grid, kChunkThreads, 0, st>>>(idx, cnt, (int)sk, pl.tile_rows,
                                                            pl.nb, pl.shift, list, bstart);
  } else {
    err = cudaMemsetAsync(bstart, 0, pl.bstart * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  // channel chunks of at most 1024 (a thread each); the chunk's width sizes
  // the block, its staging and its sums
  const int cw = cout < 1024 ? cout : 1024;
  const int threads = (cw + 31) / 32 * 32;
  const int cps = (2 * cw + 15) / 16 + 1;
  int sub = threads * kPrefetch / cps;
  sub = sub < kStageBytes / 16 / cps ? sub : kStageBytes / 16 / cps;
  sub = sub < kMaxSub ? sub : kMaxSub;
  const size_t smem = (size_t)sub * cps * 16 + (size_t)pl.tile_rows * cw * sizeof(float);
  err = cudaFuncSetAttribute(gather_bwd_accumulate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather_bwd_accumulate_kernel<<<dim3(pl.nb, batch, (cout + 1023) / 1024), threads, smem, st>>>(
      list, bstart, ctb, n, (int)sk, cout, pl.tile_rows, pl.shift, sub, dtable, rel);
  const long long bs_total = (long long)batch * s;
  if (bs_total > 0) {
    const int t2 = 256;
    gather_bwd_dcent_kernel<<<(unsigned)((bs_total * 3 + t2 - 1) / t2), t2, 0, st>>>(
        rel, bs_total, k, dcent);
  }
  return (int)cudaGetLastError();
}
