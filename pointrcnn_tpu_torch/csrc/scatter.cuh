// The deterministic scatter-add of bf16 rows onto table rows, used by the
// fused MLP backward (csrc/mlp.cu); the gather backward (csrc/gather.cu) has
// a bucketed scatter of its own.
//
// No atomics, so the sums are deterministic and in ascending (s, k) order per
// table row, the order of a sequential index_add_.  Each block owns a tile of
// table rows of one batch row in shared memory (f32) and one thread per
// channel.  It scans that batch row's S*kp indices in chunks, compacts the
// positions whose index falls in its tile (an order-keeping block scan), then
// every thread adds its channel of those rows into its column of the tile, in
// list order.  Each thread owns one column, so no two threads touch one
// accumulator.  Loads of a run of list entries are issued before their adds,
// to keep enough bytes in flight; a small tile keeps many blocks on each SM
// for the same reason.  Every block rereads the batch row's indices (from L2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scatter {

// positions each thread scans per chunk, and list entries loaded ahead
constexpr int kPerThread = 8;
constexpr int kAhead = 16;
// shared-memory bytes of one block's accumulator tile
constexpr int kTileBytes = 32 * 1024;

// dtable[b, n, :] = sum over the positions p = s * kp + k with k < k_real and
// idx[b, p] == n of f32(ct[b, p, :]), in ascending p.
// grid (tiles, B); blockDim = cout rounded up to a warp multiple, at most
// 1024 (a thread then takes every 1024th channel).
// shared memory: acc[tile_rows][cout] f32, then the chunk's compacted list
// (positions, tile rows), then one int per warp for the scan.
__global__ void scatter_rows_kernel(const int* __restrict__ idx,
                                    const __nv_bfloat16* __restrict__ ct, int n, int sk,
                                    int kp, int k_real, int cout, int tile_rows,
                                    float* __restrict__ dtable) {
  extern __shared__ float smem[];
  const int nthr = blockDim.x;
  const int chunk = nthr * kPerThread;
  float* acc = smem;
  int* list_pos = reinterpret_cast<int*>(acc + (size_t)tile_rows * cout);
  int* list_row = list_pos + chunk;
  int* warp_sum = list_row + chunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - r0);
  for (int i = tid; i < rows * cout; i += nthr) acc[i] = 0.0f;

  const int* bidx = idx + (long long)b * sk;
  const __nv_bfloat16* bct = ct + (long long)b * sk * cout;
  for (int base = 0; base < sk; base += chunk) {
    // 1. this thread's kPerThread consecutive positions: which fall in the tile
    const int p0 = base + tid * kPerThread;
    int loc[kPerThread];
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      int r = -1;
      if (p0 + e < sk && (p0 + e) % kp < k_real) {
        const int j = bidx[p0 + e] - r0;
        if ((unsigned)j < (unsigned)rows) r = j;
      }
      loc[e] = r;
      cnt += r >= 0;
    }
    // 2. block-wide exclusive scan of the counts (thread order = position order)
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      if (lane < nwarps) warp_sum[lane] = v;
    }
    __syncthreads();
    int off = (warp ? warp_sum[warp - 1] : 0) + incl - cnt;
    const int total = warp_sum[nwarps - 1];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (loc[e] >= 0) {
        list_pos[off] = p0 + e;
        list_row[off] = loc[e];
        ++off;
      }
    }
    __syncthreads();
    // 3. thread tid adds channels tid, tid + nthr, ... of each listed
    // cotangent row, in order
    for (int ch = tid; ch < cout; ch += nthr) {
      int m = 0;
      for (; m + kAhead <= total; m += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          v[u] = __bfloat162float(bct[(long long)list_pos[m + u] * cout + ch]);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) acc[list_row[m + u] * cout + ch] += v[u];
      }
      for (; m < total; ++m)
        acc[list_row[m] * cout + ch] +=
            __bfloat162float(bct[(long long)list_pos[m] * cout + ch]);
    }
    __syncthreads();  // the list and warp_sum are rewritten by the next chunk
  }
  float* out = dtable + ((long long)b * n + r0) * cout;
  for (int i = tid; i < rows * cout; i += nthr) out[i] = acc[i];
}

// dtable (batch, n, cout) f32, written; ct (batch, s * kp, cout) bf16; idx
// (batch, s * kp) int32 in [0, n).
inline cudaError_t scatter_rows(const int* idx, const __nv_bfloat16* ct, int batch, int n,
                                int sk, int kp, int k_real, int cout, float* dtable,
                                cudaStream_t st) {
  const int threads = cout > 1024 ? 1024 : (cout + 31) / 32 * 32;
  if (n <= 0 || batch <= 0) return cudaErrorInvalidValue;
  int tile = kTileBytes / (cout * 4);
  tile = tile < 1 ? 1 : (tile > n ? n : tile);
  const size_t smem = (size_t)tile * cout * 4 +
                      (size_t)threads * kPerThread * 2 * sizeof(int) + 32 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + tile - 1) / tile, batch);
  scatter_rows_kernel<<<grid, threads, smem, st>>>(idx, ct, n, sk, kp, k_real, cout, tile,
                                                   dtable);
  return cudaGetLastError();
}

}  // namespace scatter
