// Fused neighbourhood gather + shared MLP stack + max over K: the forward
// (K2) and its backward (K7), on Hopper's warpgroup matrix multiply.
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
// layers (~217 GFLOP at SA1); the inputs (a bf16 table of a few MB and the
// indices) and the (B, S, Cout) output are small.
//
// What the design does about it:
// - persistent blocks walk tiles of 64 (or 128) neighbour rows, whole
//   centroids, of all (batch row, centroid group) pairs;
// - every layer's weights are staged into shared memory once per block, in
//   the no-swizzle core-matrix layout wgmma reads (wgmma.cuh); where they
//   leave room for two to four tiles' buffers, each warpgroup walks 64-row
//   tiles of its own (RCNN SA1, SA2), so one warpgroup's epilogue or gather
//   overlaps another's products; else the block's two warpgroups share each
//   tile, and a layer too large to stay (RPN SA4) streams through two slots
//   of column blocks, the next one's copy in flight while one multiplies;
// - hidden and last layers are wgmma m64nNk16 products (A: the tile's bf16
//   activations, B: the weights, both in shared memory; f32 accumulators in
//   registers), N cut into pieces of 64, 32 and 16 columns; the epilogue
//   (+ bias, ReLU, bf16) runs on the registers and writes the next layer's
//   activations in shared memory;
// - the max over K comes from the last layer's accumulators: a shuffle over
//   each warp's 16 rows, then a pass over the warps of each centroid;
// - rows are gathered by index (no one-hot matmul) with 16-byte cp.async
//   copies, the next tile's rows (and the tile after that's indices) in
//   flight while the current tile's layers run.
// What holds it back now: not the tensor cores (about an eighth of their
// peak at RCNN SA1) but the scalar work around them, layer 0, the
// epilogues, the gather and the barriers between them, which the few
// warps on an SM cannot hide.
//
// Backward replaces: pointrcnn_tpu/ops/pallas_mlp.py::_make_bwd_kernel
// (entry _pallas_bwd).  It recomputes the forward with the SAME device
// functions (gather_tile, layer0, layer_product with the forward's pieces,
// hidden_epilogue), so every activation is bit-identical to the one the
// forward took its max from, then backpropagates with the TPU kernel's
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
// centroids past S of a ragged last tile carry no cotangent.
//
// What bounds the backward: tensor-core FLOPs again (the recompute plus two
// products per layer: ~412 GFLOP at RCNN SA1, batch 4).  Design: persistent
// blocks whose two warpgroups share 64- or 128-row tiles, the grid filling
// the card;
// dW_i (wgmma with both operands read transposed), dz_{i-1} (W read as a
// K-major operand from the same shared copy) and the tie split run on the
// accumulators.  dW is added per tile into the block's own partial in
// global memory (a register file cannot hold SA2's 49k dW values beside the
// working accumulators); the partials are summed in block order by a second
// kernel.  db and dw0x are summed in shared memory per warpgroup.  The
// blocks write bf16(dz_0) (and bf16(drel)) per (b, s, k) row, and the
// deterministic scatter of scatter.cuh adds them onto the table rows in
// ascending (s, k) order, the order a sequential index_add_ takes.  Every
// sum has a fixed order, so the backward is deterministic.  What holds it
// back now: the per-tile read and write of the dW partials through L2
// (about 0.4 MB a 64-row tile at RCNN SA2) and the same scalar work as the
// forward.

//
// Shapes past these plans, as the TPU kernels take them: the kernels take
// every shape the TPU predicates admit (fused_group_mlp_max_supported: K up
// to 1024; fused_group_bwd_supported: K up to 256), at any depth and width.
// - One layer: layer 0 is the last layer.  The forward maxes its f32
//   activations over each centroid's rows (eight rows in shuffles, then a
//   shared-memory atomicMax on the bits: relu values are >= 0) and the
//   backward's tie split (tie_split0) recomputes them with the same
//   layer0_chunk.  Padded lanes are maxed and trimmed by the caller, as
//   JAX's _trim_padded_lanes does.
// - 128 neighbours: a tile of 128 rows holds one centroid, its two 64-row
//   blocks in the two warpgroups (which take the same pieces in step).  The
//   forward maxes each block into a zeroed output with atomicMax; the tie
//   split and the fold dcent meet both warpgroups at a named barrier.
// - 256 to 1024 neighbours: a centroid spans kp / 128 tiles of 128 rows
//   (Tile::k0: its first neighbour), each maxed into the zeroed output with
//   atomicMax as at 128.  The backward (K up to 256: two tiles a centroid,
//   SPAN) first runs the forward kernel in a count pass (COUNT) on the
//   backward's own plan: its last layer counts, per (centroid, column), the
//   real rows equal to the forward's maximum into an int32 buffer (integer
//   adds: any order gives the same count), so each tile's tie split divides
//   by the centroid's whole count.  The centroid's first tile adds db, the
//   no-match count and (one layer) dcent once; the fold and hilo dcent of a
//   deeper stack sum each tile's rows and atomicAdd them into a zeroed dcent:
//   two addends onto zero give the same bits in either order.
// - Any depth: the per-layer widths, offsets and buffers are a layer table
//   (LayerDesc) in device memory, read into shared memory by each block of a
//   shared-memory plan and in place by a global plan; the weights and biases
//   come concatenated.
// - The global plan, where no plan above fits (RCNN SA2 of
//   entry.WIDE_OVERRIDES: five layers up to 640, K 128; a layer 0 wider than
//   the gathered tile; a deep stack's backward): every buffer whose size
//   grows with the widths lives in the block's global scratch (L2): the
//   gathered rows and the activations in the same core-matrix layout, the
//   centroid rows, the w0x copy, the one-layer maxima and the backward's
//   accumulators; the biases are read where the caller put them.  Its
//   shared memory is the same at every shape.  Every product, forward,
//   recompute, dW and dz, copies its operands 64 deep at a time into
//   per-warpgroup slots (staged()), layer 0's gathered rows included.  The
//   backward streams the weights of every use, not only the transposed one
//   in dz: at that stack a 64-row tile's activations alone (1792 columns,
//   229 KB) exceed shared memory, so weights streamed beside resident
//   activations could not fit.  The 16-deep steps keep one resident
//   product's order, so the global plan gives the same bits as the others
//   (chip_smoke.py holds it to them), and a forward on one plan and its
//   recompute on another agree.  It is compiled as its own instantiation
//   (GLOB), so the first plans keep their code; so are the count pass and
//   the spanning backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cstring>
#include <mutex>
#include <vector>

#include "scatter.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hop::cm_off;

constexpr int kThreads = 256;  // a block whose two warpgroups share tiles
constexpr int kMaxSmem = 232448;
constexpr int kStageK = 64;     // depth of a staged operand chunk (global plans)
constexpr int kBothBar = 7;     // named barrier of both warpgroups (128-row centroids)
constexpr int kCap = 64;        // widest N piece of a forward-layer product
constexpr int kStreamCap = 32;  // ... of a streamed layer (a pass holds two)
constexpr int kSlack = 1024;    // bytes after an activation buffer: dW's M overhang
constexpr int kRedCols = 128;   // columns of a warpgroup's reduction scratch (4 warps
                                // x 128 columns, twice: the max epilogue alternates)

// One layer's row of the layer table.  The host builds the table (widths,
// offsets into the concatenated weights and biases and into a partial slot,
// the plan's buffers) and copies it to the device once per distinct table;
// a block of a shared-memory plan reads it into shared memory at its start,
// a global plan's reads it in place.  So a stack may be any depth.
struct LayerDesc {
  int width;   // a multiple of 16
  int w_off;   // W_j (j >= 1) in the concatenated weights, in elements
  int b_off;   // b_j in the concatenated biases (and in the plan's copy), in floats
  int w_sm;    // W_j's resident copy in shared memory (-1: streamed or staged)
  int act;     // the activations of layer j < L - 1; j = L - 1: the backward's dz_L
               // (global plans: an offset into the block's scratch)
  int dw, db;  // dW_j (j >= 1) and db_j in a partial slot, in floats
  int pad;
};

struct Layers {
  const LayerDesc* d;  // the layer table
  const bf16* w;       // W_1 .. W_{L-1}: (width[j-1], width[j]) row-major, back to back
  const float* b;      // b_0 .. b_{L-1}, back to back
  int n_layers;
  __host__ __device__ int width(int j) const { return d[j].width; }
  __host__ __device__ const bf16* wt(int j) const { return w + d[j].w_off; }
};

// A block's shared memory as byte offsets (-1: absent), planned on the host.
// A global plan (glob) keeps every buffer whose size grows with the widths
// in the block's global scratch instead (offsets there): stage, cent, w0x,
// mx, gs, dbacc, dw0x, wsum and the activations; its biases are read from
// the concatenated biases in place.
struct Plan {
  int tm;                  // rows per tile: 64 or 128 (whole centroids, or a
                           // 128-row piece of one past 128 neighbours)
  int slot;                // bytes of one of the ring's two slots
  int glob;                // 1: the global plan, every product's operands staged
                           // in kStageK-deep chunks
  int desc;                // the layer table (-1: global plans read it in place)
  int ring, stage, rid, xyz, cent, bias, w0x, red, gsc, dbacc, dw0x, geo, drel, wsum;
  int sa, sb;              // glob: each warpgroup's staged A and B chunks
  int mx;                  // one-layer stacks: the tile's maxima (fwd) or tie counts (bwd)
  int gs;                  // one-layer backward: each (centroid, column)'s share
  int wg_bytes;            // > 0: each warpgroup walks its own tiles, its tile
                           // buffers (stage .. geo) wg_bytes apart
  int bytes;
  int scratch;             // glob: bytes of global scratch a block
  // a partial slot of the backward, in floats: dW_1 .. dW_{L-1}, db_0 ..
  // db_{L-1} (sumw floats from desc[0].db), the six dw0x rows at g_dw0x
  int sumw, g_dw0x, g_size;
};

// The kernels' operands.
struct Args {
  int fold;
  const bf16* table;   // (B, N, F0P)
  const float* xyz;    // (B, N, 3), hilo
  const float* cent;   // (B, S, F0P) fold, (B, S, 3) hilo
  const bf16* w0x;     // (3, F0P), hilo
  const int* idx;      // (B, S, kp)
  unsigned char* scratch;  // glob plans: (grid, Plan::scratch) bytes
  int n, s, kp, kps, k_real;  // kps = log2(kp)
  int cpt, ppcs;       // centroids a tile (1 past tm neighbours); log2 of the
                       // tiles a centroid spans (0 up to tm neighbours)
  int tiles_per_b, total;
  float* out;          // forward: (B, S, Cout)
  const float* fwd_out;
  const float* ct;     // backward: the forward's output and its cotangent
  bf16* dz0;           // (B, S, kp, F0P) bf16(dz_0)
  bf16* drel;          // (B, S, kp, 3) bf16(drel), hilo
  float* dcent;        // (B, S, F0P | 3)
  float* part;         // (grid, grad size)
  int* nomatch;
  int* cnt;            // the count pass's (B, S, Cout) tie counts, zeroed
};

// N pieces of a product `width` columns wide: as many `cap`s as fit, then
// halves down to 16.  pieces(..., p, &n0) -> the width of piece p (0: none).
__host__ __device__ inline int piece(int width, int cap, int p, int* n0) {
  int off = 0, i = 0;
  for (int w = cap; w >= 16; w >>= 1) {
    while (width - off >= w) {
      if (i == p) {
        *n0 = off;
        return w;
      }
      off += w;
      ++i;
    }
  }
  return 0;
}

__host__ __device__ inline int n_pieces(int width, int cap) {
  int n0, p = 0;
  while (piece(width, cap, p, &n0)) ++p;
  return p;
}


template <class T>
__device__ __forceinline__ T* at(unsigned char* sm, int off) {
  return reinterpret_cast<T*>(sm + off);
}

// a buffer whose size grows with the widths: in shared memory (sm, or tsm:
// the tile group's buffers) or, in a global plan (GLOB: the kernels are
// compiled once for each, so the first plans keep their code), in the
// block's scratch
template <bool GLOB, class T>
__device__ __forceinline__ T* wide(const Args& A, const Plan& P, unsigned char* sm, int off) {
  if constexpr (GLOB) {
    return reinterpret_cast<T*>(A.scratch + (size_t)blockIdx.x * P.scratch + off);
  }
  return at<T>(sm, off);
}

// the biases of every layer, back to back: the block's copy, or in place
template <bool GLOB>
__device__ __forceinline__ const float* biases(unsigned char* sm, const Plan& P, const Layers& L) {
  if constexpr (GLOB) return L.b;
  return at<float>(sm, P.bias);
}

// layer j's bias
template <bool GLOB>
__device__ __forceinline__ const float* bias_of(unsigned char* sm, const Plan& P,
                                                const Layers& L, int j) {
  return biases<GLOB>(sm, P, L) + L.d[j].b_off;
}

// layer j's activation buffer
template <bool GLOB>
__device__ __forceinline__ bf16* act_of(const Args& A, const Plan& P, const Layers& L,
                                        unsigned char* tsm, int j) {
  return wide<GLOB, bf16>(A, P, tsm, L.d[j].act);
}

// the layer table -> shared memory, where the plan has room for it (a
// global plan reads it in place); every thread of the block calls this
__device__ __forceinline__ Layers bind_layers(Layers L, const Plan& P, unsigned char* sm) {
  if (P.desc < 0) return L;
  int* dst = at<int>(sm, P.desc);
  const int* src = reinterpret_cast<const int*>(L.d);
  const int n = L.n_layers * (int)(sizeof(LayerDesc) / sizeof(int));
  for (int e = threadIdx.x; e < n; e += (int)blockDim.x) dst[e] = src[e];
  __syncthreads();
  L.d = reinterpret_cast<const LayerDesc*>(dst);
  return L;
}

// 16 (4) bytes from global memory into a buffer: cp.async into shared
// memory, a plain copy into a global plan's scratch
template <bool GLOB>
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  if constexpr (GLOB) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    hop::cp_async16(dst, src);
  }
}
template <bool GLOB>
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  if constexpr (GLOB) {
    *dst = __ldg(src);
  } else {
    hop::cp_async4(dst, src);
  }
}

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// wgmma operands.  K-major: the stored columns are the reduction dimension;
// MN-major: the stored rows are.  The descriptor's leading-dimension offset
// is the stride between cores along K, the stride-dimension offset the one
// along M/N (the probe-checked assignment for no-swizzle layouts).

template <int T>
__device__ __forceinline__ uint64_t desc(const bf16* p, int C) {
  return T ? hop::make_desc(p, 16 * C, 128) : hop::make_desc(p, 128, 16 * C);
}

// acc (64 x n) = A (64 x 16 ksteps) B (16 ksteps x n), n <= NMAX; a and b
// point at the (m0, k0) and (k0, n0) corners of tiles stored ca and cb
// columns wide.
// issue() starts the product as one wgmma group; product() also waits for it
template <int TA, int TB, int NMAX>
__device__ __forceinline__ void issue(float* acc, int n, const bf16* a, int ca, const bf16* b,
                                      int cb, int ksteps) {
  // a 16-deep step moves two cores along K: 256 bytes K-major, 16 rows of
  // 2C bytes MN-major; the descriptor's address field counts 16 bytes
  const uint64_t da = desc<TA>(a, ca), db = desc<TB>(b, cb);
  const uint32_t a_step = TA ? 2 * ca : 16, b_step = TB ? 2 * cb : 16;
  hop::fence_regs(acc, NMAX / 2);
  hop::wg_fence();
  for (int kk = 0; kk < ksteps; ++kk) {
    hop::mma<TA, TB, NMAX>(n, acc, da + kk * a_step, db + kk * b_step, kk > 0);
  }
  hop::wg_commit();
}

template <int TA, int TB, int NMAX>
__device__ __forceinline__ void product(float* acc, int n, const bf16* a, int ca,
                                        const bf16* b, int cb, int ksteps) {
  issue<TA, TB, NMAX>(acc, n, a, ca, b, cb, ksteps);
  hop::wg_wait();
  hop::fence_regs(acc, NMAX / 2);
}

// Global plans: products whose operands stay in global memory (the
// activations in the block's scratch in the core-matrix layout, the weights
// row-major as the caller passed them), copied kStageK deep at a time into
// the warpgroup's two staging slots and multiplied there.  The 16-deep steps
// run in the order one resident product runs them, so every accumulator
// rounds as issue() rounds it.
//
// rows [r0, r0 + rows) x columns [c0, c0 + cols) of a matrix `ld` columns
// wide (core layout, or row-major) -> dst, a core layout `cols` wide;
// columns at or past `lim` are not read (their products are dropped)
__device__ __forceinline__ void stage_block(bf16* dst, const bf16* src, int ld, bool row_major,
                                            int r0, int rows, int c0, int cols, int lim,
                                            int tid) {
  const int cpr = cols >> 3;
  for (int q = tid; q < rows * cpr; q += 128) {
    const int core = q >> 3, rr = core / cpr, cc = core - rr * cpr;
    const int r = r0 + 8 * rr + (q & 7), c = c0 + 8 * cc;
    if (c >= lim) continue;
    hop::cp_async16(dst + 8 * q, row_major ? src + (size_t)r * ld + c : src + cm_off(r, c, ld));
  }
}

// acc (64 x n) = A B over `depth`: TA 0: A is rows [am0, am0 + 64) of a (ca
// columns = the depth); TA 1: columns [am0, am0 + 64) of a (depth rows, ca
// columns); TB 1: columns [bn0, bn0 + n) of b (depth rows, cb columns); TB 0:
// rows [bn0, bn0 + n) of b (cb columns = the depth); b row-major if BROW
template <int TA, int TB, int NMAX, bool BROW>
__device__ __forceinline__ void staged(float* acc, int n, const bf16* a, int ca, int am0,
                                       const bf16* b, int cb, int bn0, int depth, bf16* sa,
                                       bf16* sb, int wg, int t) {
  hop::fence_regs(acc, NMAX / 2);
  for (int k0 = 0; k0 < depth; k0 += kStageK) {
    const int kc = min(kStageK, depth - k0);
    if (TA) {
      stage_block(sa, a, ca, false, k0, kc, am0, 64, ca, t);
    } else {
      stage_block(sa, a, ca, false, am0, 64, k0, kc, ca, t);
    }
    if (TB) {
      stage_block(sb, b, cb, BROW, k0, kc, bn0, n, cb, t);
    } else {
      stage_block(sb, b, cb, BROW, bn0, n, k0, kc, cb, t);
    }
    hop::cp_async_commit();
    hop::cp_async_wait_all();
    hop::fence_async_smem();
    hop::bar_sync(1 + wg, 128);
    const uint64_t da = desc<TA>(sa, TA ? 64 : kc), db = desc<TB>(sb, TB ? n : kc);
    const uint32_t a_step = TA ? 2 * 64 : 16, b_step = TB ? 2 * n : 16;
    hop::wg_fence();
    for (int kk = 0; kk < kc >> 4; ++kk) {
      hop::mma<TA, TB, NMAX>(n, acc, da + kk * a_step, db + kk * b_step, k0 > 0 || kk > 0);
    }
    hop::wg_commit();
    hop::wg_wait();
    hop::fence_regs(acc, NMAX / 2);
    hop::bar_sync(1 + wg, 128);  // the slots are refilled by the next chunk
  }
}

// this warpgroup's staging slots of a global plan
__device__ __forceinline__ bf16* slot_a(unsigned char* sm, const Plan& P, int wg) {
  return at<bf16>(sm, P.sa) + wg * 64 * kStageK;
}
__device__ __forceinline__ bf16* slot_b(unsigned char* sm, const Plan& P, int wg) {
  return at<bf16>(sm, P.sb) + wg * kStageK * 128;
}

// Items first, first + step, ... < items of one warpgroup: start(it, acc)
// issues item it's products, finish(it, acc) runs its epilogue once they
// have landed.
template <int NREG, class Start, class Finish>
__device__ __forceinline__ void for_items(int first, int step, int items, Start start,
                                          Finish finish) {
  float acc[NREG];
  for (int it = first; it < items; it += step) {
    start(it, acc);
    hop::wg_wait();
    hop::fence_regs(acc, NREG);
    finish(it, acc);
  }
}

// Thread coordinates inside a warpgroup's 64 x n accumulator tile.
struct Frag {
  int wg, w, l, t;  // warpgroup, warp in it, lane, thread in it
  __device__ Frag() {
    t = threadIdx.x & 127;
    wg = threadIdx.x >> 7;
    w = t >> 5;
    l = t & 31;
  }
  __device__ int row(int i) const { return 16 * w + (l >> 2) + 8 * i; }
  __device__ int col(int n8) const { return 8 * n8 + 2 * (l & 3); }
};

// The threads that share a tile: the whole block, or one warpgroup when
// each warpgroup walks tiles of its own (bar: its named barrier; 0, the
// block's).
struct Group {
  int tid, nthr, bar;
  __device__ void sync() const {
    if (bar) {
      hop::bar_sync(bar, nthr);
    } else {
      __syncthreads();
    }
  }
};

// sum (or max) over the 16 rows a warp holds: lanes differing in bits 2..4
__device__ __forceinline__ float warp_rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}
__device__ __forceinline__ float warp_rows_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
  return v;
}

// the row and 8-column chunk of the q-th 16 bytes of a core-matrix layout
// with cpr chunks a row (8 threads fill one core: 8 rows of one chunk)
struct Chunk {
  int r, c8;
};
__device__ __forceinline__ Chunk chunk_of(int q, int cpr) {
  const int core = q >> 3;
  const int rg = (cpr & (cpr - 1)) ? core / cpr : core >> (__ffs(cpr) - 1);
  return {rg * 8 + (q & 7), core - rg * cpr};
}

// ---------------------------------------------------------------------------
// Tiles: up to tm neighbours, tile t is centroids s0 .. s0 + tm/kp - 1 of
// batch row b and its row r is neighbour r % kp of centroid s0 + r / kp;
// past tm neighbours, a centroid spans kp / tm tiles and row r of tile t is
// neighbour k0 + r of centroid s0.  Either way row r is neighbour
// k0 + (r & (kp - 1)) of centroid s0 + (r >> kps).

struct Tile {
  int b, s0, k0;
};

__device__ __forceinline__ Tile tile_of(const Args& A, const Plan& P, int t) {
  const int rem = t % A.tiles_per_b;
  return {t / A.tiles_per_b, (rem >> A.ppcs) * A.cpt, (rem & ((1 << A.ppcs) - 1)) * P.tm};
}

// the tile's indices -> rid (cp.async; 0 past S)
__device__ __forceinline__ void load_idx(const Args& A, const Plan& P, const Group& G, int t,
                                         int* rid) {
  const Tile T = tile_of(A, P, t);
  for (int r = G.tid; r < P.tm; r += G.nthr) {
    const int sc = T.s0 + (r >> A.kps);
    if (sc < A.s) {
      hop::cp_async4(rid + r,
                     A.idx + ((size_t)T.b * A.s + sc) * A.kp + T.k0 + (r & (A.kp - 1)));
    } else {
      rid[r] = 0;
    }
  }
}

// the tile's table rows -> stage (core-matrix layout, F0P columns), and its
// centroids (fold: F0P floats each; hilo: xyz) and, hilo, the rows' xyz
template <bool GLOB>
__device__ __forceinline__ void gather_tile(const Args& A, const Plan& P, const Group& G, int f0p,
                                            int t, const int* rid, bf16* stage, float* xyzb,
                                            float* centb) {
  const Tile T = tile_of(A, P, t);
  const int cpr = f0p >> 3;
  // chunk q is the q-th 16 bytes of the layout: 8 threads fill one core
  // (8 rows), a warp 8 rows x 4 chunks
  for (int q = G.tid; q < P.tm * cpr; q += G.nthr) {
    const Chunk ch = chunk_of(q, cpr);
    const int r = ch.r, c8 = ch.c8;
    copy16<GLOB>(stage + 8 * q, A.table + ((size_t)T.b * A.n + rid[r]) * f0p + 8 * c8);
  }
  const int cpt = A.cpt;
  if (A.fold) {
    const int c4n = f0p >> 2;
    for (int q = G.tid; q < cpt * c4n; q += G.nthr) {
      const int cl = q / c4n, c4 = q - cl * c4n;
      const int sc = T.s0 + cl;
      float* dst = centb + cl * f0p + 4 * c4;
      if (sc < A.s) {
        copy16<GLOB>(dst, A.cent + ((size_t)T.b * A.s + sc) * f0p + 4 * c4);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = G.tid; e < P.tm * 3; e += G.nthr) {
      const int r = e / 3;
      hop::cp_async4(xyzb + e, A.xyz + ((size_t)T.b * A.n + rid[r]) * 3 + (e - 3 * r));
    }
    for (int e = G.tid; e < cpt * 3; e += G.nthr) {
      const int cl = e / 3;
      const int sc = T.s0 + cl;
      if (sc < A.s) {
        copy4<GLOB>(centb + e, A.cent + ((size_t)T.b * A.s + sc) * 3 + (e - 3 * cl));
      } else {
        centb[e] = 0.f;
      }
    }
  }
}

// eight floats from 16-byte aligned shared memory
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// hilo: row r's relative geometry exactly as the TPU kernel forms it,
// bf16(hi - c) in g[0:3] and lo (already bf16) in g[3:6]
__device__ __forceinline__ void row_geo(const float* xyzb, const float* centb, int r, int cl,
                                        float* g) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = xyzb[r * 3 + c];
    const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
    g[3 + c] = bf(__float2bfloat16_rn(x - hi));
    g[c] = bf(__float2bfloat16_rn(hi - centb[cl * 3 + c]));
  }
}

// layer 0 on the q-th 16 bytes of the gathered rows (row r, columns c0 ..
// c0 + 7, centroid cl of the tile): the gathered table row, the geometry
// term, the bias and the ReLU -> v, f32
__device__ __forceinline__ void layer0_chunk(const Args& A, int f0p, const bf16* stage,
                                             const float* centb, const float* b0s,
                                             const float* w0xs, const float* geo, int q, int r,
                                             int c0, int cl, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(stage + 8 * q);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float t[8];  // bf16 -> f32 is exact: the bits shifted up
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    t[2 * e] = __uint_as_float(words[e] << 16);
    t[2 * e + 1] = __uint_as_float(words[e] & 0xFFFF0000u);
  }
  float x[8];
  if (A.fold) {
    float cc[8];
    load8(centb + cl * f0p + c0, cc);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = t[e] - cc[e];
  } else {
    float g[6], wx[8], wy[8], wz[8];
#pragma unroll
    for (int c = 0; c < 6; ++c) g[c] = geo[6 * r + c];
    load8(w0xs + c0, wx);
    load8(w0xs + f0p + c0, wy);
    load8(w0xs + 2 * f0p + c0, wz);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // the six products in order; each is of two bf16 values, exact in
      // f32, so fma(a, b, s) rounds as s + a * b does
      float acc = g[0] * wx[e];
      acc = __fmaf_rn(g[1], wy[e], acc);
      acc = __fmaf_rn(g[2], wz[e], acc);
      acc = __fmaf_rn(g[3], wx[e], acc);
      acc = __fmaf_rn(g[4], wy[e], acc);
      acc = __fmaf_rn(g[5], wz[e], acc);
      x[e] = t[e] + acc;
    }
  }
  float bb[8];
  load8(b0s + c0, bb);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = fmaxf(x[e] + bb[e], 0.f);
}

// hilo: every row's relative geometry -> geo
__device__ __forceinline__ void tile_geo(const Args& A, const Plan& P, const Group& G,
                                         const float* xyzb, const float* centb, float* geo) {
  if (A.fold) return;
  for (int r = G.tid; r < P.tm; r += G.nthr) row_geo(xyzb, centb, r, r >> A.kps, geo + 6 * r);
  G.sync();
}

// layer 0 -> bf16 act (F0P columns; act may be stage itself: each thread
// rewrites its own 16 bytes); b0s, w0xs: the bias and (hilo) the bf16 w0x
// rows as f32; geo: (hilo) the rows' relative geometry, filled here.  A
// one-layer stack (mx != nullptr) writes nothing to act: the f32 maxima of
// each centroid's rows go into mx (cpt x F0P, zero on entry) instead, or
// in the count pass (COUNT) the number of its real rows equal to the
// forward's maximum.
template <bool COUNT>
__device__ __forceinline__ void layer0(const Args& A, const Plan& P, const Group& G, int f0p,
                                       const bf16* stage, const float* xyzb, const float* centb,
                                       const float* b0s, const float* w0xs, float* geo, bf16* act,
                                       unsigned* mx, Tile T) {
  const int cpr = f0p >> 3;
  tile_geo(A, P, G, xyzb, centb, geo);
  for (int q = G.tid; q < P.tm * cpr; q += G.nthr) {
    const Chunk ch = chunk_of(q, cpr);
    const int r = ch.r, c0 = ch.c8 * 8;
    const int cl = r >> A.kps;
    float v[8];
    layer0_chunk(A, f0p, stage, centb, b0s, w0xs, geo, q, r, c0, cl, v);
    if (COUNT && mx) {
      // lanes 8i .. 8i + 7: the eight rows of one core, one centroid
      const int sc = T.s0 + cl;
      const bool live = sc < A.s && T.k0 + (r & (A.kp - 1)) < A.k_real;
      const float* orow = A.fwd_out + ((size_t)T.b * A.s + (live ? sc : 0)) * f0p + c0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int k = live && v[e] == orow[e];
        k += __shfl_xor_sync(0xffffffffu, k, 1);
        k += __shfl_xor_sync(0xffffffffu, k, 2);
        k += __shfl_xor_sync(0xffffffffu, k, 4);
        if ((q & 7) == 0 && k) atomicAdd(mx + cl * f0p + c0 + e, (unsigned)k);
      }
      continue;
    }
    if (mx) {
      // lanes 8i .. 8i + 7 hold the eight rows of one core (one centroid):
      // their maximum, then one shared-memory max a column.  relu values are
      // >= 0, so their bits (-0.0 taken as +0.0) order as the floats do
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        unsigned u = __float_as_uint(v[e]) & 0x7FFFFFFFu;
        u = max(u, __shfl_xor_sync(0xffffffffu, u, 1));
        u = max(u, __shfl_xor_sync(0xffffffffu, u, 2));
        u = max(u, __shfl_xor_sync(0xffffffffu, u, 4));
        if ((q & 7) == 0) atomicMax(mx + cl * f0p + c0 + e, u);
      }
      continue;
    }
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e + 1]));
      o[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(act + 8 * q) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// a one-layer stack's maxima (mx, after a sync) -> out, or (COUNT) its tie
// counts added into cnt; mx zeroed again.  A centroid over several tiles
// maxes each into the zeroed output (relu values are >= 0: their bits order
// as the floats do)
template <bool COUNT>
__device__ __forceinline__ void store_max0(const Args& A, const Plan& P, const Group& G, int f0p,
                                           Tile T, unsigned* mx) {
  for (int e = G.tid; e < A.cpt * f0p; e += G.nthr) {
    const int cl = e / f0p, c = e - cl * f0p;
    const int sc = T.s0 + cl;
    if (sc < A.s) {
      const size_t o = ((size_t)T.b * A.s + sc) * f0p + c;
      if (COUNT) {
        if (mx[e]) atomicAdd(A.cnt + o, (int)mx[e]);
      } else if (A.ppcs) {
        atomicMax(reinterpret_cast<unsigned*>(A.out) + o, mx[e]);
      } else {
        A.out[o] = __uint_as_float(mx[e]);
      }
    }
    mx[e] = 0u;
  }
}

// hidden layer epilogue: relu(acc + b) -> bf16 rows m0.., columns n0.. of
// `out` (cout columns)
__device__ __forceinline__ void hidden_epilogue(const Frag& F, const float* acc, int n, int m0,
                                                int n0, const float* bias, bf16* out,
                                                int cout) {
  // (row + 8i, col + 8 n8) lies 8 cout i + 64 n8 elements past (row, col)
  bf16* base = out + cm_off(m0 + F.row(0), n0 + F.col(0), cout);
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    if (8 * n8 < n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + F.col(n8));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v0 = fmaxf(acc[4 * n8 + 2 * i] + bb.x, 0.f);
        const float v1 = fmaxf(acc[4 * n8 + 2 * i + 1] + bb.y, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(base + i * 8 * cout + n8 * 64) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// last layer epilogue of the forward: max over each centroid's rows of
// relu(acc + b) -> out.  Consecutive items alternate between red's halves,
// so the next item's barrier also keeps this item's reads from being
// overwritten.
__device__ __forceinline__ void max_epilogue(const Args& A, const Frag& F, const float* acc, int n,
                                             int m0, int n0, const float* bias, int cout, Tile T,
                                             float* red) {
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    if (8 * n8 < n) {
      const int c = F.col(n8);
      const float2 b2 = *reinterpret_cast<const float2*>(bias + n0 + c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // x -> relu(x + b) is monotone in f32, so the max of the rows'
        // relu(acc + b) is relu(max acc + b), bit for bit
        const float v = warp_rows_max(fmaxf(acc[4 * n8 + j], acc[4 * n8 + 2 + j]));
        if (F.l < 4) red[F.w * kRedCols + c + j] = fmaxf(v + (j ? b2.y : b2.x), 0.f);
      }
    }
  }
  hop::bar_sync(1 + F.wg, 128);
  if (A.kp > 64) {
    // a 128-row centroid spans both 64-row blocks of its tile: each adds its
    // block's maximum into the output, zeroed before the launch (relu values
    // are >= 0, so their bits, -0.0 taken as +0.0, order as the floats do)
    for (int c = F.t; c < n; c += 128) {
      float m = red[c];
      for (int u = 1; u < 4; ++u) m = fmaxf(m, red[u * kRedCols + c]);
      if (T.s0 < A.s) {
        atomicMax(reinterpret_cast<unsigned*>(A.out) + ((size_t)T.b * A.s + T.s0) * cout + n0 + c,
                  __float_as_uint(m) & 0x7FFFFFFFu);
      }
    }
    return;
  }
  const int wpc = A.kp >> 4;  // warps per centroid
  const int ncent = 4 / wpc;
  for (int e = F.t; e < ncent * n; e += 128) {
    const int cl = e / n, c = e - cl * n;
    float m = red[cl * wpc * kRedCols + c];
    for (int u = 1; u < wpc; ++u) m = fmaxf(m, red[(cl * wpc + u) * kRedCols + c]);
    const int sc = T.s0 + (m0 >> A.kps) + cl;
    if (sc < A.s) A.out[((size_t)T.b * A.s + sc) * cout + n0 + c] = m;
  }
}

// last layer epilogue of the count pass (a centroid over several tiles, so
// every row of the tile is centroid s0's): per column, the real rows whose
// relu(acc + b) equals the forward's maximum, summed over the warpgroup's
// 64 rows and added into cnt.  red alternates as in max_epilogue.
__device__ __forceinline__ void count_epilogue(const Args& A, const Frag& F, const float* acc,
                                               int n, int m0, int n0, const float* bias, int cout,
                                               Tile T, float* red) {
  const int k = T.k0 + m0 + F.row(0);
  const bool valid = T.s0 < A.s;
  const bool live0 = valid && k < A.k_real, live1 = valid && k + 8 < A.k_real;
  const float* orow = A.fwd_out + ((size_t)T.b * A.s + (valid ? T.s0 : 0)) * cout + n0;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    if (8 * n8 < n) {
      const int c = F.col(n8);
      const float2 b2 = *reinterpret_cast<const float2*>(bias + n0 + c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bb = j ? b2.y : b2.x;
        const float o = orow[c + j];
        const float a0 = fmaxf(acc[4 * n8 + j] + bb, 0.f);
        const float a1 = fmaxf(acc[4 * n8 + 2 + j] + bb, 0.f);
        const float v = warp_rows_sum((float)((live0 && a0 == o) + (live1 && a1 == o)));
        if (F.l < 4) red[F.w * kRedCols + c + j] = v;
      }
    }
  }
  hop::bar_sync(1 + F.wg, 128);
  for (int c = F.t; c < n; c += 128) {
    // sums of at most 64 ones: exact in f32
    const int m = (int)(((red[c] + red[kRedCols + c]) + red[2 * kRedCols + c]) +
                        red[3 * kRedCols + c]);
    if (m && valid) atomicAdd(A.cnt + ((size_t)T.b * A.s + T.s0) * cout + n0 + c, m);
  }
}

// one streamed pass: columns [c0, c0 + pw) of W (cin x cout) -> slot, laid
// out pw columns wide
__device__ __forceinline__ void load_pass(const bf16* __restrict__ W, int cin, int cout, int c0,
                                          int pw, bf16* slot) {
  const int cpr = pw >> 3;
  for (int q = threadIdx.x; q < cin * cpr; q += (int)blockDim.x) {
    const Chunk ch = chunk_of(q, cpr);
    const int r = ch.r, c8 = ch.c8;
    hop::cp_async16(slot + 8 * q, W + (size_t)r * cout + c0 + 8 * c8);
  }
}

// Layer j of the forward on the tile's activations `in` (tm x cin): each
// warpgroup takes the items (64-row block, N piece) i = wg, wg + 2, ...;
// hidden layers write relu(. + b) to `out`, the last layer (out == nullptr)
// its max over K (COUNT: the count pass's tie counts).  The backward's
// recompute calls this too, so the pieces and the order of the 16-deep
// steps are the forward's.  A warpgroup with a tile of its own takes every
// item (first 0, step 1).
template <bool GLOB, bool COUNT>
__device__ __forceinline__ void layer_product(const Args& A, const Layers& L, const Plan& P,
                                              unsigned char* sm, int j, const bf16* in, bf16* out,
                                              Tile T, int first, int step) {
  const Frag F;
  const int cin = L.width(j - 1), cout = L.width(j);
  float acc[kCap / 2];
  float* red = at<float>(sm, P.red) + F.wg * 8 * kRedCols;
  const float* bias = bias_of<GLOB>(sm, P, L, j);
  auto last = [&](const float* d, int n, int m0, int n0, float* rd) {
    if constexpr (COUNT) {
      count_epilogue(A, F, d, n, m0, n0, bias, cout, T, rd);
    } else {
      max_epilogue(A, F, d, n, m0, n0, bias, cout, T, rd);
    }
  };
  if (GLOB || L.d[j].w_sm >= 0) {
    const int np = n_pieces(cout, kCap);
    const bf16* W = GLOB ? nullptr : at<bf16>(sm, L.d[j].w_sm);
    const int mt = P.tm >> 6;
    const int items = mt * np;
    auto start = [&](int it, float* d) {
      int n0;
      const int n = piece(cout, kCap, it / mt, &n0);
      if constexpr (GLOB) {
        staged<0, 1, kCap, true>(d, n, in, cin, 64 * (it % mt), L.wt(j), cout, n0, cin,
                                 slot_a(sm, P, F.wg), slot_b(sm, P, F.wg), F.wg, F.t);
      } else {
        issue<0, 1, kCap>(d, n, in + cm_off(64 * (it % mt), 0, cin), cin,
                          W + cm_off(0, n0, cout), cout, cin >> 4);
      }
    };
    auto finish = [&](int it, const float* d) {
      int n0;
      const int n = piece(cout, kCap, it / mt, &n0);
      if (out) {
        hidden_epilogue(F, d, n, 64 * (it % mt), n0, bias, out, cout);
      } else {
        last(d, n, 64 * (it % mt), n0, red + ((it - first) / step & 1) * 4 * kRedCols);
      }
    };
    for_items<kCap / 2>(first, step, items, start, finish);
    return;
  }
  // streamed (tm = 64): pass q holds pieces 2q (warpgroup 0) and 2q + 1,
  // columns [c0, c0 + pw) of W; pass q + 1 is copied in while q multiplies
  const int np = n_pieces(cout, kStreamCap);
  bf16* ring = at<bf16>(sm, P.ring);
  const int slot_el = P.slot / 2;
  const int nq = (np + 1) / 2;
  auto span = [&](int q, int* c0) {
    int n1;
    piece(cout, kStreamCap, 2 * q, c0);
    const int w1 = piece(cout, kStreamCap, min(2 * q + 1, np - 1), &n1);
    return n1 + w1 - *c0;
  };
  int c0;
  int pw = span(0, &c0);
  load_pass(L.wt(j), cin, cout, c0, pw, ring);
  hop::cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    pw = span(q, &c0);
    if (q + 1 < nq) {
      int c0n;
      const int pwn = span(q + 1, &c0n);
      load_pass(L.wt(j), cin, cout, c0n, pwn, ring + ((q + 1) & 1) * slot_el);
      hop::cp_async_commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      hop::cp_async_wait_all();
    }
    hop::fence_async_smem();
    __syncthreads();
    const bf16* slot = ring + (q & 1) * slot_el;
    const int p = 2 * q + F.wg;
    if (p < np) {
      int n0;
      const int n = piece(cout, kStreamCap, p, &n0);
      product<0, 1, kCap>(acc, n, in, cin, slot + cm_off(0, n0 - c0, pw), pw, cin >> 4);
      if (out) {
        hidden_epilogue(F, acc, n, 0, n0, bias, out, cout);
      } else {
        last(acc, n, 0, n0, red);
      }
    }
    __syncthreads();  // the slot is refilled by pass q + 2
  }
}

// set up once per block: resident weights and the biases in shared memory
// (a global plan reads them in place), w0x as f32
template <bool GLOB>
__device__ __forceinline__ void load_constants(const Args& A, const Layers& L, const Plan& P,
                                               unsigned char* sm) {
  if constexpr (!GLOB) {
    for (int j = 1; j < L.n_layers; ++j) {
      if (L.d[j].w_sm < 0) continue;
      load_pass(L.wt(j), L.width(j - 1), L.width(j), 0, L.width(j), at<bf16>(sm, L.d[j].w_sm));
    }
    float* bias = at<float>(sm, P.bias);
    for (int f = threadIdx.x; f < P.sumw; f += (int)blockDim.x) bias[f] = L.b[f];
  }
  const int f0p = L.width(0);
  if (!A.fold) {
    float* w0xs = wide<GLOB, float>(A, P, sm, P.w0x);
    for (int e = threadIdx.x; e < 3 * f0p; e += (int)blockDim.x) w0xs[e] = bf(A.w0x[e]);
  }
  hop::cp_async_commit();
}

// The pipeline of both kernels: the tile's rows are copied in before its
// layer 0; then the next tile's rows (and the indices of the one after)
// are copied in while this tile's layers run.  Tiles t, t + step, ... go
// to one group; sm here is the group's own tile buffers.  A global plan's
// stage and centroid rows lie in the block's scratch.
template <bool GLOB>
struct Pipe {
  int* rid[2];
  float* xyz[2];
  float* cent[2];
  bf16* stage;
  int step;
  __device__ Pipe(const Args& A, const Plan& P, unsigned char* sm, int f0p, int step_)
      : step(step_) {
    const int cw = A.fold ? f0p : 3;
    stage = wide<GLOB, bf16>(A, P, sm, P.stage);
    for (int i = 0; i < 2; ++i) {
      rid[i] = at<int>(sm, P.rid) + i * P.tm;
      xyz[i] = A.fold ? nullptr : at<float>(sm, P.xyz) + i * P.tm * 3;
      cent[i] = wide<GLOB, float>(A, P, sm, P.cent) + i * A.cpt * cw;
    }
  }
  // before the first tile t
  __device__ void start(const Args& A, const Plan& P, const Group& G, int f0p, int t) {
    load_idx(A, P, G, t, rid[0]);
    hop::cp_async_commit();
    hop::cp_async_wait_all();
    G.sync();
    gather_tile<GLOB>(A, P, G, f0p, t, rid[0], stage, xyz[0], cent[0]);
    if (t + step < A.total) load_idx(A, P, G, t + step, rid[1]);
    hop::cp_async_commit();
    hop::cp_async_wait_all();
    hop::fence_async_smem();
    G.sync();
  }
  // once tile t (parity p) no longer needs the stage
  __device__ void prefetch(const Args& A, const Plan& P, const Group& G, int f0p, int t, int p) {
    if (t + step < A.total) {
      gather_tile<GLOB>(A, P, G, f0p, t + step, rid[p ^ 1], stage, xyz[p ^ 1], cent[p ^ 1]);
    }
    if (t + 2 * step < A.total) load_idx(A, P, G, t + 2 * step, rid[p]);
    hop::cp_async_commit();
  }
  __device__ void finish(const Group& G) {
    hop::cp_async_wait_all();
    hop::fence_async_smem();
    G.sync();
  }
};

// COUNT: the backward's count pass, on the backward's plan (its tiles of
// 128 rows, every layer's buffer apart): the last layer (or layer 0 of a
// one-layer stack) counts ties with the forward's maxima into A.cnt
template <bool GLOB, bool COUNT>
__global__ void __launch_bounds__(2 * kThreads, 1)
fused_group_mlp_kernel(Args A, Layers L0, Plan P) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layers L = bind_layers(L0, P, sm);
  const int f0p = L.width(0);
  const int nl = L.n_layers;
  const int nwg = blockDim.x >> 7, wg = threadIdx.x >> 7;
  // a tile per warpgroup (its buffers wg_bytes apart) or one per block
  const bool own = P.wg_bytes > 0;
  const Group G = own ? Group{(int)threadIdx.x & 127, 128, 1 + wg}
                      : Group{(int)threadIdx.x, (int)blockDim.x, 0};
  unsigned char* tsm = sm + (own ? wg * P.wg_bytes : 0);
  const int step = own ? gridDim.x * nwg : gridDim.x;
  int t = own ? blockIdx.x * nwg + wg : blockIdx.x;
  load_constants<GLOB>(A, L, P, sm);
  // a one-layer stack's maxima start at +0.0, the least relu value (COUNT:
  // its counts at 0)
  unsigned* mx = nl == 1 ? wide<GLOB, unsigned>(A, P, tsm, P.mx) : nullptr;
  if (mx) {
    for (int e = G.tid; e < A.cpt * f0p; e += G.nthr) mx[e] = 0u;
  }
  hop::cp_async_wait_all();
  hop::fence_async_smem();
  __syncthreads();
  if (t >= A.total) return;
  Pipe<GLOB> pipe(A, P, tsm, f0p, step);
  pipe.start(A, P, G, f0p, t);
  for (int it = 0; t < A.total; t += step, ++it) {
    const int p = it & 1;
    const Tile T = tile_of(A, P, t);
    layer0<COUNT>(A, P, G, f0p, pipe.stage, pipe.xyz[p], pipe.cent[p], biases<GLOB>(sm, P, L),
                  wide<GLOB, float>(A, P, sm, P.w0x), at<float>(tsm, P.geo),
                  act_of<GLOB>(A, P, L, tsm, 0), mx, T);
    hop::fence_async_smem();
    G.sync();
    if (mx) {
      store_max0<COUNT>(A, P, G, f0p, T, mx);
      pipe.prefetch(A, P, G, f0p, t, p);
    }
    for (int j = 1; j < nl; ++j) {
      layer_product<GLOB, COUNT>(A, L, P, sm, j, act_of<GLOB>(A, P, L, tsm, j - 1),
                                 j < nl - 1 ? act_of<GLOB>(A, P, L, tsm, j) : nullptr, T,
                                 own ? 0 : wg, own ? 1 : 2);
      // the last layer writes nothing a product reads: finish() syncs
      if (j < nl - 1 || nl == 2) {
        hop::fence_async_smem();
        G.sync();
      }
      // the stage (layer 0's activations) is free once layer 1 has read it
      if (j == 1) pipe.prefetch(A, P, G, f0p, t, p);
    }
    pipe.finish(G);
  }
}

// ---------------------------------------------------------------------------
// The backward's pieces.

// this warp's 16-row sums of columns c, c + 1 -> red[warp][c..]
__device__ __forceinline__ void put_warp_sums(const Frag& F, float* red, int c, float v0,
                                              float v1) {
  v0 = warp_rows_sum(v0);
  v1 = warp_rows_sum(v1);
  if (F.l < 4) {
    red[F.w * kRedCols + c] = v0;
    red[F.w * kRedCols + c + 1] = v1;
  }
}

// sum over the four warps' rows, in warp order, of columns 0 .. n - 1 of red
// added to acc[0 .. n - 1]
__device__ __forceinline__ void add_column_sums(const Frag& F, const float* red, int n,
                                                float* acc) {
  for (int c = F.t; c < n; c += 128) {
    acc[c] += ((red[c] + red[kRedCols + c]) + red[2 * kRedCols + c]) + red[3 * kRedCols + c];
  }
}

// The last layer, recomputed with the forward's product, and the tie split:
// dz_L = ct / (number of neighbours equal to the forward's max) where the
// activation equals it and is > 0 -> bf16 into the dz buffer; db_L.  SPAN
// (a centroid over two tiles): the counts come from the count pass, and
// the centroid's first tile adds db and the no-match count.
template <bool GLOB, bool SPAN>
__device__ __forceinline__ void tie_split(const Args& A, const Layers& L, const Plan& P,
                                          unsigned char* sm, const bf16* in, Tile T, float* db) {
  const Frag F;
  const int j = L.n_layers - 1;
  const int cin = L.width(j - 1), cout = L.width(j);
  const int np = n_pieces(cout, kCap), mt = P.tm >> 6;
  const bf16* W = GLOB ? nullptr : at<bf16>(sm, L.d[j].w_sm);
  bf16* dz = act_of<GLOB>(A, P, L, sm, j);
  float* red = at<float>(sm, P.red) + F.wg * 8 * kRedCols;
  float* gsc = at<float>(sm, P.gsc) + F.wg * 4 * kRedCols;
  const float* bias = bias_of<GLOB>(sm, P, L, j);
  // a 128-row centroid spans both warpgroups' 64-row blocks (they take the
  // same pieces in step): its ties are counted over both, and one of them
  // adds db and the no-match count
  const bool both = !SPAN && A.kp > 64;
  const int wpc = both || SPAN ? 4 : A.kp >> 4, ncent = both || SPAN ? 1 : 4 / wpc;
  auto sync = [&]() {
    if (both) {
      hop::bar_sync(kBothBar, 2 * 128);
    } else {
      hop::bar_sync(1 + F.wg, 128);
    }
  };
  auto start = [&](int it, float* d) {
    int n0;
    const int n = piece(cout, kCap, it / mt, &n0);
    if constexpr (GLOB) {
      staged<0, 1, kCap, true>(d, n, in, cin, 64 * (it % mt), L.wt(j), cout, n0, cin,
                               slot_a(sm, P, F.wg), slot_b(sm, P, F.wg), F.wg, F.t);
    } else {
      issue<0, 1, kCap>(d, n, in + cm_off(64 * (it % mt), 0, cin), cin,
                        W + cm_off(0, n0, cout), cout, cin >> 4);
    }
  };
  auto finish = [&](int it, const float* acc) {
    const int m = it % mt;
    int n0;
    const int n = piece(cout, kCap, it / mt, &n0);
    // this thread's two rows belong to one centroid
    const int lr = F.row(0);
    const int sc = T.s0 + ((64 * m + lr) >> A.kps);
    const int k0 = T.k0 + ((64 * m + lr) & (A.kp - 1));
    const bool valid = sc < A.s;
    const bool live0 = valid && k0 < A.k_real, live1 = valid && k0 + 8 < A.k_real;
    const float* orow = A.fwd_out + ((size_t)T.b * A.s + (valid ? sc : 0)) * cout + n0;
    // the forward's maxima and the biases of this thread's columns, loaded
    // before any store so the loads overlap
    float om[8][2], bv[8][2];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool in = 8 * n8 < n;
        om[n8][jj] = in && valid ? orow[F.col(n8) + jj] : 0.f;
        bv[n8][jj] = in ? bias[n0 + F.col(n8) + jj] : 0.f;
      }
    }
    // 1. the ties of each (centroid, column)
    if constexpr (!SPAN) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        if (8 * n8 < n) {
          const int c = F.col(n8);
          float cnt[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float bb = bv[n8][jj];
            const float o = om[n8][jj];
            const float a0 = fmaxf(acc[4 * n8 + jj] + bb, 0.f);
            const float a1 = fmaxf(acc[4 * n8 + 2 + jj] + bb, 0.f);
            cnt[jj] = (float)((live0 && a0 == o) + (live1 && a1 == o));
          }
          put_warp_sums(F, red, c, cnt[0], cnt[1]);
        }
      }
    }
    // (SPAN: the last item's reads of gsc are done before it is rewritten)
    sync();
    // 2. per column: each centroid's share g of the cotangent, and db_L:
    //    the rows that take g are the ties, where the maximum is > 0
    const bool adds = SPAN ? T.k0 == 0 && F.wg == 0 : !both || F.wg == 0;
    const float* red0 = at<float>(sm, P.red);  // both: warpgroup 0's, then 1's
    for (int c = F.t; c < n; c += 128) {
      float dbc = 0.f;
      for (int cl = 0; cl < ncent; ++cl) {
        float cnt = 0.f;
        if (SPAN) {
          if (T.s0 < A.s) cnt = (float)A.cnt[((size_t)T.b * A.s + T.s0) * cout + n0 + c];
        } else if (both) {
          for (int u = 0; u < 8; ++u) cnt += red0[((u >> 2) * 8 + (u & 3)) * kRedCols + c];
        } else {
          for (int u = 0; u < wpc; ++u) cnt += red[(cl * wpc + u) * kRedCols + c];
        }
        const int s2 = T.s0 + ((64 * m) >> A.kps) + cl;
        float g = 0.f;
        if (s2 < A.s) {
          if (cnt == 0.f && adds) atomicAdd(A.nomatch, 1);
          const size_t at2 = ((size_t)T.b * A.s + s2) * cout + n0 + c;
          g = A.ct[at2] / (cnt > 0.f ? cnt : 1.f);
          if (A.fwd_out[at2] > 0.f) dbc += g * cnt;
        }
        gsc[cl * kRedCols + c] = g;
      }
      if (adds) db[n0 + c] += dbc;
    }
    sync();
    // 3. dz_L (red and gsc are rewritten only after the next item's first
    //    barrier, which every thread reaches after this loop)
    const float* g = gsc + (lr >> A.kps) * kRedCols;
    bf16* dzb = dz + cm_off(64 * m + F.row(0), n0 + F.col(0), cout);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      if (8 * n8 < n) {
        const int c = F.col(n8);
        float d[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float bb = bv[n8][jj];
          const float o = om[n8][jj];
          const float a0 = fmaxf(acc[4 * n8 + jj] + bb, 0.f);
          const float a1 = fmaxf(acc[4 * n8 + 2 + jj] + bb, 0.f);
          d[0][jj] = (live0 && a0 == o && a0 > 0.f) ? g[c + jj] : 0.f;
          d[1][jj] = (live1 && a1 == o && a1 > 0.f) ? g[c + jj] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(dzb + i * 8 * cout + n8 * 64) =
              __floats2bfloat162_rn(d[i][0], d[i][1]);
        }
      }
    }
  };
  for_items<kCap / 2>(F.wg, 2, mt * np, start, finish);
}

// A one-layer stack's tie split: layer 0 is the last layer.  Its f32
// activations, recomputed by layer0_chunk as the forward formed them, are
// held against the forward's maxima; the ties of each (centroid, column)
// are counted in cnt (cpt x F0P, zero on entry and on return), the
// cotangent is split among them, db_0 and (fold) dcent = -sum_K dz_0 are
// formed, and bf16(dz_0) goes to dz (the F0P-wide rows, core layout).
// SPAN (a centroid over two tiles): the counts come from the count pass,
// and the centroid's first tile adds db, the no-match count and dcent.
template <bool GLOB, bool SPAN>
__device__ __forceinline__ void tie_split0(const Args& A, const Layers& L, const Plan& P,
                                           unsigned char* sm, int f0p, const bf16* stage,
                                           const float* xyzb, const float* centb, Tile T,
                                           float* db, bf16* dz) {
  const Group blk{(int)threadIdx.x, kThreads, 0};
  const int cpr = f0p >> 3, cpt = A.cpt;
  const float* b0s = biases<GLOB>(sm, P, L);
  const float* w0xs = wide<GLOB, float>(A, P, sm, P.w0x);
  float* geo = at<float>(sm, P.geo);
  int* cnt = wide<GLOB, int>(A, P, sm, P.mx);
  float* gs = wide<GLOB, float>(A, P, sm, P.gs);
  tile_geo(A, P, blk, xyzb, centb, geo);
  // the row's activations, the forward's maxima of its centroid and whether
  // the row is a real neighbour of a real centroid
  auto row_vals = [&](int q, int* r, int* c0, int* cl, float* v, float* o) {
    const Chunk ch = chunk_of(q, cpr);
    *r = ch.r;
    *c0 = ch.c8 * 8;
    *cl = *r >> A.kps;
    layer0_chunk(A, f0p, stage, centb, b0s, w0xs, geo, q, *r, *c0, *cl, v);
    const int sc = T.s0 + *cl;
    const bool live = sc < A.s && T.k0 + (*r & (A.kp - 1)) < A.k_real;
    const float* orow = A.fwd_out + ((size_t)T.b * A.s + (live ? sc : 0)) * f0p + *c0;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = live ? orow[e] : -1.f;  // -1: never equal
  };
  // 1. ties: the eight rows of a core (lanes 8i .. 8i + 7) summed, then one
  //    shared-memory add a column (integers: any order gives the same sum)
  for (int q = threadIdx.x; !SPAN && q < P.tm * cpr; q += kThreads) {
    int r, c0, cl;
    float v[8], o[8];
    row_vals(q, &r, &c0, &cl, v, o);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int k = v[e] == o[e];
      k += __shfl_xor_sync(0xffffffffu, k, 1);
      k += __shfl_xor_sync(0xffffffffu, k, 2);
      k += __shfl_xor_sync(0xffffffffu, k, 4);
      if ((q & 7) == 0 && k) atomicAdd(cnt + cl * f0p + c0 + e, k);
    }
  }
  __syncthreads();
  // 2. per column: each centroid's share g, db_0 and (fold) dcent; a
  //    thread takes a column's centroids in order
  const bool adds = !SPAN || T.k0 == 0;
  for (int c = threadIdx.x; c < f0p; c += kThreads) {
    float dbc = 0.f;
    for (int cl = 0; cl < cpt; ++cl) {
      const int sc = T.s0 + cl;
      const size_t at2 = ((size_t)T.b * A.s + (sc < A.s ? sc : 0)) * f0p + c;
      const float k = (float)(SPAN ? A.cnt[at2] : cnt[cl * f0p + c]);
      if (!SPAN) cnt[cl * f0p + c] = 0;
      float g = 0.f;
      if (sc < A.s) {
        if (k == 0.f && adds) atomicAdd(A.nomatch, 1);
        g = A.ct[at2] / (k > 0.f ? k : 1.f);
        const float d = A.fwd_out[at2] > 0.f ? g * k : 0.f;
        dbc += d;
        if (A.fold && adds) A.dcent[at2] = -d;
      }
      gs[cl * f0p + c] = g;
    }
    if (adds) db[c] += dbc;
  }
  __syncthreads();
  // 3. dz_0 = g where the row ties the maximum and the maximum is > 0
  for (int q = threadIdx.x; q < P.tm * cpr; q += kThreads) {
    int r, c0, cl;
    float v[8], o[8];
    row_vals(q, &r, &c0, &cl, v, o);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d0 = v[2 * e] == o[2 * e] && v[2 * e] > 0.f ? gs[cl * f0p + c0 + 2 * e] : 0.f;
      const float d1 =
          v[2 * e + 1] == o[2 * e + 1] && v[2 * e + 1] > 0.f ? gs[cl * f0p + c0 + 2 * e + 1] : 0.f;
      w[e] = __bfloat16_as_ushort(__float2bfloat16_rn(d0)) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(d1)) << 16);
    }
    *reinterpret_cast<uint4*>(dz + 8 * q) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dW_i += bf16(a_{i-1})^T bf16(dz_i) over the tile's rows, into the block's
// partial: M = cin in 64-row blocks (the last one's overhang is computed
// and dropped), both operands read MN-major
template <bool GLOB>
__device__ __forceinline__ void dw_product(const Layers& L, const Plan& P, unsigned char* sm,
                                           int i, const bf16* aprev, const bf16* dz, float* dW) {
  const Frag F;
  const int cin = L.width(i - 1), cout = L.width(i);
  const int mt = (cin + 63) >> 6;
  const int cap = mt * ((cout + 127) >> 7) >= 2 ? 128 : 64;
  const int np = n_pieces(cout, cap);
  auto start = [&](int it, float* d) {
    int n0;
    const int n = piece(cout, cap, it / mt, &n0);
    if constexpr (GLOB) {
      staged<1, 1, 128, false>(d, n, aprev, cin, 64 * (it % mt), dz, cout, n0, P.tm,
                               slot_a(sm, P, F.wg), slot_b(sm, P, F.wg), F.wg, F.t);
    } else {
      issue<1, 1, 128>(d, n, aprev + cm_off(0, 64 * (it % mt), cin), cin,
                       dz + cm_off(0, n0, cout), cout, P.tm >> 4);
    }
  };
  auto finish = [&](int it, const float* acc) {
    const int m = it % mt;
    int n0;
    const int n = piece(cout, cap, it / mt, &n0);
    // all loads of the partial first, then the adds and stores: one round
    // trip to L2 per half, not one per element
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v[8][2];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * m + F.row(h);
          if (8 * (8 * half + n8) < n && r < cin) {
            v[n8][h] = *reinterpret_cast<const float2*>(
                dW + (size_t)r * cout + n0 + F.col(8 * half + n8));
          }
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * m + F.row(h);
          const int a = 4 * (8 * half + n8) + 2 * h;
          if (8 * (8 * half + n8) < n && r < cin) {
            *reinterpret_cast<float2*>(dW + (size_t)r * cout + n0 + F.col(8 * half + n8)) =
                make_float2(v[n8][h].x + acc[a], v[n8][h].y + acc[a + 1]);
          }
        }
      }
    }
  };
  for_items<64>(F.wg, 2, mt * np, start, finish);
}

// dz_{i-1} = (bf16(dz_i) bf16(W_i)^T) * [a_{i-1} > 0], written as bf16 over
// a_{i-1} in place; db_{i-1}; for i = 1 in fold mode dcent = -sum_K dz_0
// (SPAN: each tile's rows added into the zeroed dcent: two addends onto
// zero, the same bits in either order)
template <bool GLOB, bool SPAN>
__device__ __forceinline__ void dz_product(const Args& A, const Layers& L, const Plan& P,
                                           unsigned char* sm, int i, const bf16* dz, bf16* aprev,
                                           Tile T, float* db) {
  const Frag F;
  const int cin = L.width(i - 1), cout = L.width(i);
  const int mt = P.tm >> 6;
  const int cap = mt * ((cin + 127) >> 7) >= 2 ? 128 : 64;
  const int np = n_pieces(cin, cap);
  const bf16* W = GLOB ? nullptr : at<bf16>(sm, L.d[i].w_sm);
  float* red = at<float>(sm, P.red) + F.wg * 8 * kRedCols;
  float* cred = at<float>(sm, P.gsc) + F.wg * 4 * kRedCols;
  const bool dcent = i == 1 && A.fold;
  // dcent of a 128-row centroid sums both warpgroups' blocks (same pieces in
  // step); warpgroup 0 writes it
  const bool both = dcent && A.kp > 64;
  const int wpc = A.kp >> 4, ncent = both ? 1 : 4 / wpc;
  auto sync = [&]() {
    if (both) {
      hop::bar_sync(kBothBar, 2 * 128);
    } else {
      hop::bar_sync(1 + F.wg, 128);
    }
  };
  auto start = [&](int it, float* d) {
    int n0;
    const int n = piece(cin, cap, it / mt, &n0);
    if constexpr (GLOB) {
      staged<0, 0, 128, true>(d, n, dz, cout, 64 * (it % mt), L.wt(i), cout, n0, cout,
                              slot_a(sm, P, F.wg), slot_b(sm, P, F.wg), F.wg, F.t);
    } else {
      issue<0, 0, 128>(d, n, dz + cm_off(64 * (it % mt), 0, cout), cout,
                       W + cm_off(n0, 0, cout), cout, cout >> 4);
    }
  };
  auto finish = [&](int it, const float* acc) {
    const int m = it % mt;
    int n0;
    const int n = piece(cin, cap, it / mt, &n0);
    const int lr = F.row(0);
    const int sc = T.s0 + ((64 * m + lr) >> A.kps);
    const int k0 = T.k0 + ((64 * m + lr) & (A.kp - 1));
    const bool live0 = sc < A.s && k0 < A.k_real, live1 = sc < A.s && k0 + 8 < A.k_real;
    bf16* ab = aprev + cm_off(64 * m + F.row(0), n0 + F.col(0), cin);
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      if (8 * n8 < n) {
        const int c = F.col(n8);
        float d[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* pa = reinterpret_cast<__nv_bfloat162*>(ab + h * 8 * cin + n8 * 64);
          const __nv_bfloat162 a = *pa;
          d[h][0] = __low2float(a) > 0.f ? acc[4 * n8 + 2 * h] : 0.f;
          d[h][1] = __high2float(a) > 0.f ? acc[4 * n8 + 2 * h + 1] : 0.f;
          *pa = __floats2bfloat162_rn(d[h][0], d[h][1]);
        }
        put_warp_sums(F, red, c, d[0][0] + d[1][0], d[0][1] + d[1][1]);
        if (dcent) {
          put_warp_sums(F, cred, c, (live0 ? d[0][0] : 0.f) + (live1 ? d[1][0] : 0.f),
                        (live0 ? d[0][1] : 0.f) + (live1 ? d[1][1] : 0.f));
        }
      }
    }
    sync();
    add_column_sums(F, red, n, db + n0);
    if (both) {
      const float* cred0 = at<float>(sm, P.gsc);  // warpgroup 0's, then 1's
      for (int c = F.t; F.wg == 0 && c < n; c += 128) {
        float sum = 0.f;
        for (int u = 0; u < 8; ++u) sum += cred0[((u >> 2) * 4 + (u & 3)) * kRedCols + c];
        if (T.s0 < A.s) {
          float* dst = A.dcent + ((size_t)T.b * A.s + T.s0) * cin + n0 + c;
          if (SPAN) {
            atomicAdd(dst, -sum);
          } else {
            *dst = -sum;
          }
        }
      }
    } else if (dcent) {
      for (int e = F.t; e < ncent * n; e += 128) {
        const int cl = e / n, c = e - cl * n;
        float sum = 0.f;
        for (int u = 0; u < wpc; ++u) sum += cred[(cl * wpc + u) * kRedCols + c];
        const int s2 = T.s0 + ((64 * m) >> A.kps) + cl;
        if (s2 < A.s) A.dcent[((size_t)T.b * A.s + s2) * cin + n0 + c] = -sum;
      }
    }
    sync();
  };
  for_items<64>(F.wg, 2, mt * np, start, finish);
}

// layer 0's backward on bf16(dz_0) (dz0s, the tile's F0P-wide rows):
// the rows to global memory for the scatter; hilo: drel, dcent, dw0x (from
// the geometry layer 0 left in P.geo) and bf16(drel).  SPAN: each tile's
// share of a centroid's dcent is added into the zeroed dcent
template <bool GLOB, bool SPAN>
__device__ __forceinline__ void layer0_bwd(const Args& A, const Plan& P, unsigned char* sm,
                                           int f0p, const bf16* dz0s, Tile T) {
  const int cpr = f0p >> 3;
  for (int q = threadIdx.x; q < P.tm * cpr; q += kThreads) {
    const Chunk ch = chunk_of(q, cpr);
    const int r = ch.r, c8 = ch.c8;
    const int sc = T.s0 + (r >> A.kps);
    if (sc < A.s) {
      // streaming stores: read once by the scatter, they should not push the
      // dW partials out of L2
      __stcs(reinterpret_cast<uint4*>(A.dz0 + (((size_t)T.b * A.s + sc) * A.kp + T.k0 +
                                               (r & (A.kp - 1))) * f0p + 8 * c8),
             *reinterpret_cast<const uint4*>(dz0s + 8 * q));
    }
  }
  if (A.fold) return;
  float* geo = at<float>(sm, P.geo);
  float* drel = at<float>(sm, P.drel);
  const float* w0xs = wide<GLOB, float>(A, P, sm, P.w0x);
  float* dw0x = wide<GLOB, float>(A, P, sm, P.dw0x);
  // drel: warp w takes rows w, w + 8, ..., its lanes the columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < P.tm; r += kThreads / 32) {
    float s3[3] = {0.f, 0.f, 0.f};
    for (int f = lane; f < f0p; f += 32) {
      const float d = bf(dz0s[cm_off(r, f, f0p)]);
#pragma unroll
      for (int c = 0; c < 3; ++c) s3[c] += d * w0xs[c * f0p + f];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s3[c] += __shfl_xor_sync(0xffffffffu, s3[c], o);
    }
    if (lane == 0) {
      drel[3 * r] = s3[0];
      drel[3 * r + 1] = s3[1];
      drel[3 * r + 2] = s3[2];
    }
  }
  __syncthreads();
  // a centroid's rows in this tile: kp, or (SPAN) the tile's tm
  const int rows = SPAN ? P.tm : A.kp;
  for (int e = threadIdx.x; e < A.cpt * 3; e += kThreads) {
    const int cl = e / 3, c = e - 3 * cl;
    const int sc = T.s0 + cl;
    if (sc >= A.s) continue;
    float sum = 0.f;
    for (int k = 0; k < rows && T.k0 + k < A.k_real; ++k) sum += drel[(cl * rows + k) * 3 + c];
    float* dst = A.dcent + ((size_t)T.b * A.s + sc) * 3 + c;
    if (SPAN) {
      atomicAdd(dst, -sum);
    } else {
      *dst = -sum;
    }
  }
  for (int e = threadIdx.x; e < P.tm * 3; e += kThreads) {
    const int r = e / 3;
    const int sc = T.s0 + (r >> A.kps);
    if (sc < A.s) {
      A.drel[(((size_t)T.b * A.s + sc) * A.kp + T.k0 + (r & (A.kp - 1))) * 3 + (e - 3 * r)] =
          __float2bfloat16_rn(drel[e]);
    }
  }
  // dw0x: item (h, f) sums the six geometry lanes against column f over
  // the h-th of `halves` row ranges; the ranges are added in order
  float* wsum = wide<GLOB, float>(A, P, sm, P.wsum);
  const int halves = f0p < kThreads ? kThreads / f0p : 1;
  for (int w = threadIdx.x; w < halves * f0p; w += kThreads) {
    const int h = w / f0p, f = w - h * f0p;
    float acc6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = h * P.tm / halves; r < (h + 1) * P.tm / halves; ++r) {
      const float d = bf(dz0s[cm_off(r, f, f0p)]);
#pragma unroll
      for (int c = 0; c < 6; ++c) acc6[c] += geo[6 * r + c] * d;
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) wsum[(h * 6 + c) * f0p + f] = acc6[c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 6 * f0p; e += kThreads) {
    float sum = 0.f;
    for (int h = 0; h < halves; ++h) sum += wsum[h * 6 * f0p + e];
    dw0x[e] += sum;
  }
}

// ONE: a one-layer stack (compiled apart: the branch beside the deeper
// stacks' loop cost their backward 4-25% on the card); SPAN: a centroid
// over two tiles (256 neighbours), its tie counts from the count pass
template <bool GLOB, bool ONE, bool SPAN>
__global__ void __launch_bounds__(kThreads, 1)
fused_group_mlp_bwd_kernel(Args A, Layers L0, Plan P) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layers L = bind_layers(L0, P, sm);
  const int f0p = L.width(0);
  const int nl = L.n_layers;
  const int sumw = P.sumw;
  int t = blockIdx.x;
  if (t >= A.total) return;
  float* db = wide<GLOB, float>(A, P, sm, P.dbacc);
  for (int e = threadIdx.x; e < 2 * sumw; e += kThreads) db[e] = 0.f;
  if (!A.fold) {
    float* dw0x = wide<GLOB, float>(A, P, sm, P.dw0x);
    for (int e = threadIdx.x; e < 6 * f0p; e += kThreads) dw0x[e] = 0.f;
  }
  float* slot = A.part + (size_t)blockIdx.x * P.g_size;
  const Frag F;
  float* db_wg = db + F.wg * sumw - L.d[0].db;  // indexed by partial-slot offsets
  const Group blk{(int)threadIdx.x, kThreads, 0};
  load_constants<GLOB>(A, L, P, sm);
  if constexpr (ONE && !SPAN) {
    int* cnt = wide<GLOB, int>(A, P, sm, P.mx);
    for (int e = threadIdx.x; e < A.cpt * f0p; e += kThreads) cnt[e] = 0;
  }
  Pipe<GLOB> pipe(A, P, sm, f0p, gridDim.x);
  pipe.start(A, P, blk, f0p, t);
  for (int it = 0; t < A.total; t += gridDim.x, ++it) {
    const int p = it & 1;
    const Tile T = tile_of(A, P, t);
    bf16* a0 = act_of<GLOB>(A, P, L, sm, 0);
    if constexpr (ONE) {
      tie_split0<GLOB, SPAN>(A, L, P, sm, f0p, pipe.stage, pipe.xyz[p], pipe.cent[p], T,
                             db_wg + L.d[0].db, a0);
      __syncthreads();
      pipe.prefetch(A, P, blk, f0p, t, p);
      layer0_bwd<GLOB, SPAN>(A, P, sm, f0p, a0, T);
      pipe.finish(blk);
      continue;
    }
    layer0<false>(A, P, blk, f0p, pipe.stage, pipe.xyz[p], pipe.cent[p], biases<GLOB>(sm, P, L),
                  wide<GLOB, float>(A, P, sm, P.w0x), at<float>(sm, P.geo), a0, nullptr, T);
    hop::fence_async_smem();
    __syncthreads();
    pipe.prefetch(A, P, blk, f0p, t, p);
    // ---- recompute, bit-identical to the forward kernel ----
    for (int j = 1; j < nl - 1; ++j) {
      layer_product<GLOB, false>(A, L, P, sm, j, act_of<GLOB>(A, P, L, sm, j - 1),
                                 act_of<GLOB>(A, P, L, sm, j), T, F.wg, 2);
      hop::fence_async_smem();
      __syncthreads();
    }
    tie_split<GLOB, SPAN>(A, L, P, sm, act_of<GLOB>(A, P, L, sm, nl - 2), T,
                          db_wg + L.d[nl - 1].db);
    hop::fence_async_smem();
    __syncthreads();
    // ---- back through the layers; dz_i lives in act[i] ----
    for (int i = nl - 1; i >= 1; --i) {
      const bf16* dz = act_of<GLOB>(A, P, L, sm, i);
      bf16* aprev = act_of<GLOB>(A, P, L, sm, i - 1);
      dw_product<GLOB>(L, P, sm, i, aprev, dz, slot + L.d[i].dw);
      __syncthreads();
      dz_product<GLOB, SPAN>(A, L, P, sm, i, dz, aprev, T, db_wg + L.d[i - 1].db);
      hop::fence_async_smem();
      __syncthreads();
    }
    layer0_bwd<GLOB, SPAN>(A, P, sm, f0p, a0, T);
    pipe.finish(blk);
  }
  for (int e = threadIdx.x; e < sumw; e += kThreads) slot[L.d[0].db + e] = db[e] + db[sumw + e];
  if (!A.fold) {
    const float* dw0x = wide<GLOB, float>(A, P, sm, P.dw0x);
    for (int e = threadIdx.x; e < 6 * f0p; e += kThreads) slot[P.g_dw0x + e] = dw0x[e];
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

// ---------------------------------------------------------------------------
// Host side: shapes, shared-memory plans, launches.

// the kernels' reach in padded neighbours: the TPU predicates' (a chunk of
// 8 centroids at _MAX_ROWS = 8192 rows forward, _MAX_ROWS_BWD = 2048 backward)
constexpr int kMaxKp = 1024;
constexpr int kMaxKpBwd = 256;

// a stack's layer table and partial-slot layout, from the widths
struct Stack {
  std::vector<LayerDesc> d;
  int sumw = 0, g_dw0x = 0, g_size = 0;
  int n() const { return (int)d.size(); }
  int width(int j) const { return d[j].width; }
};

// false on a shape the kernels do not take: kp a power of two from 16 to
// max_kp, widths positive multiples of 16
bool make_stack(int n_layers, int kp, int max_kp, const int* widths, Stack* S) {
  if (n_layers < 1 || kp < 16 || kp > max_kp || (kp & (kp - 1))) return false;
  S->d.assign(n_layers, LayerDesc{});
  long long w_off = 0, g = 0, sumw = 0;
  for (int j = 0; j < n_layers; ++j) {
    if (widths[j] <= 0 || widths[j] % 16) return false;
    LayerDesc& e = S->d[j];
    e.width = widths[j];
    e.w_sm = e.act = -1;
    if (j) {
      e.w_off = (int)w_off;
      e.dw = (int)g;
      w_off += (long long)widths[j - 1] * widths[j];
      g += (long long)widths[j - 1] * widths[j];
    }
  }
  for (int j = 0; j < n_layers; ++j) {
    S->d[j].b_off = (int)sumw;
    S->d[j].db = (int)g;
    sumw += widths[j];
    g += widths[j];
  }
  S->sumw = (int)sumw;
  S->g_dw0x = (int)g;
  g += 6LL * widths[0];
  S->g_size = (int)g;
  return g <= INT_MAX;
}

// the layer table on the current device: copied once per distinct table
// (a host sync at its first launch) and kept for the process
const LayerDesc* device_table(const std::vector<LayerDesc>& d) {
  struct Entry {
    int dev;
    std::vector<LayerDesc> d;
    LayerDesc* p;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const size_t bytes = d.size() * sizeof(LayerDesc);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : seen) {
    if (e.dev == dev && e.d.size() == d.size() && !std::memcmp(e.d.data(), d.data(), bytes)) {
      return e.p;
    }
  }
  LayerDesc* p = nullptr;
  if (cudaMalloc(&p, bytes) != cudaSuccess) return nullptr;
  if (cudaMemcpy(p, d.data(), bytes, cudaMemcpyHostToDevice) != cudaSuccess) {
    cudaFree(p);
    return nullptr;
  }
  seen.push_back({dev, d, p});
  return p;
}

// the shared-memory layout of one block for tile rows tm, the layers in
// `streamed` streamed (forward only), forward or backward buffers; own > 0:
// that many warpgroups each with tile buffers of their own, after the
// block's shared regions; glob: every buffer whose size grows with the
// widths in the block's global scratch, every product staged.  Fills the
// table's w_sm and act.
Plan layout(Stack& S, int kp, int fold, int tm, const std::vector<char>& streamed, bool bwd,
            int own = 0, bool glob = false) {
  Plan P;
  long long off = 0;
  auto take = [&](long long bytes) {
    const int o = (int)std::min<long long>(off, INT_MAX);
    off += (bytes + 127) / 128 * 128;
    return o;
  };
  long long scratch = 0;
  auto take_global = [&](long long bytes) {
    const int o = (int)std::min<long long>(scratch, INT_MAX);
    scratch += (bytes + 127) / 128 * 128;
    return o;
  };
  auto take_wide = [&](long long bytes) { return glob ? take_global(bytes) : take(bytes); };
  const int nl = S.n(), f0p = S.width(0), cpt = std::max(1, tm / kp);
  const int groups = own ? own : 2;  // warpgroups with reduction scratch
  P.tm = tm;
  P.glob = glob;
  P.slot = 0;
  P.sumw = S.sumw;
  P.g_dw0x = S.g_dw0x;
  P.g_size = S.g_size;
  for (LayerDesc& e : S.d) e.w_sm = e.act = -1;
  // the block's own regions
  P.desc = glob ? -1 : take((long long)nl * sizeof(LayerDesc));
  for (int j = 1; j < nl && !glob; ++j) {
    if (streamed[j]) {
      P.slot = std::max(P.slot, S.width(j - 1) * 2 * kStreamCap * 2);
    } else {
      S.d[j].w_sm = take((long long)S.width(j - 1) * S.width(j) * 2);
    }
  }
  P.ring = P.slot ? take(2LL * P.slot) : -1;
  P.sa = glob ? take(2LL * 64 * kStageK * 2) : -1;
  P.sb = glob ? take(2LL * kStageK * 128 * 2) : -1;
  P.bias = glob ? -1 : take((long long)S.sumw * 4);
  P.w0x = fold ? -1 : take_wide(3LL * f0p * 4);
  P.red = take((long long)groups * 8 * kRedCols * 4);  // two halves a warpgroup
  P.gsc = bwd ? take(2LL * 4 * kRedCols * 4) : -1;
  P.dbacc = P.dw0x = P.geo = P.drel = P.wsum = P.mx = P.gs = -1;
  if (bwd) {
    P.dbacc = take_wide(2LL * S.sumw * 4);
    if (!fold) {
      P.dw0x = take_wide(6LL * f0p * 4);
      P.drel = take((long long)tm * 3 * 4);
      P.wsum = take_wide(6LL * std::max(kThreads, f0p) * 4);
    }
    if (nl == 1) {  // the tie counts and shares of a one-layer stack
      P.mx = take_wide((long long)cpt * f0p * 4);
      P.gs = take_wide((long long)cpt * f0p * 4);
    }
  }
  // the tile's regions (repeated for each warpgroup that owns its tiles)
  const long long tile0 = off;
  P.stage = take_wide((long long)tm * f0p * 2);
  if (bwd) {
    // every layer's activations stay for the backward pass; act[L-1]: dz_L
    for (int j = 0; j < nl; ++j) {
      const long long bytes = (long long)tm * S.width(j) * 2;
      S.d[j].act = glob ? take_global(bytes) : take(bytes + kSlack);
    }
  } else {
    // layer 0 rewrites the gathered rows in place (the next tile's rows land
    // there once layer 1 has read them); deeper layers alternate between two
    // more buffers
    int odd = 0, even = 0;
    for (int j = 1; j < nl - 1; ++j) {
      int& w = j & 1 ? odd : even;
      w = std::max(w, S.width(j));
    }
    auto buf = [&](int w) { return w ? take_wide((long long)tm * w * 2) : -1; };
    const int b = buf(odd), c = buf(even);
    S.d[0].act = P.stage;
    for (int j = 1; j < nl - 1; ++j) S.d[j].act = (j & 1) ? b : c;
    if (nl == 1) P.mx = take_wide((long long)cpt * f0p * 4);  // the tile's maxima
  }
  P.rid = take(2LL * tm * 4);
  P.xyz = fold ? -1 : take(2LL * tm * 3 * 4);
  P.cent = take_wide(2LL * cpt * (fold ? f0p : 3) * 4);
  P.geo = fold ? -1 : take((long long)tm * 6 * 4);
  const long long wg_bytes = own ? off - tile0 : 0;
  const long long bytes = off + (own ? (own - 1) * wg_bytes : 0);
  P.wg_bytes = (int)std::min<long long>(wg_bytes, INT_MAX);
  P.bytes = (int)std::min<long long>(bytes, INT_MAX);  // past kMaxSmem: refused
  P.scratch = (int)std::min<long long>(scratch, INT_MAX);
  if (scratch > INT_MAX) P.bytes = INT_MAX;  // refused
  return P;
}

// blocks of `kernel` with `smem` bytes resident on one SM of the current
// device (remembered: the queries cost more than a small launch)
int blocks_per_sm(const void* kernel, int smem, int threads = kThreads) {
  struct Entry {
    int dev;
    const void* kernel;
    int smem, threads, nb;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : seen) {
    if (e.dev == dev && e.kernel == kernel && e.smem == smem && e.threads == threads) return e.nb;
  }
  int nb = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, threads, smem) != cudaSuccess) {
    return 0;
  }
  seen.push_back({dev, kernel, smem, threads, nb});
  return nb;
}

// 1: every launch takes the global plan (to hold it against the others)
int force_global = 0;

using Kernel = void (*)(Args, Layers, Plan);

// the forward's instantiation for a plan (count: the backward's count pass)
Kernel fwd_kernel(bool glob, bool count) {
  if (count) {
    return glob ? fused_group_mlp_kernel<true, true> : fused_group_mlp_kernel<false, true>;
  }
  return glob ? fused_group_mlp_kernel<true, false> : fused_group_mlp_kernel<false, false>;
}

// The forward's plan.  With every weight resident, as many warpgroups (up
// to four) as fit each walk 64-row tiles of their own, so one's epilogue
// overlaps another's products; where fewer than two fit, the block's two
// warpgroups share 64- or 128-row tiles (the size that keeps the most rows
// in flight), and where no tile fits, 64-row tiles with the largest layers
// streamed.  A tile holds whole centroids up to 64 neighbours; 128 and more
// take 128-row tiles only.  Where none of these fits (activations or a
// streamed layer too wide, or 128 neighbours past the resident plans), the
// global plan: its shared memory is the same at every shape, so every shape
// has a plan.  -> blocks per SM (0: no plan fits) and the block's threads;
// the table's buffers are the chosen plan's.
int plan_forward(Stack& S, int kp, int fold, Plan* out, int* threads) {
  const void* kernel = reinterpret_cast<const void*>(fwd_kernel(false, false));
  const std::vector<char> none(S.n(), 0);
  *threads = kThreads;
  for (int own = 4; own >= 2 && kp <= 64 && !force_global; --own) {
    const Plan P = layout(S, kp, fold, 64, none, false, own);
    if (P.bytes > kMaxSmem) continue;
    const int nb = blocks_per_sm(kernel, P.bytes, own * 128);
    if (nb > 0) {
      *out = P;
      *threads = own * 128;
      return nb;
    }
  }
  int best = 0, best_nb = 0, best_tm = 0;
  for (int tm = 128; tm >= 64 && tm >= std::min(kp, 128) && !force_global; tm -= 64) {
    const Plan P = layout(S, kp, fold, tm, none, false);
    if (P.bytes > kMaxSmem) continue;
    const int nb = blocks_per_sm(kernel, P.bytes);
    if (nb > 0 && tm * nb >= best) {
      best = tm * nb;
      best_nb = nb;
      best_tm = tm;
    }
  }
  if (best_nb) {
    *out = layout(S, kp, fold, best_tm, none, false);
    return best_nb;
  }
  std::vector<char> streamed(S.n(), 0);
  while (kp <= 64 && !force_global) {
    const Plan P = layout(S, kp, fold, 64, streamed, false);
    if (P.bytes <= kMaxSmem) {
      *out = P;
      return blocks_per_sm(kernel, P.bytes);
    }
    int jmax = 0;
    long long wmax = 0;
    for (int j = 1; j < S.n(); ++j) {
      const long long wb = (long long)S.width(j - 1) * S.width(j);
      if (!streamed[j] && wb > wmax) {
        wmax = wb;
        jmax = j;
      }
    }
    if (!jmax) break;
    streamed[jmax] = 1;
  }
  const Plan P = layout(S, kp, fold, kp > 64 ? 128 : 64, none, false, 0, true);
  if (P.bytes > kMaxSmem) return 0;
  *out = P;
  return blocks_per_sm(reinterpret_cast<const void*>(fwd_kernel(true, false)), P.bytes);
}

// the backward's instantiation for a plan
Kernel bwd_kernel(bool glob, bool one, bool span) {
  if (span) {
    if (one) {
      return glob ? fused_group_mlp_bwd_kernel<true, true, true>
                  : fused_group_mlp_bwd_kernel<false, true, true>;
    }
    return glob ? fused_group_mlp_bwd_kernel<true, false, true>
                : fused_group_mlp_bwd_kernel<false, false, true>;
  }
  if (one) {
    return glob ? fused_group_mlp_bwd_kernel<true, true, false>
                : fused_group_mlp_bwd_kernel<false, true, false>;
  }
  return glob ? fused_group_mlp_bwd_kernel<true, false, false>
              : fused_group_mlp_bwd_kernel<false, false, false>;
}

// The backward's plan: resident weights, 128-row tiles where they fit (half
// the dW partial traffic per row), else 64 (never for 128 neighbours or
// more: a centroid then spans at most two tiles); where neither fits, the
// global plan (its shared memory the same at every shape), 128-row tiles
// where they fit.  -> blocks per SM, 0: none fits.
int plan_backward(Stack& S, int kp, int fold, Plan* out) {
  const std::vector<char> none(S.n(), 0);
  for (int glob = force_global; glob <= 1; ++glob) {
    for (int tm = 128; tm >= 64 && tm >= std::min(kp, 128); tm -= 64) {
      const Plan P = layout(S, kp, fold, tm, none, true, 0, glob);
      if (P.bytes > kMaxSmem) continue;
      *out = P;
      return blocks_per_sm(
          reinterpret_cast<const void*>(bwd_kernel(glob, S.n() == 1, kp > tm)), P.bytes);
    }
  }
  return 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// A's tile map for the plan (A->kp and A->s set)
void set_tiles(const Plan& P, int batch, Args* A) {
  A->kps = __builtin_ctz(A->kp);
  A->cpt = std::max(1, P.tm / A->kp);
  const int ppc = std::max(1, A->kp / P.tm);
  A->ppcs = __builtin_ctz(ppc);
  A->tiles_per_b = (A->s + A->cpt - 1) / A->cpt * ppc;
  A->total = batch * A->tiles_per_b;
}

}  // namespace

// The forward's global scratch in bytes (0: its plan keeps the activations
// in shared memory; -1: no plan takes the shape).
extern "C" long long fused_group_mlp_scratch(int fold, int batch, int s, int kp, int n_layers,
                                             const int* widths) {
  Stack S;
  Plan P;
  int threads;
  if (!make_stack(n_layers, kp, kMaxKp, widths, &S)) return -1;
  const int nb = plan_forward(S, kp, fold, &P, &threads);
  if (nb <= 0) return -1;
  if (!P.glob) return 0;
  Args A = {};
  A.s = s;
  A.kp = kp;
  set_tiles(P, batch, &A);
  return (long long)std::min(A.total, nb * sm_count()) * P.scratch;
}

// The forward.  table (batch, n, f0p) bf16; xyz (batch, n, 3) f32 (hilo);
// cent (batch, s, f0p) fold | (batch, s, 3) hilo; w0x (3, f0p) bf16 (hilo);
// idx (batch, s, kp) int32, kp a power of two from 16 to 1024; ws: the
// padded bf16 weights of layers 1.. back to back (null for one layer); bs:
// the padded f32 biases of every layer back to back; out (batch, s, cout)
// f32, zeroed where kp is past 64; scratch: fused_group_mlp_scratch() bytes.
extern "C" int fused_group_mlp_launch(int fold, const void* table, const float* xyz,
                                      const float* cent, const void* w0x, const int* idx,
                                      int batch, int n, int s, int kp, int n_layers,
                                      const void* ws, const float* bs, const int* widths,
                                      float* out, void* scratch, long long scratch_bytes,
                                      void* stream) {
  Stack S;
  Plan P;
  int threads;
  if (!make_stack(n_layers, kp, kMaxKp, widths, &S)) return (int)cudaErrorInvalidValue;
  const int nb = plan_forward(S, kp, fold, &P, &threads);
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  const LayerDesc* table_d = device_table(S.d);
  if (!table_d) return (int)cudaErrorMemoryAllocation;
  const Layers L{table_d, static_cast<const bf16*>(ws), bs, n_layers};
  Args A = {};
  A.fold = fold;
  A.table = static_cast<const bf16*>(table);
  A.xyz = xyz;
  A.cent = cent;
  A.w0x = static_cast<const bf16*>(w0x);
  A.idx = idx;
  A.scratch = static_cast<unsigned char*>(scratch);
  A.n = n;
  A.s = s;
  A.kp = kp;
  A.k_real = kp;
  A.out = out;
  set_tiles(P, batch, &A);
  if (A.total == 0) return 0;
  const int per_block = P.wg_bytes > 0 ? threads / 128 : 1;  // tiles a block takes at once
  const int grid = std::min((A.total + per_block - 1) / per_block, nb * sm_count());
  if (P.glob && scratch_bytes < (long long)grid * P.scratch) return (int)cudaErrorInvalidValue;
  fwd_kernel(P.glob, false)<<<grid, threads, P.bytes, static_cast<cudaStream_t>(stream)>>>(A, L,
                                                                                           P);
  return (int)cudaGetLastError();
}

// on != 0: every later launch takes the global plan, whatever else fits (a
// check that the plans compute the same bits); 0: the plans as chosen.
extern "C" void fused_group_mlp_force_global(int on) { force_global = on; }

// The size in floats of one partial slot (and of `grads`) for these widths
// (-1 for widths the kernels do not take).
extern "C" int fused_group_mlp_grad_size(int n_layers, const int* widths) {
  Stack S;
  return make_stack(n_layers, 16, kMaxKp, widths, &S) ? S.g_size : -1;
}

// The backward's grid (its number of partial slots); <= 0 if the shape does
// not fit.  *scratch: its global scratch in bytes (0 for a plan that keeps
// the activations in shared memory).
extern "C" int fused_group_mlp_bwd_grid(int fold, int batch, int s, int kp, int n_layers,
                                        const int* widths, long long* scratch) {
  Stack S;
  Plan P;
  if (!make_stack(n_layers, kp, kMaxKpBwd, widths, &S)) return -1;
  const int nb = plan_backward(S, kp, fold, &P);
  if (nb <= 0) return -1;
  Args A = {};
  A.s = s;
  A.kp = kp;
  set_tiles(P, batch, &A);
  const int grid = std::min(A.total, nb * sm_count());
  *scratch = P.glob ? (long long)grid * P.scratch : 0;
  return grid;
}

// The backward.  idx: (batch, s, kp) int32 in [0, n), padded as the forward
// took it (kp up to 256), k_real <= kp real neighbours; ws, bs as the
// forward's; fwd_out, ct: (batch, s, cout) f32.
// Scratch: dz0 (batch, s, kp, f0p) and (hilo) drel (batch, s, kp, 3) bf16;
// part (grid, grad size) f32 zeroed, grid and the global scratch's bytes
// from fused_group_mlp_bwd_grid; past 128 neighbours, cnt (batch, s, cout)
// int32 zeroed (the count pass's ties) and dcent zeroed.
// Outputs, all written: dtable (batch, n, f0p), dxyz (batch, n, 3, hilo),
// dcent (batch, s, f0p | 3), grads (grad size); nomatch incremented.
extern "C" int fused_group_mlp_bwd_launch(
    int fold, const void* table, const float* xyz, const float* cent, const void* w0x,
    const int* idx, int batch, int n, int s, int kp, int k_real, int n_layers, const void* ws,
    const float* bs, const int* widths, const float* fwd_out, const float* ct, void* dz0,
    void* drel, float* dtable, float* dxyz, float* dcent, float* part, int grid, float* grads,
    int* nomatch, int* cnt, void* scratch, long long scratch_bytes, void* stream) {
  Stack S;
  Plan P;
  if (!make_stack(n_layers, kp, kMaxKpBwd, widths, &S) || k_real < 1 || k_real > kp || n <= 0 ||
      batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = plan_backward(S, kp, fold, &P);
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  const bool span = kp > P.tm;
  if (span && !cnt) return (int)cudaErrorInvalidValue;
  const LayerDesc* table_d = device_table(S.d);
  if (!table_d) return (int)cudaErrorMemoryAllocation;
  const Layers L{table_d, static_cast<const bf16*>(ws), bs, n_layers};
  Args A = {};
  A.fold = fold;
  A.table = static_cast<const bf16*>(table);
  A.xyz = xyz;
  A.cent = cent;
  A.w0x = static_cast<const bf16*>(w0x);
  A.idx = idx;
  A.scratch = static_cast<unsigned char*>(scratch);
  A.n = n;
  A.s = s;
  A.kp = kp;
  A.k_real = k_real;
  A.fwd_out = fwd_out;
  A.ct = ct;
  A.dz0 = static_cast<bf16*>(dz0);
  A.drel = static_cast<bf16*>(drel);
  A.dcent = dcent;
  A.part = part;
  A.nomatch = nomatch;
  A.cnt = cnt;
  set_tiles(P, batch, &A);
  if (grid != std::min(A.total, nb * sm_count())) return (int)cudaErrorInvalidValue;
  if (P.glob && scratch_bytes < (long long)grid * P.scratch) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (span) {
      // the count pass: the forward kernel on this plan, at most this grid
      // (the scratch's blocks)
      const Kernel count = fwd_kernel(P.glob, true);
      const int nbc = blocks_per_sm(reinterpret_cast<const void*>(count), P.bytes);
      if (nbc <= 0) return (int)cudaErrorInvalidValue;
      count<<<std::min(grid, nbc * sm_count()), kThreads, P.bytes, st>>>(A, L, P);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    bwd_kernel(P.glob, n_layers == 1, span)<<<grid, kThreads, P.bytes, st>>>(A, L, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int size = S.g_size;
  sum_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(part, grid, size, grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int f0p = widths[0];
  err = scatter::scatter_rows(idx, A.dz0, batch, n, s * kp, kp, k_real, f0p, dtable, st);
  if (err != cudaSuccess || fold) return (int)err;
  return (int)scatter::scatter_rows(idx, A.drel, batch, n, s * kp, kp, k_real, 3, dxyz, st);
}
