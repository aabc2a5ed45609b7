"""Furthest point sampling: CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version (counterpart of ``pointrcnn_tpu/ops/pallas_fps.py``).

Contract of both: (B, N, 3) f32 -> (B, npoint) int32; the first pick is
index 0, then each step folds the squared distance to the last pick,
``(dx*dx + dy*dy) + dz*dz``, into a running minimum that starts at 1e10 and
picks its argmax, the lowest index on ties.

What the kernel takes: any row length (the TPU's gate, ``MAX_CELLS`` =
2^20 cells of B x N with N % 128 == 0, and its XLA loop beyond, take any
too).  Rows of up to 16384 points keep their coordinates in one block's
shared memory (``plans``); longer rows take ``fps_wide_launch``: up to
131072 points a cluster of 2, 4 or 8 blocks a row, each block's share in
its shared memory and the step's winners exchanged through distributed
shared memory; past that a block a row, the first 16384 points in shared
memory, the rest read from L2 each step and the running minima in a
global scratch row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointrcnn_tpu_torch import _build
from pointrcnn_tpu_torch.ops.common import sm_count

# most points per row whose xyz stays in one block's shared memory (1024
# threads, 16 points a thread); longer rows take the wide kernels
MAX_N = 16384

# blocks of a K9 cluster (a row's table is spread over their shared memory)
FFPS_CLUSTER = 8
# a K9 block's shared-memory budget on sm_90 and its most points a thread
_FFPS_SMEM = 227 * 1024
_FFPS_MAX_PPL = 16


def plans(n: int) -> tuple[tuple[int, int], ...]:
    """The (warps a row, rows a block) that ``csrc/fps.cu`` launches for
    rows of ``n`` points (past ``MAX_N``: the wide kernel, 32 warps, a row a
    block); it refuses any other."""
    return ((32, 1),) if n > 1024 else ((1, 2), (4, 1))


@functools.lru_cache(maxsize=None)
def plan(rows: int, n: int, sms: int) -> tuple[int, int]:
    """The plan of :func:`plans` for ``rows`` rows of ``n`` points on a card
    of ``sms`` SMs, as measured on the H100 (``chip_smoke.py``'s per-shape
    ``plans``): rows of more than 512 points four warps a row while that
    keeps at most 8 warps an SM, else a warp a row, two rows a block."""
    if n > 1024:
        return 32, 1
    if n > 512 and 4 * rows <= 8 * sms:
        return 4, 1
    return 1, 2


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    xs, ys, zs = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    col = torch.arange(N, device=xyz.device)
    dists = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        px, py, pz = (torch.gather(a, 1, last) for a in (xs, ys, zs))
        dx, dy, dz = xs - px, ys - py, zs - pz
        dists = torch.minimum(dists, dx * dx + dy * dy + dz * dz)
        m = dists.max(dim=1, keepdim=True).values
        last = torch.where(dists == m, col, N).min(dim=1, keepdim=True).values
        out[:, i] = last[:, 0].to(torch.int32)
    return out


P, I = ctypes.c_void_p, ctypes.c_int
_FPS = _build.Entry("fps", "fps_launch", (P, I, I, I, P, I, I, P))
# rows of more than MAX_N points
_FPS_WIDE = _build.Entry("fps", "fps_wide_launch", (P, I, I, I, P, P, P))
_FFPS = _build.Entry("fps", "ffps_launch", (P, I, I, I, I, I, I, P, P))
_STEP_PROBE = _build.Entry("fps", "fps_step_probe", (P, I, P, P))


def _launch(xyz: torch.Tensor, npoint: int,
            shape_plan: tuple[int, int] | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor; ``shape_plan`` overrides :func:`plan`
    (for measuring the alternatives)."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"fps: need (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if not 1 <= npoint <= N:
        raise ValueError(f"fps: need 1 <= npoint <= N, got npoint={npoint} N={N}")
    xyz = xyz.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if N > MAX_N:
        # the running minima of a row past a cluster's reach
        mind = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
        _build.launch("fps", _FPS_WIDE, xyz, xyz.data_ptr(), B, N, npoint, out.data_ptr(),
                      mind.data_ptr())
        return out
    wpr, rpb = plan(B, N, sm_count(xyz.device)) if shape_plan is None else shape_plan
    _build.launch("fps", _FPS, xyz, xyz.data_ptr(), B, N, npoint, out.data_ptr(), wpr, rpb)
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xyz.is_cuda:
        return _launch(xyz, npoint)
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    raise ValueError(f"fps: unsupported device {xyz.device}")


def step_probe_ms(steps: int) -> float:
    """Device ms of one launch of the latency probe (``fps_step_probe`` in
    ``csrc/fps.cu``): one warp, ``steps`` dependent FPS steps over 32
    seeded points (needs a card)."""
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((32, 3), generator=g).cuda()
    out = torch.empty(1, dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    launch = lambda: _build.check(_STEP_PROBE(xyz.data_ptr(), steps, out.data_ptr(), stream),
                                  _STEP_PROBE.symbol)
    launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _ffps_smem(m: int, d: int) -> int:
    """A K9 block's shared memory for shares of ``m`` points of ``d``
    values (``ffps_smem`` in ``csrc/fps.cu``)."""
    ds = d | 1
    words = (m * ds + (FFPS_CLUSTER + 2) * ds + 1) // 2
    return (words + 2 + FFPS_CLUSTER + 2 * 32) * 8


def ffps_supported(n: int, d: int) -> bool:
    """Whether K9 takes a range of ``n`` rows of ``d`` values: each of the
    cluster's blocks holds its share in shared memory at 16 points a thread
    at most (3DSSD's SA2, 4096 x 67: 137 KB a block)."""
    m = -(-n // FFPS_CLUSTER)
    threads = min(1024, max(32, -(-m // 32) * 32))
    return (3 <= d <= 1024 and n >= 1 and _ffps_smem(m, d) <= _FFPS_SMEM
            and -(-m // threads) <= _FFPS_MAX_PPL)


def feature_fps_plain(rows: torch.Tensor, npoint: int, start: int = 0,
                      end: int | None = None) -> torch.Tensor:
    """Plain version of K9: (B, N, D) f32 rows, the range [start, end) ->
    (B, npoint) int32 indices into the whole row."""
    x = rows[:, start:end].to(torch.float32)
    B, n, D = x.shape
    col = torch.arange(n, device=x.device)
    dists = torch.full((B, n), 1e10, dtype=torch.float32, device=x.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=x.device)
    last = torch.zeros((B, 1), dtype=torch.long, device=x.device)
    for i in range(1, npoint):
        diff = x - torch.gather(x, 1, last[..., None].expand(B, 1, D))
        acc = diff[..., 0] * diff[..., 0]
        for k in range(1, D):
            acc = acc + diff[..., k] * diff[..., k]
        dists = torch.minimum(dists, acc)
        m = dists.max(dim=1, keepdim=True).values
        last = torch.where(dists == m, col, n).min(dim=1, keepdim=True).values
        out[:, i] = last[:, 0].to(torch.int32)
    return out + start


def _launch_ffps(rows: torch.Tensor, npoint: int, start: int, n: int) -> torch.Tensor:
    B, N, D = rows.shape
    if not ffps_supported(n, D):
        raise ValueError(f"feature_fps: a range of {n} rows of {D} values is past K9's "
                         f"shared memory ({FFPS_CLUSTER} blocks a row)")
    rows = rows.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=rows.device)
    _build.launch("ffps", _FFPS, rows, rows.data_ptr(), B, N, start, n, D, npoint,
                  out.data_ptr())
    return out


def feature_fps(rows: torch.Tensor, npoint: int, start: int = 0,
                end: int | None = None) -> torch.Tensor:
    """F-FPS over ``rows`` (B, N, 3 + C) f32 in the row range [start, end)
    -> (B, npoint) int32 indices into the whole row: K9 for a CUDA tensor,
    the plain version for a CPU tensor."""
    B, N, D = rows.shape
    end = N if end is None else end
    if rows.dtype != torch.float32 or D < 3:
        raise ValueError(f"feature_fps: need (B, N, 3 + C) float32, got {tuple(rows.shape)} "
                         f"{rows.dtype}")
    if not (0 <= start < end <= N and 1 <= npoint <= end - start):
        raise ValueError(f"feature_fps: need 0 <= start < end <= N and 1 <= npoint <= end - "
                         f"start, got [{start}, {end}) of {N}, npoint={npoint}")
    if rows.is_cuda:
        return _launch_ffps(rows, npoint, start, end - start)
    if rows.device.type == "cpu":
        return feature_fps_plain(rows, npoint, start, end)
    raise ValueError(f"feature_fps: unsupported device {rows.device}")
