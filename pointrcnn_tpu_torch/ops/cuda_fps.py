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

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops.common import sm_count

# most points per row whose xyz stays in one block's shared memory (1024
# threads, 16 points a thread); longer rows take the wide kernels
MAX_N = 16384

launches = 0


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """``fps_launch`` of the library (built at first use), its argument
    types set once: the forward is host-paced, and a launch's host time
    counts."""
    from pointrcnn_tpu_torch import _build

    fn = _build.load("fps", _build.NO_FMAD).fps_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _wide_kernel():
    """``fps_wide_launch`` (rows of more than ``MAX_N`` points)."""
    from pointrcnn_tpu_torch import _build

    fn = _build.load("fps", _build.NO_FMAD).fps_wide_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xyz: torch.Tensor, npoint: int,
            shape_plan: tuple[int, int] | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor; ``shape_plan`` overrides :func:`plan`
    (for measuring the alternatives)."""
    from pointrcnn_tpu_torch import _build

    global launches
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"fps: need (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if not 1 <= npoint <= N:
        raise ValueError(f"fps: need 1 <= npoint <= N, got npoint={npoint} N={N}")
    xyz = xyz.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    if N > MAX_N:
        # the running minima of a row past a cluster's reach
        mind = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
        with trace.span("fps"):
            _build.check(_wide_kernel()(xyz.data_ptr(), B, N, npoint, out.data_ptr(),
                                        mind.data_ptr(), stream), "fps_wide_launch")
        launches += 1
        return out
    wpr, rpb = plan(B, N, sm_count(xyz.device)) if shape_plan is None else shape_plan
    with trace.span("fps"):
        _build.check(_kernel()(xyz.data_ptr(), B, N, npoint, out.data_ptr(), wpr, rpb, stream),
                     "fps_launch")
    launches += 1
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
    from pointrcnn_tpu_torch import _build

    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((32, 3), generator=g).cuda()
    out = torch.empty(1, dtype=torch.int32, device=xyz.device)
    fn = _build.load("fps", _build.NO_FMAD).fps_step_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    launch = lambda: _build.check(fn(xyz.data_ptr(), steps, out.data_ptr(), stream),
                                  "fps_step_probe")
    launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)
