"""Three nearest neighbours: CUDA kernel ``csrc/knn.cu`` and its plain
PyTorch version (counterpart of ``pointrcnn_tpu/ops/pallas_knn.py``).

Contract of both: (B, n, 3) x (B, m, 3) f32 -> (dist (B, n, 3) f32,
idx (B, n, 3) int32): the 3 nearest known points by direct-difference
squared distance ``(dx*dx + dy*dy) + dz*dz``, nearest first, the lowest
index on ties, with ``dist = sqrt(d2)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops.common import sm_count, sqrt_rn

launches = 0

# threads a block of the kernel
_THREADS = 256

# unknown points per chunk of the plain version's (chunk, m) distance block
_PLAIN_CHUNK = 1024


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    unknown = unknown.to(torch.float32)
    known = known.to(torch.float32)
    m = known.shape[1]
    col = torch.arange(m, device=known.device)
    dists, idxs = [], []
    for u in unknown.split(_PLAIN_CHUNK, dim=1):
        d = u[:, :, None, :] - known[:, None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        dc, ic = [], []
        for _ in range(3):
            mval = d2.min(dim=-1, keepdim=True).values
            i = torch.where(d2 == mval, col, m).min(dim=-1, keepdim=True).values
            dc.append(sqrt_rn(mval))
            ic.append(i)
            d2 = torch.where(col == i, torch.inf, d2)
        dists.append(torch.cat(dc, -1))
        idxs.append(torch.cat(ic, -1))
    return torch.cat(dists, 1), torch.cat(idxs, 1).to(torch.int32)


# the (unknowns a thread, lanes an unknown) that csrc/knn.cu launches
PLANS = tuple((u, g) for u in (1, 2) for g in (1, 2, 4, 8))


@functools.lru_cache(maxsize=None)
def plan(batch: int, n: int, sms: int) -> tuple[int, int]:
    """The plan of :data:`PLANS` for ``batch`` x ``n`` unknowns on a card of
    ``sms`` SMs, as measured on the H100 (``chip_smoke.py``'s per-shape
    ``plans``): two unknowns a thread only at the rpn step's FP1 size (more
    unknowns a warp make its insertions diverge more often than the shared
    loads they save), and the knowns split over more lanes (up to 8) until
    the launch has at least 3 blocks an SM."""
    u, g = (2 if batch * n >= 1 << 18 else 1), 1
    while g < 8 and batch * -(-n // (_THREADS // g * u)) < 3 * sms:
        g *= 2
    return u, g


@functools.lru_cache(maxsize=None)
def _kernel():
    """``three_nn_launch`` of the library (built at first use), its
    argument types set once: the forward is host-paced, and a launch's host
    time counts."""
    from pointrcnn_tpu_torch import _build

    fn = _build.load("knn", _build.NO_FMAD).three_nn_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(unknown: torch.Tensor, known: torch.Tensor,
            shape_plan: tuple[int, int] | None = None):
    """The kernel on CUDA tensors; ``shape_plan`` overrides :func:`plan`
    (for measuring the alternatives)."""
    from pointrcnn_tpu_torch import _build

    global launches
    for name, t in (("unknown", unknown), ("known", known)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3:
            raise ValueError(f"three_nn: {name} must be (B, n, 3) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    B, n, _ = unknown.shape
    m = known.shape[1]
    if known.shape[0] != B or m < 3 or known.device != unknown.device:
        raise ValueError(f"three_nn: bad known {tuple(known.shape)} for unknown {tuple(unknown.shape)}")
    unknown, known = unknown.contiguous(), known.contiguous()
    dist = torch.empty((B, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=unknown.device)
    u, g = plan(B, n, sm_count(unknown.device)) if shape_plan is None else shape_plan
    stream = torch.cuda.current_stream(unknown.device).cuda_stream
    with trace.span("three_nn"):
        _build.check(_kernel()(unknown.data_ptr(), known.data_ptr(), B, n, m,
                               dist.data_ptr(), idx.data_ptr(), u, g, stream), "three_nn_launch")
    launches += 1
    return dist, idx


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if unknown.is_cuda:
        return _launch(unknown, known)
    if unknown.device.type == "cpu":
        return three_nn_plain(unknown, known)
    raise ValueError(f"three_nn: unsupported device {unknown.device}")
