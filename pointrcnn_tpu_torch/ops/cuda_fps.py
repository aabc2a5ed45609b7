"""Furthest point sampling: CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version (counterpart of ``pointrcnn_tpu/ops/pallas_fps.py``).

Contract of both: (B, N, 3) f32 -> (B, npoint) int32; the first pick is
index 0, then each step folds the squared distance to the last pick,
``(dx*dx + dy*dy) + dz*dz``, into a running minimum that starts at 1e10 and
picks its argmax, the lowest index on ties.
"""

from __future__ import annotations

import ctypes

import torch

# most points per row the kernel keeps in registers (16 per thread x 1024)
MAX_N = 16384

launches = 0


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


def _launch(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    from pointrcnn_tpu_torch import _build

    global launches
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"fps: need (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if not 1 <= npoint <= N or N > MAX_N:
        raise ValueError(f"fps: need 1 <= npoint <= N <= {MAX_N}, got npoint={npoint} N={N}")
    xyz = xyz.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    lib = _build.load("fps", _build.NO_FMAD)
    fn = lib.fps_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    _build.check(fn(xyz.data_ptr(), B, N, npoint, out.data_ptr(), stream), "fps_launch")
    launches += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xyz.is_cuda:
        return _launch(xyz, npoint)
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    raise ValueError(f"fps: unsupported device {xyz.device}")
