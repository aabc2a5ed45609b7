"""Neighbourhood gather (QueryAndGroup): CUDA kernel ``csrc/gather.cu`` and
its plain PyTorch version (counterpart of
``pointrcnn_tpu/ops/pallas_gather.py``, forward only).

Contract of both: xyz (B, N, 3) f32, features (B, N, C), new_xyz (B, S, 3),
idx (B, S, K) -> (B, S, K, 3 + C) bf16
``[bf16((hi + lo)[idx] - new_xyz), bf16(features)[idx]]`` with the bitmask
hi/lo split of :func:`~pointrcnn_tpu_torch.ops.common.split_hilo`, bit for
bit the TPU kernel's output.
"""

from __future__ import annotations

import ctypes

import torch

from pointrcnn_tpu_torch.ops.common import gather_points, split_hilo

launches = 0


def group_points_plain(xyz, features, new_xyz, idx):
    hi, lo = split_hilo(xyz)
    x = hi.to(torch.float32) + lo.to(torch.float32)
    rel = (gather_points(x, idx) - new_xyz.to(torch.float32)[:, :, None, :])
    feats = gather_points(features.to(torch.bfloat16), idx)
    return torch.cat([rel.to(torch.bfloat16), feats], dim=-1)


def _launch(xyz, features, new_xyz, idx):
    from pointrcnn_tpu_torch import _build

    global launches
    B, N, C = features.shape
    S, K = idx.shape[1], idx.shape[2]
    if (xyz.shape != (B, N, 3) or new_xyz.shape != (B, S, 3) or idx.shape[0] != B
            or xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32):
        raise ValueError(
            f"group_points: bad shapes/dtypes xyz {tuple(xyz.shape)} {xyz.dtype}, "
            f"features {tuple(features.shape)}, new_xyz {tuple(new_xyz.shape)} "
            f"{new_xyz.dtype}, idx {tuple(idx.shape)}")
    if not all(t.is_cuda and t.device == xyz.device for t in (features, new_xyz, idx)):
        raise ValueError("group_points: all tensors must be on one CUDA device")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= N:
            raise ValueError(f"group_points: indices outside [0, {N})")
    xyz = xyz.contiguous()
    feats = features.to(torch.bfloat16).contiguous()
    cent = new_xyz.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((B, S, K, 3 + C), dtype=torch.bfloat16, device=xyz.device)
    lib = _build.load("gather", _build.NO_FMAD)
    fn = lib.group_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    _build.check(fn(xyz.data_ptr(), feats.data_ptr(), cent.data_ptr(), idx.data_ptr(),
                    B, N, S, K, C, out.data_ptr(), stream), "group_gather_launch")
    launches += 1
    return out


def group_points(xyz, features, new_xyz, idx):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if xyz.is_cuda:
        return _launch(xyz, features, new_xyz, idx)
    if xyz.device.type == "cpu":
        return group_points_plain(xyz, features, new_xyz, idx)
    raise ValueError(f"group_points: unsupported device {xyz.device}")
