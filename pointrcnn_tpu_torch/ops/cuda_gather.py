"""Neighbourhood gather (QueryAndGroup) and its backward: CUDA kernels
``csrc/gather.cu`` and their plain PyTorch versions (counterpart of
``pointrcnn_tpu/ops/pallas_gather.py``).

Forward contract of both versions: xyz (B, N, 3) f32, features (B, N, C),
new_xyz (B, S, 3), idx (B, S, K) -> (B, S, K, 3 + C) bf16
``[bf16((hi + lo)[idx] - new_xyz), bf16(features)[idx]]`` with the bitmask
hi/lo split of :func:`~pointrcnn_tpu_torch.ops.common.split_hilo`, bit for
bit the TPU kernel's output.

Backward contract (the TPU's ``_group_bwd``): the cotangent is rounded to
bf16, then ``dtable`` (B, N, 3 + C) f32 is its scatter-add over ``idx`` and
``dcent`` (B, S, 3) f32 is ``-sum_K ct[..., 0:3]``; ``dxyz`` is dtable's
first three lanes (the hi and lo lanes carry the same cotangent and the lo
cast has zero derivative), ``dfeatures`` the rest, each cast to its primal's
dtype.  Both versions sum in ascending (s, k) order, so on the CPU they
agree bit for bit; the kernel is deterministic.

What the kernels take: K4 any shape (a run of output rows falls to 8 rows
for wide ones); K8 any channel count (channel chunks of at most 1024 a
block).  The TPU predicate (:func:`group_points_supported`, no channel cap)
admits nothing the kernels refuse.

K4 checks its indices on the device: an index outside [0, N) makes it
print the index and its position and trap, so the fault surfaces as a CUDA
error at the next synchronising call (the CUDA context is lost), not as a
``ValueError``.  K8 trusts the indices the forward checked.

:class:`GroupPoints` is the autograd function: K4 forward and K8 backward
on CUDA tensors, the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointrcnn_tpu_torch import _build
from pointrcnn_tpu_torch.ops.common import gather_points, split_hilo

# the TPU predicate's range of table sizes and its VMEM chunk rule
# (pallas_gather.py:48-66, :183-198)
MIN_N = 256
MAX_N = 4096
_VMEM_BUDGET = 12 << 20


def _ceil128(x: int) -> int:
    return (x + 127) // 128 * 128


def group_points_supported(features, idx) -> bool:
    """The TPU kernel's shape predicate: 256 <= N <= 4096, C >= 1 and a
    centroid chunk of at least 8 within the VMEM budget."""
    if features is None:
        return False
    _, N, C = features.shape
    S, K = idx.shape[1], idx.shape[2]
    CT, cout = _ceil128(6 + C), 3 + C
    row_bytes = N * 2 + _ceil128(CT) * 4 + _ceil128(cout) * 2
    chunk = max(1, min(S, (_VMEM_BUDGET - N * CT * 2) // max(K * row_bytes, 1)))
    while S % chunk:
        chunk -= 1
    return MIN_N <= N <= MAX_N and chunk >= 8 and C >= 1


def group_points_plain(xyz, features, new_xyz, idx):
    hi, lo = split_hilo(xyz)
    x = hi.to(torch.float32) + lo.to(torch.float32)
    rel = (gather_points(x, idx) - new_xyz.to(torch.float32)[:, :, None, :])
    feats = gather_points(features.to(torch.bfloat16), idx)
    return torch.cat([rel.to(torch.bfloat16), feats], dim=-1)


def group_points_backward_plain(idx, ct, N: int):
    """ct (B, S, K, 3 + C) -> (dtable (B, N, 3 + C) f32, dcent (B, S, 3) f32):
    ``index_add_`` in f32 of the bf16-rounded cotangent, and a sum over K in
    ascending k."""
    B, S, K, cout = ct.shape
    ctf = ct.to(torch.bfloat16).to(torch.float32)
    rows = (idx.long() + torch.arange(B, device=idx.device)[:, None, None] * N).reshape(-1)
    dtable = torch.zeros((B * N, cout), dtype=torch.float32, device=ct.device)
    dtable.index_add_(0, rows, ctf.reshape(B * S * K, cout))
    acc = torch.zeros((B, S, 3), dtype=torch.float32, device=ct.device)
    for k in range(K):
        acc = acc + ctf[:, :, k, 0:3]
    return dtable.reshape(B, N, cout), -acc


P, I = ctypes.c_void_p, ctypes.c_int
_GATHER = _build.Entry("gather", "group_gather_launch", (P, P, I, P, P, I, I, I, I, I, P, P))
_GATHER_BWD = _build.Entry("gather", "group_gather_bwd_launch",
                           (P, P, I, I, I, I, I, P, P, P, P))
_WORKSPACE_INTS = _build.Entry("gather", "group_gather_bwd_workspace_ints", (I,) * 5,
                               ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _workspace_ints(B: int, N: int, S: int, K: int, cout: int) -> int:
    """K8's scratch: the sorted positions, the buckets' starts and counts,
    and a copy of the cotangent's first three channels."""
    return _WORKSPACE_INTS(B, N, S, K, cout)


def _launch(xyz, features, new_xyz, idx):
    """K4 on CUDA tensors, after checking their shapes, dtypes and device.
    Nothing is read back to the host, so the launch can be captured in a CUDA
    graph: an index outside [0, N) makes the kernel print it and trap, and
    the fault surfaces as a CUDA error at the next synchronising call."""
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
    idx = idx.to(torch.int32).contiguous()
    xyz = xyz.contiguous()
    # the kernel rounds f32 features to bf16 itself; other types are cast
    feats = (features if features.dtype == torch.float32
             else features.to(torch.bfloat16)).contiguous()
    cent = new_xyz.contiguous()
    out = torch.empty((B, S, K, 3 + C), dtype=torch.bfloat16, device=xyz.device)
    _build.launch("group_gather", _GATHER, xyz, xyz.data_ptr(), feats.data_ptr(),
                  int(feats.dtype == torch.bfloat16), cent.data_ptr(), idx.data_ptr(), B, N, S, K,
                  C, out.data_ptr())
    return out


def _launch_bwd(idx, ct, N: int):
    """K8 on CUDA tensors: idx (B, S, K) int32 with values in [0, N) (the
    forward checked them), ct (B, S, K, 3 + C) -> (dtable, dcent) f32."""
    B, S, K, cout = ct.shape
    if idx.shape != (B, S, K) or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"group_points backward: idx {tuple(idx.shape)} {idx.dtype} "
                         f"for a cotangent {tuple(ct.shape)}")
    if not (ct.is_cuda and idx.device == ct.device):
        raise ValueError("group_points backward: idx and ct must be on one CUDA device")
    ctb = ct.to(torch.bfloat16).contiguous()
    dtable = torch.empty((B, N, cout), dtype=torch.float32, device=ct.device)
    dcent = torch.empty((B, S, 3), dtype=torch.float32, device=ct.device)
    work = torch.empty(_workspace_ints(B, N, S, K, cout), dtype=torch.int32, device=ct.device)
    _build.launch("gather_backward", _GATHER_BWD, ct, idx.data_ptr(), ctb.data_ptr(), B, N, S, K,
                  cout, work.data_ptr(), dtable.data_ptr(), dcent.data_ptr())
    return dtable, dcent


class GroupPoints(torch.autograd.Function):
    """K4 forward, K8 backward (the plain versions on CPU tensors); the
    backward reuses the index tensor the forward checked."""

    @staticmethod
    def forward(ctx, xyz, features, new_xyz, idx):
        if xyz.is_cuda:
            out = _launch(xyz, features, new_xyz, idx)
            idx = idx.to(torch.int32).contiguous()  # what K4 read, for K8 unchecked
        elif xyz.device.type == "cpu":
            out = group_points_plain(xyz, features, new_xyz, idx)
        else:
            raise ValueError(f"group_points: unsupported device {xyz.device}")
        ctx.save_for_backward(idx)
        ctx.n = features.shape[1]
        ctx.dtypes = (xyz.dtype, features.dtype, new_xyz.dtype)
        return out

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        if ct.is_cuda:
            dtable, dcent = _launch_bwd(idx, ct, ctx.n)
        else:
            dtable, dcent = group_points_backward_plain(idx, ct, ctx.n)
        xyz_dt, feat_dt, cent_dt = ctx.dtypes
        return (dtable[..., 0:3].to(xyz_dt), dtable[..., 3:].to(feat_dt),
                dcent.to(cent_dt), None)


def group_points(xyz, features, new_xyz, idx):
    """The kernels for CUDA tensors, the plain versions for CPU tensors."""
    return GroupPoints.apply(xyz, features, new_xyz, idx)
