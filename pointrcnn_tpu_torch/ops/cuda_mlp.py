"""Fused neighbourhood gather + shared MLP + max over K: CUDA kernel
``csrc/mlp.cu``, its plain PyTorch version, and the operand build around
them (counterpart of ``pointrcnn_tpu/ops/pallas_mlp.py``, forward only).

The operands follow ``_prepare_operands`` of the JAX module:

- the layer-1 feature half commutes with the gather, so the table holds
  ``P = bf16(features) @ bf16(w0_feat)`` (f32 accumulation);
- mode ``"hilo"``: the table is ``bf16(P)``; geometry enters in the kernel as
  ``bf16(hi - c) @ w0x + lo @ w0x`` from the bitmask hi/lo split of xyz;
- mode ``"fold"`` (canonical-frame inputs, the RCNN stages with
  N >= ``_FOLD_MIN_N``): the table is ``bf16(P + xyz @ w0x)`` and the
  kernel subtracts ``c @ w0x`` (f32) after the gather.

Widths are zero-padded to multiples of 16 (the WMMA tile); padded lanes
carry zero weights and biases and stay zero through the ReLUs.
"""

from __future__ import annotations

import ctypes

import torch

from pointrcnn_tpu_torch.ops.common import gather_points, split_hilo

launches = 0

# dispatch constants of the TPU predicate (pallas_mlp.py), kept so the port
# routes every stage as the TPU does; tests may lower them
_CHUNK_S_MAX = 64
_MAX_ROWS = 8192
_MAX_N = 2048
_MAX_OH_CELLS = 1 << 22
_FOLD_MIN_N = 256

# the kernel takes up to 64 neighbours (one block's rows) and 2-4 layers
_MAX_K = 64
_MAX_LAYERS = 4


def _pick_chunk(S: int, K: int) -> int:
    chunk = min(_CHUNK_S_MAX, S, max(1, _MAX_ROWS // K))
    while S % chunk:
        chunk -= 1
    return chunk


def fused_group_mlp_max_supported(features, idx, compute_dtype) -> bool:
    """Whether a SharedMLP stage takes the fused kernel (the TPU predicate
    without its backend check)."""
    if features is None or compute_dtype != torch.bfloat16:
        return False
    N = features.shape[1]
    S, K = idx.shape[1], idx.shape[2]
    chunk = _pick_chunk(S, K)
    return N <= _MAX_N and chunk >= 8 and chunk * K * N <= _MAX_OH_CELLS


def fold_geometry_profitable(features) -> bool:
    return features is not None and features.shape[1] >= _FOLD_MIN_N


def _ceil16(x: int) -> int:
    return (x + 15) // 16 * 16


def _pad(a: torch.Tensor, widths) -> torch.Tensor:
    pads = []
    for dim in reversed(range(a.dim())):
        pads += [0, widths[dim] - a.shape[dim]]
    return torch.nn.functional.pad(a, pads)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: products of bf16 values are exact in
    f32, so this is the TPU's MXU arithmetic up to summation order."""
    return a.to(torch.bfloat16).to(torch.float32) @ b.to(torch.bfloat16).to(torch.float32)


def prepare_operands(fold: bool, xyz, features, new_xyz, weights, biases):
    """-> (table bf16 (B, N, F0P), cent f32, w0x bf16 (3, F0P) or None,
    ws bf16 padded for layers 1.., bs f32 padded for layers 0..)."""
    w0 = weights[0]
    f0p = _ceil16(w0.shape[1])
    w0x3, w0f = w0[:3].to(torch.float32), w0[3:]
    P = _bf16_matmul(features, w0f)
    if fold:
        G = xyz.to(torch.float32) @ w0x3
        table = (P + G).to(torch.bfloat16)
        cent = _pad(new_xyz.to(torch.float32) @ w0x3, (*new_xyz.shape[:2], f0p))
        w0x = None
    else:
        table = P.to(torch.bfloat16)
        cent = new_xyz.to(torch.float32)
        w0x = _pad(w0x3, (3, f0p)).to(torch.bfloat16)
    table = _pad(table, (*table.shape[:2], f0p))
    ws, bs = [], [_pad(biases[0].to(torch.float32), (f0p,))]
    cin = f0p
    for w, b in zip(weights[1:], biases[1:]):
        cout = _ceil16(w.shape[1])
        ws.append(_pad(w.to(torch.float32), (cin, cout)).to(torch.bfloat16))
        bs.append(_pad(b.to(torch.float32), (cout,)))
        cin = cout
    return table, cent, w0x, ws, bs


def fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx):
    """Plain version of the kernel on its own operands -> (B, S, CoutP) f32."""
    x = gather_points(table, idx).to(torch.float32)
    if fold:
        x = x - cent[:, :, None, :]
    else:
        hi, lo = split_hilo(xyz)
        ghi = gather_points(hi.to(torch.float32), idx)
        glo = gather_points(lo.to(torch.float32), idx)
        rel = (ghi - cent[:, :, None, :]).to(torch.bfloat16).to(torch.float32)
        w = w0x.to(torch.float32)
        x = x + torch.cat([rel, glo], -1) @ torch.cat([w, w], 0)
    x = torch.relu(x + bs[0])
    for w, b in zip(ws, bs[1:]):
        x = torch.relu(_bf16_matmul(x, w) + b)
    return x.amax(dim=2)


def _launch(fold, table, xyz, cent, w0x, ws, bs, idx):
    from pointrcnn_tpu_torch import _build

    global launches
    B, N, f0p = table.shape
    S, K = idx.shape[1], idx.shape[2]
    n_layers = 1 + len(ws)
    if not 2 <= n_layers <= _MAX_LAYERS:
        raise ValueError(f"fused_group_mlp: {n_layers} layers, kernel takes 2..{_MAX_LAYERS}")
    if K > _MAX_K or idx.shape[0] != B:
        raise ValueError(f"fused_group_mlp: idx {tuple(idx.shape)} (K <= {_MAX_K})")
    tensors = [table, cent, idx, *ws, *bs] + ([] if fold else [xyz, w0x])
    if not all(t.is_cuda and t.device == table.device for t in tensors):
        raise ValueError("fused_group_mlp: all operands must be on one CUDA device")
    cent_shape = (B, S, f0p) if fold else (B, S, 3)
    if table.dtype != torch.bfloat16 or cent.dtype != torch.float32 or cent.shape != cent_shape:
        raise ValueError(f"fused_group_mlp: need bf16 table and f32 cent {cent_shape}, got "
                         f"{table.dtype}, {cent.dtype} {tuple(cent.shape)}")
    if not fold and (xyz.shape != (B, N, 3) or xyz.dtype != torch.float32
                     or w0x.shape != (3, f0p) or w0x.dtype != torch.bfloat16):
        raise ValueError("fused_group_mlp: hilo needs f32 xyz (B, N, 3) and bf16 w0x (3, F0P)")
    cin = f0p
    for w, b in zip(ws, bs[1:]):
        if w.dtype != torch.bfloat16 or w.shape[0] != cin or b.shape != (w.shape[1],):
            raise ValueError(f"fused_group_mlp: layer weight {tuple(w.shape)} {w.dtype} "
                             f"after width {cin}")
        cin = w.shape[1]
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= N:
            raise ValueError(f"fused_group_mlp: indices outside [0, {N})")
    # pad K to the 16-row tile by repeating each row's first neighbour: a
    # duplicate cannot change the max over the neighbourhood
    kp = 16 if K <= 16 else (32 if K <= 32 else 64)
    idx = idx.to(torch.int32)
    if kp != K:
        idx = torch.cat([idx, idx[..., :1].expand(B, S, kp - K)], dim=-1)
    idx = idx.contiguous()
    table, cent = table.contiguous(), cent.contiguous()
    ws = [w.contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    widths = [f0p] + [w.shape[1] for w in ws]
    out = torch.empty((B, S, widths[-1]), dtype=torch.float32, device=table.device)
    w_ptrs = (ctypes.c_void_p * n_layers)(0, *[w.data_ptr() for w in ws])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in bs])
    c_widths = (ctypes.c_int * n_layers)(*widths)
    lib = _build.load("mlp")
    fn = lib.fused_group_mlp_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    xyz_c = xyz.contiguous() if not fold else None
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(int(fold), table.data_ptr(), 0 if fold else xyz_c.data_ptr(),
             cent.data_ptr(), 0 if fold else w0x.contiguous().data_ptr(),
             idx.data_ptr(), B, N, S, kp, n_layers, w_ptrs, b_ptrs, c_widths,
             out.data_ptr(), stream)
    _build.check(err, "fused_group_mlp_launch")
    launches += 1
    return out


def fused_group(fold, table, xyz, cent, w0x, ws, bs, idx):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if table.is_cuda:
        return _launch(fold, table, xyz, cent, w0x, ws, bs, idx)
    if table.device.type == "cpu":
        return fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
    raise ValueError(f"fused_group_mlp: unsupported device {table.device}")


def fused_group_mlp_max(xyz, features, new_xyz, idx, weights, biases,
                        use_xyz: bool = True, fold_geometry: bool = False):
    """Fused ``group_points`` + MLP stack (BN folded) + max over K.

    :param xyz: (B, N, 3) f32; features: (B, N, C); new_xyz: (B, S, 3)
    :param idx: (B, S, K) neighbourhood indices
    :param weights: list of (Ci, Ci+1), ``weights[0]`` with Cin = 3 + C
    :return: (B, S, Cout) f32
    """
    if not use_xyz:
        raise NotImplementedError("fused_group_mlp_max: use_xyz=False is not ported")
    if len(weights) < 2:
        raise NotImplementedError("fused_group_mlp_max: single-layer stacks are not ported")
    table, cent, w0x, ws, bs = prepare_operands(
        fold_geometry, xyz, features, new_xyz, weights, biases)
    out = fused_group(fold_geometry, table, xyz, cent, w0x, ws, bs, idx)
    return out[..., : weights[-1].shape[1]]


def fused_mlp_max(grouped, weights, biases, compute_dtype=torch.bfloat16):
    """(B, S, K, Cin) -> (B, S, Cout): MLP stack + max over K on an already
    grouped tensor, activations rounded to ``compute_dtype`` between layers
    (the unfused route; plain torch)."""
    x = grouped.to(compute_dtype)
    for w, b in zip(weights, biases):
        y = x.to(torch.float32) @ w.to(compute_dtype).to(torch.float32)
        x = torch.relu(y + b.to(torch.float32)).to(compute_dtype)
    return x.to(torch.float32).amax(dim=2)
