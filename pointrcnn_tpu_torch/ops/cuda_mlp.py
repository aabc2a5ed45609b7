"""Fused neighbourhood gather + shared MLP + max over K, forward and
backward: CUDA kernels ``csrc/mlp.cu``, their plain PyTorch versions, the
operand build around them and the autograd function (counterpart of
``pointrcnn_tpu/ops/pallas_mlp.py``).

The operands follow ``_prepare_operands`` of the JAX module:

- the layer-1 feature half commutes with the gather, so the table holds
  ``P = bf16(features) @ bf16(w0_feat)`` (f32 accumulation);
- mode ``"hilo"``: the table is ``bf16(P)``; geometry enters in the kernel as
  ``bf16(hi - c) @ w0x + lo @ w0x`` from the bitmask hi/lo split of xyz;
- mode ``"fold"`` (canonical-frame inputs, the RCNN stages with
  N >= ``_FOLD_MIN_N``): the table is ``bf16(P + xyz @ w0x)`` and the
  kernel subtracts ``c @ w0x`` (f32) after the gather;
- mode ``"none"`` (``use_xyz`` False: ``weights[0]`` has no xyz rows): the
  table is ``bf16(P)`` and the kernels run it as the fold route with a zero
  centroid term (``x - 0.0`` is ``x``, bit for bit, so the rounding points
  are JAX's); the backward returns zero xyz and centroid gradients.

Widths are zero-padded to multiples of 16 (the depth of one wgmma step and
the narrowest N piece the kernels cut a layer into); padded lanes carry zero
weights and biases and stay zero through the ReLUs.  The kernels take the
weights as they are (row-major bf16) and lay them out for wgmma in shared
memory themselves; nothing is packed on the host.

A one-layer stack maxes over layer 0's f32 activations (padded lanes
included, then trimmed, as ``_trim_padded_lanes`` does); its backward splits
the cotangent among layer 0's ties.

What the kernels take: every shape the TPU predicates
``fused_group_mlp_max_supported`` / ``fused_group_bwd_supported`` admit, at
any depth and width.  K is padded to a power of two from 16 up to 1024 in
the forward (the TPU forward predicate's reach: a chunk of 8 centroids at
``_MAX_ROWS``) and 256 in the backward (``_MAX_ROWS_BWD``); past 128 a
centroid spans several 128-row tiles.  The per-layer widths and offsets go
to the kernels as a layer table in device memory, the weights and biases
concatenated, so a stack may be any depth; the kernels' global plan keeps
every buffer whose size grows with the widths in global memory, so a layer
may be any width.  The ``ValueError``s left are operand errors (device,
dtype, shapes that do not match, alignment, indices out of range) and a K
past those reaches, which the TPU predicates refuse too.

The backward (``_pallas_bwd``) works on the same operands: it recomputes the
forward, splits each output cotangent evenly among the tied maxima, and
returns the table, centroid and parameter gradients of the padded operands
(:func:`fused_group_backward_plain` spells out its rounding points);
:func:`_assemble` maps them back to ``xyz``, ``features``, ``new_xyz`` and
the unpadded weights and biases, in plain torch as the JAX module does.
:class:`FusedGroupMLP` is the autograd function: the kernels on CUDA
tensors, the plain versions on CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from pointrcnn_tpu_torch import _build
from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.ops.common import gather_points, split_hilo

# dispatch constants of the TPU predicates (pallas_mlp.py), kept so the port
# routes every stage as the TPU does; tests may lower them
_CHUNK_S_MAX = 64
_MAX_ROWS = 8192
_MAX_ROWS_BWD = 2048
_MAX_N = 2048
_MAX_OH_CELLS = 1 << 22
_FOLD_MIN_N = 256

# the kernels' reach in padded neighbours: the TPU predicates' (a chunk of 8
# centroids at _MAX_ROWS forward, _MAX_ROWS_BWD backward)
_MAX_KP = 1024
_MAX_KP_BWD = 256

# the backward's count of (b, s, channel) whose recomputed activations held
# no value equal to the forward's maximum (a cotangent dropped): one int32
# on each device, added to by every launch; must stay 0
_nomatch: dict = {}


def _pick_chunk(S: int, K: int, max_rows: int | None = None) -> int:
    chunk = min(_CHUNK_S_MAX, S, max(1, (_MAX_ROWS if max_rows is None else max_rows) // K))
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


def fused_group_bwd_supported(features, idx) -> bool:
    """Whether the fused backward takes a stage (``fused_group_bwd_supported``
    of the TPU without its backend check: the smaller row budget of its
    centroid chunk)."""
    if features is None:
        return False
    N = features.shape[1]
    S, K = idx.shape[1], idx.shape[2]
    chunk = _pick_chunk(S, K, _MAX_ROWS_BWD)
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


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: products of bf16 values are exact in
    f32, so this is the TPU's MXU arithmetic up to summation order."""
    return _bf16(a) @ _bf16(b)


def prepare_operands(fold: bool, xyz, features, new_xyz, weights, biases,
                     use_xyz: bool = True):
    """-> (table bf16 (B, N, F0P), cent f32, w0x bf16 (3, F0P) or None,
    ws bf16 padded for layers 1.., bs f32 padded for layers 0..).  Without
    ``use_xyz`` the operands of the fold route with a zero centroid term."""
    w0 = weights[0]
    f0p = _ceil16(w0.shape[1])
    if not use_xyz:
        table = _bf16_matmul(features, w0).to(torch.bfloat16)
        cent = torch.zeros((*new_xyz.shape[:2], f0p), dtype=torch.float32, device=table.device)
        w0x = None
    else:
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


def _layer0_rel(xyz, cent, idx):
    """hilo: the gathered relative geometry the kernels form, (B, S, K, 6)
    ``[bf16(hi - c), lo]`` as f32."""
    hi, lo = split_hilo(xyz)
    ghi = gather_points(hi.to(torch.float32), idx)
    glo = gather_points(lo.to(torch.float32), idx)
    return torch.cat([_bf16(ghi - cent[:, :, None, :]), glo], -1)


def _plain_acts(fold, table, xyz, cent, w0x, ws, bs, idx):
    """The plain forward's f32 activations of every layer (and, in hilo
    mode, the relative geometry of layer 0)."""
    x = gather_points(table, idx).to(torch.float32)
    rel = None
    if fold:
        x = x - cent[:, :, None, :]
    else:
        rel = _layer0_rel(xyz, cent, idx)
        w = w0x.to(torch.float32)
        x = x + rel @ torch.cat([w, w], 0)
    acts = [torch.relu(x + bs[0])]
    for w, b in zip(ws, bs[1:]):
        acts.append(torch.relu(_bf16_matmul(acts[-1], w) + b))
    return acts, rel


def fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx):
    """Plain version of the forward kernel on its own operands ->
    (B, S, CoutP) f32."""
    return _plain_acts(fold, table, xyz, cent, w0x, ws, bs, idx)[0][-1].amax(dim=2)


def _scatter_rows(idx, src, N: int):
    """(B, S, K) indices, (B, S, K, C) f32 -> (B, N, C) f32 sums of the rows
    landing on each table row (``index_add_``)."""
    B, S, K, C = src.shape
    rows = (idx.long() + torch.arange(B, device=idx.device)[:, None, None] * N).reshape(-1)
    out = torch.zeros((B * N, C), dtype=torch.float32, device=src.device)
    out.index_add_(0, rows, src.reshape(B * S * K, C))
    return out.reshape(B, N, C)


def fused_group_backward_plain(fold, table, xyz, cent, w0x, ws, bs, idx, out, ct):
    """Plain version of the backward kernel on the forward's operands, its
    output ``out`` (B, S, CoutP) and the cotangent ``ct`` (B, S, CoutP) ->
    (dtable (B, N, F0P), dxyz (B, N, 3) or None, dcent (B, S, F0P | 3),
    dw0x (6, F0P) or None, dws [padded], dbs [padded]), all f32.

    The rounding points of ``_make_bwd_kernel`` written out (not autograd,
    which would keep ``dz`` in f32): the tie split and ReLU masks on the f32
    activations; ``dW = bf16(a)^T bf16(dz)``, ``dz' = (bf16(dz) bf16(W)^T) *
    [a > 0]``, ``db = sum dz``; ``dtable`` the scatter of ``bf16(dz_0)``;
    fold: ``dcent = -sum_K dz_0``; hilo: ``drel = bf16(dz_0) bf16(w0x)^T``,
    ``dcent = -sum_K drel``, ``dw0x = rel^T bf16(dz_0)`` and ``dxyz`` the
    scatter of ``bf16(drel)``."""
    B, N = table.shape[:2]
    acts, rel = _plain_acts(fold, table, xyz, cent, w0x, ws, bs, idx)
    a_last = acts[-1]
    eq = a_last == out[:, :, None, :]
    cnt = torch.clamp(eq.sum(dim=2).to(torch.float32), min=1.0)
    dz = torch.where(eq & (a_last > 0), (ct / cnt)[:, :, None, :], 0.0)
    dws, dbs = [None] * len(ws), [None] * (len(ws) + 1)
    for i in range(len(ws), 0, -1):
        a_prev = acts[i - 1]
        dws[i - 1] = torch.einsum("bskc,bskf->cf", _bf16(a_prev), _bf16(dz))
        dbs[i] = dz.sum(dim=(0, 1, 2))
        dz = torch.where(a_prev > 0, _bf16(dz) @ _bf16(ws[i - 1]).t(), 0.0)
    dbs[0] = dz.sum(dim=(0, 1, 2))
    dxyz = dw0x = None
    if fold:
        dcent = -dz.sum(dim=2)
    else:
        drel = _bf16(dz) @ w0x.to(torch.float32).t()
        dcent = -drel.sum(dim=2)
        dw0x = torch.einsum("bskc,bskf->cf", rel, _bf16(dz))
        dxyz = _scatter_rows(idx, _bf16(drel), N)
    return _scatter_rows(idx, _bf16(dz), N), dxyz, dcent, dw0x, dws, dbs


def padded_k(K: int) -> int:
    """The kernels' neighbour count for K: a power of two, at least 16."""
    kp = 16
    while kp < K:
        kp *= 2
    return kp


def check_shape(K: int, backward: bool = False) -> None:
    """Refuse a neighbour count past the kernels' reach (``ValueError``): K
    past 1024 forward or 256 backward, which the TPU predicates refuse too.
    Depth and width have no limit."""
    reach = _MAX_KP_BWD if backward else _MAX_KP
    if padded_k(K) > reach:
        raise ValueError(f"fused_group_mlp{' backward' if backward else ''}: K={K} past the "
                         f"kernel's {reach}")


def _check_operands(fold, table, xyz, cent, w0x, ws, bs, idx, backward: bool = False):
    """The shape checks first, then the device: a CPU operand of a shape the
    kernels take fails only the device check."""
    B, N, f0p = table.shape
    S, K = idx.shape[1], idx.shape[2]
    check_shape(K, backward)
    if idx.shape[0] != B or len(bs) != 1 + len(ws):
        raise ValueError(f"fused_group_mlp: idx {tuple(idx.shape)} for table "
                         f"{tuple(table.shape)}, {len(ws)} weights and {len(bs)} biases")
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
    if bs[0].shape != (f0p,) or any(b.dtype != torch.float32 for b in bs):
        raise ValueError("fused_group_mlp: need f32 biases, the first (F0P,)")
    tensors = [table, cent, idx, *ws, *bs] + ([] if fold else [xyz, w0x])
    if not all(t.is_cuda and t.device == table.device for t in tensors):
        raise ValueError("fused_group_mlp: all operands must be on one CUDA device")


def pad_idx(idx, N: int):
    """Check the indices against [0, N) (a host sync) and pad K to the
    kernels' 16-row tile by repeating each row's first neighbour (a
    duplicate cannot change the max; the backward gives it no cotangent)
    -> contiguous int32 (B, S, kp), kp a power of two from 16 to 1024."""
    B, S, K = idx.shape
    if idx.numel():
        lo, hi = torch.aminmax(idx)
        with counts.sync("mlp.index_check", reads=2):
            lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= N:
            raise ValueError(f"fused_group_mlp: indices outside [0, {N})")
    kp = padded_k(K)
    idx = idx.to(torch.int32)
    if kp != K:
        idx = torch.cat([idx, idx[..., :1].expand(B, S, kp - K)], dim=-1)
    return idx.contiguous()


def _check_aligned(*tensors):
    """The kernels copy table rows, fold centroids and weights in 16-byte
    pieces."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_group_mlp: operands must start on a 16-byte boundary")


def _layer_args(table, ws, bs):
    """-> (n_layers, widths, the weights of layers 1.. back to back (bf16,
    None for one layer), the biases back to back (f32), the widths as a C
    array): the kernels read the layers from these two buffers and a layer
    table, so a stack may be any depth."""
    n_layers = 1 + len(ws)
    widths = [table.shape[2]] + [w.shape[1] for w in ws]
    w_all = torch.cat([w.reshape(-1) for w in ws]) if ws else None
    b_all = torch.cat([b.reshape(-1) for b in bs])
    return n_layers, widths, w_all, b_all, (ctypes.c_int * n_layers)(*widths)


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD = _build.Entry("mlp", "fused_group_mlp_launch",
                    (I,) + (P,) * 5 + (I,) * 5 + (P,) * 5 + (LL, P))
_BWD = _build.Entry("mlp", "fused_group_mlp_bwd_launch",
                    (I,) + (P,) * 5 + (I,) * 6 + (P,) * 11 + (I,) + (P,) * 4 + (LL, P))
_SCRATCH = _build.Entry("mlp", "fused_group_mlp_scratch", (I,) * 5 + (P,), LL)
_FORCE_GLOBAL = _build.Entry("mlp", "fused_group_mlp_force_global", (I,), None)
_GRAD_SIZE = _build.Entry("mlp", "fused_group_mlp_grad_size", (I, P))
_BWD_GRID = _build.Entry("mlp", "fused_group_mlp_bwd_grid", (I,) * 5 + (P,) * 2)


@functools.lru_cache(maxsize=None)
def _scratch_bytes(fold: int, B: int, S: int, kp: int, widths: tuple, device: int) -> int:
    """The forward's global scratch at a shape (0: its plan keeps the
    activations in shared memory; -1: no plan fits), on ``device``'s SM
    count; remembered, since a launch's host time counts."""
    with torch.cuda.device(device):
        return _SCRATCH(fold, B, S, kp, len(widths), (ctypes.c_int * len(widths))(*widths))


def _launch(fold, table, xyz, cent, w0x, ws, bs, idx, checked: bool = False):
    """The forward kernel on CUDA tensors; ``checked`` idx comes from
    :func:`pad_idx` already."""
    _check_operands(fold, table, xyz, cent, w0x, ws, bs, idx)
    B, N, _ = table.shape
    S = idx.shape[1]
    table, cent = table.contiguous(), cent.contiguous()
    n_layers, widths, w_all, b_all, c_widths = _layer_args(table, ws, bs)
    xyz_c = xyz.contiguous() if not fold else None
    w0x_c = w0x.contiguous() if not fold else None
    _check_aligned(table, cent)
    # the index check waits for the card: everything else is ready first, so
    # the launch follows it at once
    if not checked:
        idx = pad_idx(idx, N)
    kp = idx.shape[2]
    # a centroid over two or more 64-row blocks maxes into a zeroed output
    out = (torch.zeros if kp > 64 else torch.empty)((B, S, widths[-1]), dtype=torch.float32,
                                                    device=table.device)
    scratch_bytes = _scratch_bytes(int(fold), B, S, kp, tuple(widths), table.device.index)
    if scratch_bytes < 0:
        raise ValueError(f"fused_group_mlp: widths {widths} at K={kp} fit no plan of the kernel")
    scratch = (torch.empty((scratch_bytes,), dtype=torch.uint8, device=table.device)
               if scratch_bytes else None)
    _build.launch("fused_group_mlp_max", _FWD, table, int(fold), table.data_ptr(),
                  0 if fold else xyz_c.data_ptr(), cent.data_ptr(),
                  0 if fold else w0x_c.data_ptr(), idx.data_ptr(), B, N, S, kp, n_layers,
                  w_all.data_ptr() if ws else 0, b_all.data_ptr(), c_widths, out.data_ptr(),
                  scratch.data_ptr() if scratch_bytes else 0, scratch_bytes)
    return out


@contextlib.contextmanager
def global_plan():
    """Every launch inside takes the kernels' global plan (activations in
    global memory, every product staged), whatever else fits: the plans must
    compute the same bits (needs a card)."""
    _FORCE_GLOBAL(1)
    _scratch_bytes.cache_clear()
    try:
        yield
    finally:
        _FORCE_GLOBAL(0)
        _scratch_bytes.cache_clear()


def _nomatch_counter(device) -> torch.Tensor:
    if device not in _nomatch:
        _nomatch[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _nomatch[device]


def nomatch_count(device=None) -> int:
    """The backward's dropped-cotangent count on ``device`` (a host sync)."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    return int(_nomatch_counter(torch.device(device)).item())


def reset_nomatch(device=None) -> None:
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    _nomatch_counter(torch.device(device)).zero_()


def _launch_bwd(fold, table, xyz, cent, w0x, ws, bs, idx, K: int, out, ct):
    """The backward kernel on CUDA tensors.  ``idx`` (B, S, kp) is the
    forward's checked and padded index tensor (:func:`pad_idx`), ``K`` the
    real neighbour count, ``out`` the forward's (B, S, CoutP) output, ``ct``
    its cotangent -> as :func:`fused_group_backward_plain`."""
    _check_operands(fold, table, xyz, cent, w0x, ws, bs, idx, backward=True)
    B, N, f0p = table.shape
    S, kp = idx.shape[1], idx.shape[2]
    if idx.dtype != torch.int32 or not idx.is_contiguous() or kp != padded_k(K) or K < 1:
        raise ValueError(f"fused_group_mlp backward: idx {tuple(idx.shape)} {idx.dtype} "
                         f"with K={K} is not the forward's padded index")
    table, cent = table.contiguous(), cent.contiguous()
    n_layers, widths, w_all, b_all, c_widths = _layer_args(table, ws, bs)
    cout = widths[-1]
    if out.shape != (B, S, cout) or ct.shape != (B, S, cout):
        raise ValueError(f"fused_group_mlp backward: out {tuple(out.shape)}, ct "
                         f"{tuple(ct.shape)}, need {(B, S, cout)}")
    out = out.to(torch.float32).contiguous()
    ct = ct.to(torch.float32).contiguous()
    dev = table.device
    size = _GRAD_SIZE(n_layers, c_widths)
    scratch_bytes = ctypes.c_longlong(0)
    grid = _BWD_GRID(int(fold), B, S, kp, n_layers, c_widths, ctypes.byref(scratch_bytes))
    if grid < 0:
        raise ValueError(f"fused_group_mlp backward: widths {widths} at K={kp} fit no plan of "
                         f"the kernel")
    _check_aligned(table, cent)
    # past 128 neighbours a centroid spans two tiles: the count pass's tie
    # counts, and each tile's dcent added into a zeroed one
    span = kp > 128
    dtable = torch.empty((B, N, f0p), dtype=torch.float32, device=dev)
    dxyz = None if fold else torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    dcent = (torch.zeros if span else torch.empty)((B, S, f0p if fold else 3),
                                                   dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, S, cout), dtype=torch.int32, device=dev) if span else None
    # bf16(dz_0) (and bf16(drel)) per (b, s, k) row, scattered onto the table
    # rows after the main kernel
    dz0 = torch.empty((B, S, kp, f0p), dtype=torch.bfloat16, device=dev)
    drel = None if fold else torch.empty((B, S, kp, 3), dtype=torch.bfloat16, device=dev)
    part = torch.zeros((grid, size), dtype=torch.float32, device=dev)
    grads = torch.empty((size,), dtype=torch.float32, device=dev)
    scratch = (torch.empty((scratch_bytes.value,), dtype=torch.uint8, device=dev)
               if scratch_bytes.value else None)
    xyz_c = None if fold else xyz.contiguous()
    w0x_c = None if fold else w0x.contiguous()
    _build.launch("fused_group_mlp_backward", _BWD, table, int(fold), table.data_ptr(),
                  0 if fold else xyz_c.data_ptr(), cent.data_ptr(),
                  0 if fold else w0x_c.data_ptr(), idx.data_ptr(), B, N, S, kp, K, n_layers,
                  w_all.data_ptr() if ws else 0, b_all.data_ptr(), c_widths, out.data_ptr(),
                  ct.data_ptr(), dz0.data_ptr(), 0 if fold else drel.data_ptr(),
                  dtable.data_ptr(), 0 if fold else dxyz.data_ptr(), dcent.data_ptr(),
                  part.data_ptr(), grid, grads.data_ptr(), _nomatch_counter(dev).data_ptr(),
                  cnt.data_ptr() if span else 0,
                  scratch.data_ptr() if scratch is not None else 0, scratch_bytes.value)
    # the partial layout of csrc/mlp.cu (grad_layout)
    off, dws, dbs = 0, [], []
    for j in range(1, n_layers):
        dws.append(grads[off: off + widths[j - 1] * widths[j]].view(widths[j - 1], widths[j]))
        off += widths[j - 1] * widths[j]
    for j in range(n_layers):
        dbs.append(grads[off: off + widths[j]])
        off += widths[j]
    dw0x = None if fold else grads[off: off + 6 * f0p].view(6, f0p)
    return dtable, dxyz, dcent, dw0x, dws, dbs


def fused_group(fold, table, xyz, cent, w0x, ws, bs, idx, checked: bool = False):
    """The forward kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if table.is_cuda:
        return _launch(fold, table, xyz, cent, w0x, ws, bs, idx, checked=checked)
    if table.device.type == "cpu":
        return fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
    raise ValueError(f"fused_group_mlp: unsupported device {table.device}")


def fused_group_backward(fold, table, xyz, cent, w0x, ws, bs, idx, K, out, ct):
    """The backward kernel for CUDA tensors, the plain version for CPU
    tensors (whose ``idx`` is unpadded)."""
    if table.is_cuda:
        return _launch_bwd(fold, table, xyz, cent, w0x, ws, bs, idx, K, out, ct)
    if table.device.type == "cpu":
        return fused_group_backward_plain(fold, table, xyz, cent, w0x, ws, bs, idx, out, ct)
    raise ValueError(f"fused_group_mlp backward: unsupported device {table.device}")


def _assemble(fold, xyz, features, new_xyz, weights, grads, need_geometry=(True, True),
              use_xyz: bool = True):
    """The padded operands' gradients -> (dxyz, dfeatures, dnew_xyz,
    [dweights], [dbiases]) in parameter space (``_pallas_bwd``'s assembly
    after the kernel; ``need_geometry`` skips dxyz / dnew_xyz)."""
    dtable, dxyz_k, dcent, dw0x, dws, dbs = grads
    w0 = weights[0].to(torch.float32)
    f0 = w0.shape[1]
    w0x3, w0f = (w0[:3], w0[3:]) if use_xyz else (None, w0)
    dP = dtable[..., :f0]
    dfeatures = _bf16(dP) @ _bf16(w0f).t()
    dw0f = torch.einsum("bnc,bnf->cf", _bf16(features), _bf16(dP))
    dxyz = dnew_xyz = None
    if not use_xyz:
        # no geometry term: xyz and new_xyz get zero gradients, as in JAX
        dxyz = torch.zeros_like(xyz, dtype=torch.float32) if need_geometry[0] else None
        dnew_xyz = torch.zeros_like(new_xyz, dtype=torch.float32) if need_geometry[1] else None
        dweights = [dw0f]
    elif fold:
        dcent_f = dcent[..., :f0]
        if need_geometry[0]:
            dxyz = dP @ w0x3.t()
        if need_geometry[1]:
            dnew_xyz = dcent_f @ w0x3.t()
        dw0x3 = (torch.einsum("bnc,bnf->cf", xyz.to(torch.float32), dP)
                 + torch.einsum("bsc,bsf->cf", new_xyz.to(torch.float32), dcent_f))
    else:
        # x rides the kernel as a hi/lo pair: the hi lanes carry its
        # gradient, the lo cast has zero derivative; the hi and lo rows of
        # w0x are the same parameter
        dxyz, dnew_xyz = dxyz_k, dcent[..., :3]
        dw0x3 = dw0x[0:3, :f0] + dw0x[3:6, :f0]
    if use_xyz:
        dweights = [torch.cat([dw0x3, dw0f], 0)]
    for w, dw in zip(weights[1:], dws):
        dweights.append(dw[: w.shape[0], : w.shape[1]])
    dbiases = [db[: w.shape[1]] for db, w in zip(dbs, weights)]
    return dxyz, dfeatures, dnew_xyz, dweights, dbiases


class FusedGroupMLP(torch.autograd.Function):
    """Fused gather + MLP + max: the forward kernel (K2) and the backward
    kernel (K7) on CUDA tensors, the plain versions on CPU tensors.  The
    backward takes the forward's operands, checked and padded indices and
    output from the context; it does not check the indices again."""

    @staticmethod
    def forward(ctx, mode, xyz, features, new_xyz, idx, n_layers, *params):
        weights, biases = params[:n_layers], params[n_layers:]
        use_xyz = mode != "none"
        fold = mode != "hilo"  # "none" runs the fold route with a zero centroid term
        ops = prepare_operands(fold, xyz, features, new_xyz, weights, biases, use_xyz)
        ctx.K = idx.shape[2]
        if ops[0].is_cuda:
            idx = pad_idx(idx, features.shape[1])
        out = fused_group(fold, ops[0], xyz, *ops[1:], idx, checked=True)
        table, cent, w0x, ws, bs = ops
        ctx.fold, ctx.use_xyz, ctx.n_ws = fold, use_xyz, len(ws)
        ctx.save_for_backward(xyz, features, new_xyz, idx, out, table, cent,
                              w0x if w0x is not None else table.new_empty(0),
                              *ws, *bs, *weights)
        return out[..., : weights[-1].shape[1]].clone()

    @staticmethod
    def backward(ctx, ct):
        xyz, features, new_xyz, idx, out, table, cent, w0x, *rest = ctx.saved_tensors
        ws, bs = rest[: ctx.n_ws], rest[ctx.n_ws: 2 * ctx.n_ws + 1]
        weights = rest[2 * ctx.n_ws + 1:]
        ct = _pad(ct.to(torch.float32), out.shape)
        grads = fused_group_backward(ctx.fold, table, xyz, cent, None if ctx.fold else w0x,
                                     ws, bs, idx, ctx.K, out, ct)
        need = ctx.needs_input_grad
        dxyz, dfeat, dnew, dws, dbs = _assemble(ctx.fold, xyz, features, new_xyz, weights,
                                                grads, need_geometry=(need[1], need[3]),
                                                use_xyz=ctx.use_xyz)
        cast = lambda g, like, i: g.to(like.dtype) if need[i] and g is not None else None
        return (None, cast(dxyz, xyz, 1), cast(dfeat, features, 2), cast(dnew, new_xyz, 3),
                None, None, *dws, *dbs)


def fused_group_mlp_max(xyz, features, new_xyz, idx, weights, biases,
                        use_xyz: bool = True, fold_geometry: bool = False):
    """Fused ``group_points`` + MLP stack + max over K; differentiable in
    ``xyz``, ``features``, ``new_xyz``, ``weights`` and ``biases``.

    :param xyz: (B, N, 3) f32; features: (B, N, C); new_xyz: (B, S, 3)
    :param idx: (B, S, K) neighbourhood indices
    :param weights: list of (Ci, Ci+1), ``weights[0]`` with Cin = 3 + C
        (``use_xyz``) or C
    :param fold_geometry: the fold route (ignored without ``use_xyz``)
    :return: (B, S, Cout) f32
    """
    mode = ("fold" if fold_geometry else "hilo") if use_xyz else "none"
    return FusedGroupMLP.apply(mode, xyz, features, new_xyz, idx, len(weights),
                               *weights, *biases)


def fused_mlp_max(grouped, weights, biases, compute_dtype=torch.bfloat16):
    """(B, S, K, Cin) -> (B, S, Cout): MLP stack + max over K on an already
    grouped tensor, activations rounded to ``compute_dtype`` between layers
    (the unfused route; plain torch)."""
    x = grouped.to(compute_dtype)
    for w, b in zip(weights, biases):
        y = x.to(torch.float32) @ w.to(compute_dtype).to(torch.float32)
        x = torch.relu(y + b.to(torch.float32)).to(compute_dtype)
    return x.to(torch.float32).amax(dim=2)
