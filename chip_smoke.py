#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port runs on the card.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero and the final ``ok`` line is not printed):

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build the hand-written kernels from the five ``pointrcnn_tpu_torch/csrc``
   sources
   (one ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the forward gives it, time both, and compute its bound;
4. drive the main path (``pointrcnn_tpu_torch.entry``: the two-stage eval
   forward of ``cfgs/default.yaml`` as it stands) at batch 4 x 16384 points
   on seeded clouds, check shapes, finiteness and that every kernel
   launched; run a cloud with a dense z-cluster that must take the
   full-scan fallback of the banded stage; hold a batch-1 forward against
   the port's plain path on the CPU; time frames/s;
5. the same for the exact-method setting (``entry.EXACT_OVERRIDES``) on
   one cloud;
6. the gather backward (K8) against its plain version at the ``rpn``
   training stage's shapes (RPN SA2-SA4, K = 16 and 32, batch 16):
   deterministic, equal to the plain version on the CPU, within the f32
   reorder bound of the plain version on the card;
7. the ``rpn`` training stage (``pointrcnn_tpu_torch.entry.train_entry``:
   ``cfgs/default.yaml`` with ``RCNN.ENABLED`` False) at batch 16 x 16384
   points: ms/step, frames/s and peak memory over timed steps, every kernel
   of the path launched (the gather forward and backward 6 times a step),
   parameters and BN statistics updated, a batch-2 step against the port's
   CPU path, and a checkpoint resume that reproduces the next step's loss;
8. the fused MLP backward (K7) against its plain version at the ``rcnn``
   training stage's shapes (RCNN SA1 fold, SA2 hilo, batch 4) and at the
   shapes its tiles branch on (three layers at K=32, four ragged layers at
   K=8, K=16, the widest stack it takes): deterministic, no dropped tie,
   within the stated norm bound of the plain version on the card (checked
   with the kernels in phase 3); TFLOP/s and share of the bound per shape;
9. the ``rcnn`` training stage (``train_entry(stage="rcnn")``: a fixed RPN
   from the rpn stage's checkpoint, online proposals and targets) at batch
   4 x 16384 points: ms/step, frames/s and peak memory, the launches of a
   step (K2 6, K7 2, K4 2, K8 0), every RCNN parameter updated, every RPN
   parameter moved by the weight decay alone and its BN statistics still,
   and a batch-1 step against the port's CPU path.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4
CLOUD_SEEDS = (0, 1, 2)
TIMED_ITERS = 10
TRAIN_BATCH = 16
TRAIN_WARMUP, TRAIN_TIMED = 2, 5

# bf16-path tolerance of the fused MLP kernel against its plain version on
# the same operands: both multiply bf16 values exactly and accumulate in
# f32, but in another order, so a hidden activation can round to the
# neighbouring bf16 value (2^-8 relative) and carry that into the next
# layer; the bound is relative to the output's largest magnitude
MLP_REL_TOL = 2.0 ** -8

# the H100 SXM's published peaks at 700 W (dense): memory bytes/ms, FP32
# outside the tensor cores and bf16 tensor-core operations/ms
PEAK_BYTES_PER_MS = 3.35e12 / 1e3
PEAK_F32_PER_MS = 67e12 / 1e3
PEAK_BF16_PER_MS = 989e12 / 1e3

# (kernel, source, TPU kernel it replaces, counter module, counter name)
KERNELS = (
    ("fps", "pointrcnn_tpu_torch/csrc/fps.cu", "pointrcnn_tpu/ops/pallas_fps.py:34",
     "cuda_fps", "launches"),
    ("three_nn", "pointrcnn_tpu_torch/csrc/knn.cu", "pointrcnn_tpu/ops/pallas_knn.py:25",
     "cuda_knn", "launches"),
    ("group_gather", "pointrcnn_tpu_torch/csrc/gather.cu",
     "pointrcnn_tpu/ops/pallas_gather.py:69", "cuda_gather", "launches"),
    ("fused_group_mlp_max", "pointrcnn_tpu_torch/csrc/mlp.cu",
     "pointrcnn_tpu/ops/pallas_mlp.py:84", "cuda_mlp", "launches"),
    ("ball_query", "pointrcnn_tpu_torch/csrc/ballquery.cu",
     "pointrcnn_tpu/ops/pallas_ballquery.py:151", "cuda_ballquery", "launches"),
    ("ball_query_banded", "pointrcnn_tpu_torch/csrc/ballquery.cu",
     "pointrcnn_tpu/ops/pallas_ballquery.py:229", "cuda_ballquery", "banded_launches"),
    ("gather_backward", "pointrcnn_tpu_torch/csrc/gather.cu",
     "pointrcnn_tpu/ops/pallas_gather.py:95", "cuda_gather", "bwd_launches"),
    ("fused_group_mlp_backward", "pointrcnn_tpu_torch/csrc/mlp.cu",
     "pointrcnn_tpu/ops/pallas_mlp.py:458", "cuda_mlp", "bwd_launches"),
)
# the kernels of each path: the eval forward, the rpn and the rcnn training
# stages
EVAL_KERNELS = ("fps", "three_nn", "group_gather", "fused_group_mlp_max", "ball_query",
                "ball_query_banded")
TRAIN_KERNELS = ("fps", "three_nn", "group_gather", "ball_query", "ball_query_banded",
                 "gather_backward")
RCNN_TRAIN_KERNELS = ("fps", "three_nn", "group_gather", "fused_group_mlp_max", "ball_query",
                      "ball_query_banded", "fused_group_mlp_backward")
# launches a step of the rcnn stage: K2 at RPN SA3 and SA4 (two radii each,
# eval) and RCNN SA1 and SA2, K7 at RCNN SA1 and SA2, K4 at RPN SA2 (two
# radii, eval), no K8 (nothing before the RCNN's SA stacks needs a gradient)
RCNN_STEP_LAUNCHES = {"fused_group_mlp_max": 6, "fused_group_mlp_backward": 2,
                      "group_gather": 2, "gather_backward": 0}
RCNN_BATCH = 4

# a batch-2 train step on the card against the same step on the CPU (plain
# versions), both in bf16: f32 sums in another order flip bf16 roundings,
# and the gradients of the deep BN layers move with them (the CPU tests
# measure the same spread between the port and JAX): the loss within 1e-3
# relative, the gradient norm within 2e-2, each gradient leaf within 0.1 of
# the global gradient norm
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_SHARE = 1e-3, 2e-2, 0.1
# a batch-1 rcnn step on the card against the CPU path from the same RPN
# outputs, weights and target draws: the proposal and target layers decide
# the same, so the RCNN's K2/K7 against their plain versions (f32 sums in
# another order; a maximum within an ulp of its runner-up can take another
# neighbour) is what differs: the loss within 1e-3 relative, the gradient
# norm within 1e-2, each RCNN gradient leaf within 5e-2 of the global norm
RCNN_LOSS_RTOL, RCNN_GNORM_RTOL, RCNN_LEAF_SHARE = 1e-3, 1e-2, 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rate(ops: float, ms: float, bound_ms: float) -> str:
    """A bf16 kernel's achieved rate and its time's share of the bound."""
    return f"{ops / ms / 1e9:.1f} TFLOP/s, bound / kernel {bound_ms / ms:.3f}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Tally:
    """One kernel's sums over the main path's shapes: kernel and plain ms,
    and the bound (the larger of bytes over the memory rate and operations
    over the peak rate of their type, per shape)."""

    def __init__(self):
        self.err = self.ms = self.plain_ms = self.bound_ms = 0.0
        self.by = {"bytes": 0.0, "operations": 0.0}
        # the time of one PyTorch call computing the same function, where one exists
        self.library_ms = None

    def add(self, ms, plain_ms, n_bytes, ops, peak_per_ms):
        b, o = n_bytes / PEAK_BYTES_PER_MS, ops / peak_per_ms
        self.ms, self.plain_ms = self.ms + ms, self.plain_ms + plain_ms
        self.bound_ms += max(b, o)
        self.by["bytes" if b >= o else "operations"] += max(b, o)
        return max(b, o)

    def row(self):
        return {"max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": max(self.by, key=self.by.get),
                "library_ms": self.library_ms}


def counters():
    from pointrcnn_tpu_torch.ops import (cuda_ballquery, cuda_fps, cuda_gather, cuda_knn,
                                         cuda_mlp)

    mods = {"cuda_fps": cuda_fps, "cuda_knn": cuda_knn, "cuda_gather": cuda_gather,
            "cuda_mlp": cuda_mlp, "cuda_ballquery": cuda_ballquery}
    return {name: (mods[mod], attr) for name, _, _, mod, attr in KERNELS}


def reset_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


def phase_build():
    from pointrcnn_tpu_torch import _build

    sources = (("fps", _build.NO_FMAD), ("knn", _build.NO_FMAD), ("gather", _build.NO_FMAD),
               ("mlp", _build.NO_FMAD), ("ballquery", _build.NO_FMAD))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(_build.load, name, flags) for name, flags in sources]:
            f.result()
    log(f"build {', '.join(n + '.cu' for n, _ in sources)} in parallel: "
        f"{time.perf_counter() - t0:.2f} s")


def _rpn_cloud(b, n, seed):
    from pointrcnn_tpu_torch.entry import synthetic_cloud

    return torch.from_numpy(synthetic_cloud(b, n, seed)).cuda()


def _roi_cloud(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, n, 3), generator=g) * torch.tensor([4.0, 2.0, 6.0]) - 2.0).cuda()


def check_fps():
    from pointrcnn_tpu_torch.ops import cuda_fps

    tally = Tally()
    # (rows, N, npoint, cloud, on the main path): the default path's rows
    # (RPN SA1 in 16 bands, SA2 in 4, SA3, SA4, RCNN SA1, SA2), then the
    # exact setting's RPN SA1 and SA2
    for (b, n, npoint, cloud, main) in (
            (64, 1024, 256, _rpn_cloud, True), (16, 1024, 256, _rpn_cloud, True),
            (4, 1024, 256, _rpn_cloud, True), (4, 256, 64, _rpn_cloud, True),
            (400, 512, 128, _roi_cloud, True), (400, 128, 32, _roi_cloud, True),
            (4, 16384, 4096, _rpn_cloud, False), (4, 4096, 1024, _rpn_cloud, False)):
        xyz = cloud(b, n, n)
        got = cuda_fps._launch(xyz, npoint)
        ref = cuda_fps.furthest_point_sample_plain(xyz, npoint)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps {b}x{n}->{npoint}: {(got != ref).sum().item()} picks differ")
        k = cuda_ms(lambda: cuda_fps._launch(xyz, npoint), 5)
        p = cuda_ms(lambda: cuda_fps.furthest_point_sample_plain(xyz, npoint), 1)
        # per step and point: 3 sub, 3 mul, 2 add, a min and a compare
        ops, nb = 10.0 * b * (npoint - 1) * n, nbytes(xyz, got)
        bound = tally.add(k, p, nb, ops, PEAK_F32_PER_MS) if main else \
            max(nb / PEAK_BYTES_PER_MS, ops / PEAK_F32_PER_MS)
        log(f"fps {b}x{n}->{npoint}{'' if main else ' (exact setting)'}: exact match; "
            f"kernel {k:.4f} ms, plain {p:.4f} ms, bound {bound:.4f} ms")
    # a ragged row length (masked threads), off the forward's shapes
    xyz = _roi_cloud(3, 1000, 1)
    if not torch.equal(cuda_fps._launch(xyz, 77), cuda_fps.furthest_point_sample_plain(xyz, 77)):
        raise AssertionError("fps 3x1000->77 differs")
    log("fps 3x1000->77: exact match")
    return tally


def check_knn():
    from pointrcnn_tpu_torch.ops import cuda_knn

    tally = Tally()
    for n, m in ((256, 64), (1024, 256), (4096, 1024), (16384, 4096)):
        u, kn = _rpn_cloud(BATCH, n, n), _rpn_cloud(BATCH, m, m + 1)
        d, i = cuda_knn._launch(u, kn)
        rd, ri = cuda_knn.three_nn_plain(u, kn)
        if not torch.equal(i, ri):
            raise AssertionError(f"three_nn {n}x{m}: {(i != ri).sum().item()} indices differ")
        e = (d - rd).abs().max().item()
        if e != 0.0:
            raise AssertionError(f"three_nn {n}x{m}: distances differ by {e}")
        k = cuda_ms(lambda: cuda_knn._launch(u, kn), 10)
        p = cuda_ms(lambda: cuda_knn.three_nn_plain(u, kn), 3)
        # per pair: 3 sub, 3 mul, 2 add and a compare
        bound = tally.add(k, p, nbytes(u, kn, d, i), 9.0 * BATCH * n * m, PEAK_F32_PER_MS)
        log(f"three_nn B={BATCH} n={n} m={m}: exact match; kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, bound {bound:.4f} ms")
    return tally


# (name, B, N, C, S): the gather's tables: RPN SA2 of the eval forward; RPN
# SA2, SA3 and SA4 of the rpn training stage (every BN-train SA stage
# groups through it)
GATHER_SHAPES = (("eval RPN SA2", BATCH, 4096, 96, 1024),
                 ("train RPN SA2", TRAIN_BATCH, 4096, 96, 1024),
                 ("train RPN SA3", TRAIN_BATCH, 1024, 256, 256),
                 ("train RPN SA4", TRAIN_BATCH, 256, 512, 64))


def _gather_case(B, N, C, S, K, seed):
    """Seeded operands at one gather shape: neighbourhoods with repeats
    (the first quarter of the centroids backfilled from slot K/2 on, as the
    ball query backfills) and a bf16 cotangent."""
    g = torch.Generator().manual_seed(seed)
    xyz = _rpn_cloud(B, N, seed)
    feats = torch.randn((B, N, C), generator=g).cuda()
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    ct = torch.randn((B, S, K, 3 + C), generator=g).to(torch.bfloat16)
    return xyz, feats, xyz[:, :S] + 0.1, idx.cuda(), ct


def check_gather():
    from pointrcnn_tpu_torch.ops import cuda_gather

    tally = Tally()
    for name, B, N, C, S in GATHER_SHAPES:
        for K in (16, 32):
            xyz, feats, cent, idx, _ = _gather_case(B, N, C, S, K, N + K)
            got = cuda_gather._launch(xyz, feats, cent, idx)
            ref = cuda_gather.group_points_plain(xyz, feats, cent, idx)
            if not torch.equal(got, ref):
                raise AssertionError(f"gather {name} K={K}: {(got != ref).sum().item()} values differ")
            k = cuda_ms(lambda: cuda_gather._launch(xyz, feats, cent, idx), 20)
            p = cuda_ms(lambda: cuda_gather.group_points_plain(xyz, feats, cent, idx), 5)
            # a split, a subtraction and a cast per output value
            bound = tally.add(k, p, nbytes(xyz, feats, cent, idx, got), 3.0 * got.numel(),
                              PEAK_F32_PER_MS)
            log(f"gather {name} B={B} N={N} C={C} S={S} K={K}: exact match; kernel {k:.4f} ms, "
                f"plain {p:.4f} ms, bound {bound:.4f} ms")
    return tally


def check_gather_bwd():
    """K8 at the training stage's shapes: two launches bit-equal (the
    design sums in a fixed order), bit-equal to the plain version on the CPU
    (index_add_ adds in ascending (s, k) order there, as the kernel does),
    and within the reorder bound 2 m 2^-24 sum|ct| (m = S*K terms at most)
    of the plain version on the card, whose index_add_ adds atomically in
    any order."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    tally = Tally()
    tally.library_ms = 0.0
    for name, B, N, C, S in GATHER_SHAPES[1:]:
        for K in (16, 32):
            _, _, _, idx, ct_cpu = _gather_case(B, N, C, S, K, 7 * N + K)
            ct = ct_cpu.cuda()
            got = cuda_gather._launch_bwd(idx, ct, N)
            again = cuda_gather._launch_bwd(idx, ct, N)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"gather backward {name} K={K}: two launches differ")
            cpu = cuda_gather.group_points_backward_plain(idx.cpu(), ct_cpu, N)
            for what, a, b in zip(("dtable", "dcent"), got, cpu):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"gather backward {name} K={K}: {what} differs from the "
                                         f"CPU plain version in {(a.cpu() != b).sum().item()} places")
            ref = cuda_gather.group_points_backward_plain(idx, ct, N)
            abs_sum = cuda_gather.group_points_backward_plain(idx, ct.float().abs(), N)
            for what, a, b, m in zip(("dtable", "dcent"), got, ref, abs_sum):
                bound = 2 * S * K * 2.0 ** -24 * m.abs()
                if not bool(((a - b).abs() <= bound).all()):
                    raise AssertionError(f"gather backward {name} K={K}: {what} outside the "
                                         f"reorder bound of the plain version")
                tally.err = max(tally.err, (a - b).abs().max().item())
            k = cuda_ms(lambda: cuda_gather._launch_bwd(idx, ct, N), 20)
            p = cuda_ms(lambda: cuda_gather.group_points_backward_plain(idx, ct, N), 5)
            rows = (idx.long() + torch.arange(B, device="cuda")[:, None, None] * N).reshape(-1)
            src = ct.reshape(-1, 3 + C).float()
            out = torch.zeros((B * N, 3 + C), device="cuda")
            lib = cuda_ms(lambda: out.index_add_(0, rows, src), 20)
            tally.library_ms += lib
            # read ct (bf16) and idx once, write dtable and dcent once; one
            # add per cotangent value
            nb = nbytes(idx, ct, *got)
            bound = tally.add(k, p, nb, float(ct.numel()), PEAK_F32_PER_MS)
            log(f"gather backward {name} B={B} N={N} C={C} S={S} K={K}: deterministic, equal to "
                f"the CPU plain version, max err {tally.err:.3e} vs the card's plain version; "
                f"kernel {k:.4f} ms, plain {p:.4f} ms, index_add_ {lib:.4f} ms, "
                f"bound {bound:.4f} ms")
    return tally


# (name, B, N, C, S, K, widths, the forward's mode, cloud): the four SA shapes
MLP_SHAPES = (
    ("RPN SA3", 4, 1024, 256, 256, 16, (128, 196, 256), "hilo", _rpn_cloud),
    ("RPN SA3", 4, 1024, 256, 256, 32, (128, 196, 256), "hilo", _rpn_cloud),
    ("RPN SA4", 4, 256, 512, 64, 16, (256, 256, 512), "hilo", _rpn_cloud),
    ("RPN SA4", 4, 256, 512, 64, 32, (256, 384, 512), "hilo", _rpn_cloud),
    ("RCNN SA1", 400, 512, 128, 128, 64, (128, 128, 128), "fold", _roi_cloud),
    ("RCNN SA2", 400, 128, 128, 32, 64, (128, 128, 256), "hilo", _roi_cloud),
)


def check_mlp():
    from pointrcnn_tpu_torch.models.layers import torch_conv_init
    from pointrcnn_tpu_torch.ops import cuda_mlp

    tally = Tally()
    for name, B, N, C, S, K, widths, slice_mode, cloud in MLP_SHAPES:
        g = torch.Generator().manual_seed(N + K)
        xyz = cloud(B, N, N)
        feats = torch.relu(torch.randn((B, N, C), generator=g)).cuda()
        new_xyz = xyz[:, :S].contiguous()
        idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32).cuda()
        ws, bs, cin = [], [], 3 + C
        for f in widths:
            ws.append(torch_conv_init(cin, f, g).cuda())
            bs.append((torch.randn(f, generator=g) * 0.1).cuda())
            cin = f
        # the kernel's products: the xyz lanes of layer 0 (its feature part
        # is the table, made before the launch) and every later layer
        macs = 3 * widths[0] + sum(a * b for a, b in zip(widths, widths[1:]))
        for mode in ("hilo", "fold"):
            fold = mode == "fold"
            ops = cuda_mlp.prepare_operands(fold, xyz, feats, new_xyz, ws, bs)
            got = cuda_mlp._launch(fold, *ops[:1], xyz, *ops[1:], idx)
            ref = cuda_mlp.fused_group_plain(fold, *ops[:1], xyz, *ops[1:], idx)
            scale = ref.abs().max().item()
            e = (got - ref).abs().max().item()
            if not (torch.isfinite(got).all() and e <= MLP_REL_TOL * scale):
                raise AssertionError(f"fused mlp {name} K={K} {mode}: max err {e} vs scale {scale}")
            k = cuda_ms(lambda: cuda_mlp._launch(fold, *ops[:1], xyz, *ops[1:], idx), 10)
            # the kernel alone: the wrapper's index check (a host sync) done once
            idx_p = cuda_mlp.pad_idx(idx, N)
            alone = cuda_ms(lambda: cuda_mlp._launch(fold, *ops[:1], xyz, *ops[1:], idx_p,
                                                     checked=True), 10)
            p = cuda_ms(lambda: cuda_mlp.fused_group_plain(fold, *ops[:1], xyz, *ops[1:], idx), 3)
            table, cent, w0x, lws, lbs = ops
            nb = nbytes(table, None if fold else xyz, cent, w0x, *lws, *lbs, idx, got)
            ops_n, tag = 2.0 * B * S * K * macs, ""
            if mode == slice_mode:
                tally.add(k, p, nb, ops_n, PEAK_BF16_PER_MS)
                tally.err = max(tally.err, e)
                tag = " (the forward's mode)"
            bound = max(nb / PEAK_BYTES_PER_MS, ops_n / PEAK_BF16_PER_MS)
            log(f"fused mlp {name} B={B} N={N} C={C} S={S} K={K} {widths} {mode}{tag}: "
                f"max err {e:.3e} (scale {scale:.3e}, tol {MLP_REL_TOL} x scale); "
                f"kernel {k:.4f} ms, plain {p:.4f} ms, bound {bound:.4f} ms; {_rate(ops_n, k, bound)}; "
                f"kernel alone {alone:.4f} ms, {_rate(ops_n, alone, bound)}")
    # off the forward's shapes: K padded 8 -> 16, a ragged last block of
    # centroids (S=10), widths padded to 16, four layers
    g = torch.Generator().manual_seed(3)
    xyz = _roi_cloud(2, 100, 2)
    feats = torch.randn((2, 100, 20), generator=g).cuda()
    idx = torch.randint(0, 100, (2, 10, 8), generator=g, dtype=torch.int32).cuda()
    ws, bs, cin = [], [], 23
    for f in (24, 40, 36, 20):
        ws.append(torch_conv_init(cin, f, g).cuda())
        bs.append((torch.randn(f, generator=g) * 0.1).cuda())
        cin = f
    for fold in (False, True):
        ops = cuda_mlp.prepare_operands(fold, xyz, feats, xyz[:, :10], ws, bs)
        got = cuda_mlp._launch(fold, *ops[:1], xyz, *ops[1:], idx)
        ref = cuda_mlp.fused_group_plain(fold, *ops[:1], xyz, *ops[1:], idx)
        e, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        if e > MLP_REL_TOL * scale:
            raise AssertionError(f"fused mlp ragged case fold={fold}: max err {e} vs scale {scale}")
        log(f"fused mlp ragged B=2 N=100 S=10 K=8 (24, 40, 36, 20) fold={fold}: max err {e:.3e}")
    return tally


# (name, B, N, C, S, K, widths, mode): K7 at the rcnn training stage's SA
# stages at batch 4 (64 rois a frame); then the shapes its tiles branch on:
# a smaller three-layer K=32 shape, four layers with widths off the 16-grid
# (padded to (32, 48, 48, 32)) at K=8 (padded to 16), a K=16 shape, and the
# widest stack its shared memory takes (SA2's widths; here in fold mode)
MLP_BWD_SHAPES = (
    ("RCNN SA1", 4 * 64, 512, 128, 128, 64, (128, 128, 128), "fold"),
    ("RCNN SA2", 4 * 64, 128, 128, 32, 64, (128, 128, 256), "hilo"),
    ("small", 8, 256, 32, 64, 32, (32, 48, 64), "fold"),
    ("small", 8, 256, 32, 64, 32, (32, 48, 64), "hilo"),
    ("ragged 4-layer", 8, 256, 20, 64, 8, (24, 40, 36, 20), "hilo"),
    ("ragged 4-layer", 8, 256, 20, 64, 8, (24, 40, 36, 20), "fold"),
    ("K=16", 8, 256, 32, 64, 16, (64, 64, 128), "hilo"),
    ("widest", 16, 256, 128, 64, 32, (128, 128, 256), "fold"),
)
# the shapes of the rcnn stage's main path (the tally's)
MLP_BWD_MAIN = ("RCNN SA1", "RCNN SA2")
# K7 against its plain version on the card, each fed its own forward's
# output: the same products in another summation order (wgmma steps and f32
# partial sums against cuBLAS and index_add_), so each output is held in
# norm, ||kernel - plain|| <= MLP_BWD_REL_TOL ||plain||.  A maximum within an
# f32 ulp of its runner-up can go to the other neighbour (a few dozen of the
# 4.2M maxima over 64 neighbours at RCNN SA1, each moving a whole cotangent:
# measured 9.5e-4 of the norm there, 1.3e-6 at the small shape), and a ReLU
# input within an ulp of 0 can flip its mask, which a max-abs bound would
# not forgive
MLP_BWD_REL_TOL = 5e-3


def _mlp_bwd_case(B, N, C, S, K, widths, fold, seed):
    from pointrcnn_tpu_torch.models.layers import xavier_normal
    from pointrcnn_tpu_torch.ops import cuda_mlp

    g = torch.Generator().manual_seed(seed)
    xyz = _roi_cloud(B, N, seed)
    feats = torch.relu(torch.randn((B, N, C), generator=g)).cuda()
    new_xyz = xyz[:, :S].contiguous()
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]  # the ball query's backfill
    idx = idx.cuda()
    ws, bs, cin = [], [], 3 + C
    for f in widths:
        ws.append(xavier_normal(cin, f, g).cuda())
        bs.append((torch.randn(f, generator=g) * 0.1).cuda())
        cin = f
    ops = cuda_mlp.prepare_operands(fold, xyz, feats, new_xyz, ws, bs)
    table, cent, w0x, lws, lbs = ops
    ct = torch.randn((B, S, lws[-1].shape[1]), generator=g).cuda()
    return xyz, idx, table, cent, w0x, lws, lbs, ct


def _named(res):
    """K7's (dtable, dxyz, dcent, dw0x, dws, dbs) -> [(name, tensor)], the
    absent ones of fold mode left out."""
    dtable, dxyz, dcent, dw0x, dws, dbs = res
    out = [("dtable", dtable), ("dxyz", dxyz), ("dcent", dcent), ("dw0x", dw0x)]
    out += [(f"dw{j + 1}", d) for j, d in enumerate(dws)] + [(f"db{j}", d) for j, d in enumerate(dbs)]
    return [(n, t) for n, t in out if t is not None]


def check_mlp_bwd():
    """K7 at the rcnn stage's shapes: two launches bit-equal (every sum in a
    fixed order), no dropped tie (the no-match count stays 0), each output
    within MLP_BWD_REL_TOL of the plain version in norm."""
    from pointrcnn_tpu_torch.ops import cuda_mlp

    tally = Tally()
    cuda_mlp.reset_nomatch()
    for name, B, N, C, S, K, widths, mode in MLP_BWD_SHAPES:
        fold = mode == "fold"
        xyz, idx, table, cent, w0x, ws, bs, ct = _mlp_bwd_case(B, N, C, S, K, widths, fold,
                                                               N + K + len(name))
        idx_p = cuda_mlp.pad_idx(idx, N)
        out = cuda_mlp._launch(fold, table, xyz, cent, w0x, ws, bs, idx_p, checked=True)
        bwd = lambda: cuda_mlp._launch_bwd(fold, table, xyz, cent, w0x, ws, bs, idx_p, K, out, ct)
        got, again = bwd(), bwd()
        if not all(torch.equal(a, b) for (_, a), (_, b) in zip(_named(got), _named(again))):
            raise AssertionError(f"mlp backward {name} {mode}: two launches differ")
        torch.cuda.synchronize()
        nomatch = cuda_mlp.nomatch_count()
        if nomatch:
            raise AssertionError(f"mlp backward {name} {mode}: {nomatch} maxima found no match")
        plain_out = cuda_mlp.fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
        ref = cuda_mlp.fused_group_backward_plain(fold, table, xyz, cent, w0x, ws, bs, idx,
                                                  plain_out, ct)
        worst = err = 0.0
        for (what, a), (_, b) in zip(_named(got), _named(ref)):
            rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            worst, err = max(worst, rel), max(err, (a - b).abs().max().item())
            if not (torch.isfinite(a).all() and rel <= MLP_BWD_REL_TOL):
                raise AssertionError(f"mlp backward {name} {mode}: {what} off the plain version "
                                     f"by {rel:.3e} of its norm")
        k = cuda_ms(bwd, 5)
        p = cuda_ms(lambda: cuda_mlp.fused_group_backward_plain(
            fold, table, xyz, cent, w0x, ws, bs, idx, plain_out, ct), 1)
        del ref, plain_out
        # bf16 products: the forward's layers 1.. recomputed, then per layer
        # j >= 1 the dW and dz products; layer 0's geometry lanes are few
        macs = 3 * sum(a * b for a, b in zip(widths, widths[1:]))
        ops_n = 2.0 * B * S * K * macs
        nb = nbytes(table, None if fold else xyz, cent, w0x, *ws, *bs, idx, out, ct,
                    *(t for _, t in _named(got)))
        tag = ""
        if name in MLP_BWD_MAIN:
            bound = tally.add(k, p, nb, ops_n, PEAK_BF16_PER_MS)
            tally.err = max(tally.err, err)
            tag = " (rcnn stage)"
        else:
            bound = max(nb / PEAK_BYTES_PER_MS, ops_n / PEAK_BF16_PER_MS)
        log(f"mlp backward {name}{tag} B={B} N={N} C={C} S={S} K={K} {widths} {mode}: "
            f"deterministic, no dropped tie, worst {worst:.3e} of the plain version's norm "
            f"(tol {MLP_BWD_REL_TOL}), max abs err {err:.3e}; kernel {k:.4f} ms, plain {p:.4f} ms, "
            f"bound {bound:.4f} ms; {_rate(ops_n, k, bound)}")
    return tally


def _bq_ops(cand: float, S_total: int, W: int) -> float:
    """Per candidate: 3 sub, 3 mul, 2 add and a compare; per centroid the
    fold's W - 128 compares.  Ordering the kmax smallest of the 128 folded
    lanes needs far fewer than the scan and is not counted."""
    return 9.0 * cand + S_total * (W - 128)


def _bq_equal(what, got, ref):
    for name, a, b in zip(("dist2", "idx", "rel"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs in {(a != b).sum().item()} places")


def check_ballquery():
    """K5 and K6 against their plain versions at the forward's shapes:
    the banded RPN SA1 stage, the full scan of RPN SA2, the full scan on
    the sorted SA1 table (the banded stage's fallback), and a ragged pool
    (N=2176: W halves to 128, no fold)."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq
    from pointrcnn_tpu_torch.ops.common import gather_points
    from pointrcnn_tpu_torch.ops.sampling import _banded_fps, _zsort, furthest_point_sample

    k5, k6 = Tally(), Tally()
    kmax = 32

    # RPN SA1: 16 bands of 1024 points, 4096 band-ordered centroids
    xs, _ = _zsort(_rpn_cloud(BATCH, 16384, 21))
    n_bands, S = 16, 4096
    cent = gather_points(xs, _banded_fps(xs, S, n_bands)).contiguous()
    got = bq._launch_banded(xs, cent, kmax, n_bands)
    _bq_equal("banded 4x16384 S=4096", got, bq.ball_query_banded_plain(xs, cent, kmax, n_bands))
    k = cuda_ms(lambda: bq._launch_banded(xs, cent, kmax, n_bands), 10)
    p = cuda_ms(lambda: bq.ball_query_banded_plain(xs, cent, kmax, n_bands), 2)
    Ns, cpb = 16384 // n_bands, S // n_bands
    cand = BATCH * cpb * Ns * sum(3 - (b == 0) - (b == n_bands - 1) for b in range(n_bands))
    bound = k6.add(k, p, nbytes(xs, cent, *got), _bq_ops(cand, BATCH * S, bq.pick_w(Ns)),
                   PEAK_F32_PER_MS)
    log(f"ball_query_banded B={BATCH} N=16384 bands={n_bands} S={S} k={kmax} rel: exact match; "
        f"kernel {k:.4f} ms, plain {p:.4f} ms, bound {bound:.4f} ms")

    # RPN SA2: 4096 points (SA1's centroids), 1024 centroids, no rel
    x2 = _rpn_cloud(BATCH, 4096, 22)
    c2 = gather_points(x2, furthest_point_sample(x2, 1024, method="blockwise")).contiguous()
    # the fallback: the full scan on SA1's sorted table, with rel
    shapes = (("SA2", x2, c2, kmax, False, True),
              ("SA1 fallback (sorted table)", xs, cent, kmax, True, False),
              ("ragged", _rpn_cloud(2, 2176, 23), _rpn_cloud(2, 256, 24), 16, True, False))
    for what, x, c, kk, rel, main in shapes:
        got = bq._launch(x, c, kk, emit_rel=rel)
        _bq_equal(f"full scan {what}", got, bq.ball_query_plain(x, c, kk, emit_rel=rel))
        k = cuda_ms(lambda: bq._launch(x, c, kk, emit_rel=rel), 10)
        p = cuda_ms(lambda: bq.ball_query_plain(x, c, kk, emit_rel=rel), 2)
        B, N = x.shape[:2]
        nb, ops = nbytes(x, c, *got), _bq_ops(B * c.shape[1] * N, B * c.shape[1], bq.pick_w(N))
        bound = k5.add(k, p, nb, ops, PEAK_F32_PER_MS) if main else \
            max(nb / PEAK_BYTES_PER_MS, ops / PEAK_F32_PER_MS)
        log(f"ball_query {what} B={B} N={N} S={c.shape[1]} k={kk}{' rel' if rel else ''}: "
            f"exact match; kernel {k:.4f} ms, plain {p:.4f} ms, bound {bound:.4f} ms")
    return k5, k6


def _check_outputs(out, M, tag):
    shapes = {k: tuple(out[k].shape) for k in ("rois", "rcnn_cls", "rcnn_reg")}
    B = out["rois"].shape[0]
    if shapes["rois"] != (B, M, 7) or shapes["rcnn_cls"] != (B * M, 1) \
            or shapes["rcnn_reg"][0] != B * M:
        raise AssertionError(f"{tag}: bad output shapes {shapes}")
    for k in ("rpn_cls", "rpn_reg", "rois", "rcnn_cls", "rcnn_reg"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{tag}: non-finite {k}")
    log(f"{tag}: shapes {shapes}, finite, {int(out['roi_valid'].sum())} valid rois")


def _frames_per_s(fwd, model, pts, tag):
    batch = {"pts_input": pts}
    fwd(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        fwd(model, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"{tag} forward batch {pts.shape[0]}: {pts.shape[0] * TIMED_ITERS / dt:.3f} frames/s "
        f"({1000 * dt / TIMED_ITERS:.3f} ms per batch, {TIMED_ITERS} iterations after 1 warm-up)")


def thin_band_cloud(batch: int, n: int, seed: int) -> np.ndarray:
    """A uniform cloud with half its points in a 0.3 m z-slab: the depth
    bands over the slab are thinner than RPN SA1's largest radius (0.5 m),
    so the banded stage must take the full-scan kernel."""
    from pointrcnn_tpu_torch.entry import synthetic_cloud

    pts = synthetic_cloud(batch, n, seed)
    rng = np.random.RandomState(seed + 100)
    pts[:, : n // 2, 2] = rng.uniform(30.0, 30.3, (batch, n // 2))
    return pts


def phase_default(launches):
    """The main path: the eval forward of cfgs/default.yaml."""
    from pointrcnn_tpu_torch.entry import entry, synthetic_cloud

    fwd, (model, _) = entry(batch=BATCH, device="cuda", seed=0)
    cfg = model.cfg
    clouds = [torch.from_numpy(synthetic_cloud(BATCH, cfg.RPN.NUM_POINTS, s)).cuda()
              for s in CLOUD_SEEDS]
    reset_counts()
    outs = [fwd(model, {"pts_input": pts}) for pts in clouds]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"default forward x{len(clouds)} launches: {counts}")
    for s, out in zip(CLOUD_SEEDS, outs):
        _check_outputs(out, cfg.TEST.RPN_POST_NMS_TOP_N, f"default, cloud {s}")
    for name in EVAL_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the default path")
    if counts["gather_backward"]:
        raise AssertionError("the eval forward launched the gather backward")
    launches.update(counts)

    thin = torch.from_numpy(thin_band_cloud(BATCH, cfg.RPN.NUM_POINTS, 9)).cuda()
    reset_counts()
    out = fwd(model, {"pts_input": thin})
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"thin-band cloud launches: {counts}")
    _check_outputs(out, cfg.TEST.RPN_POST_NMS_TOP_N, "default, thin-band cloud")
    # RPN SA1 falls back to the full scan (and SA2 takes it as always)
    if counts["ball_query_banded"] != 0 or counts["ball_query"] != 2:
        raise AssertionError(f"the thin-band cloud did not take the full-scan fallback: {counts}")
    log("thin-band cloud: RPN SA1 took the full-scan fallback")

    check_against_cpu(model, synthetic_cloud(1, cfg.RPN.NUM_POINTS, 5), "default")
    _frames_per_s(fwd, model, clouds[0], "default")


def phase_exact():
    """The exact-method setting (entry.EXACT_OVERRIDES), on one cloud."""
    from pointrcnn_tpu_torch.entry import entry, slice_config, synthetic_cloud

    fwd, (model, batch) = entry(batch=BATCH, device="cuda", seed=0, cfg=slice_config())
    reset_counts()
    out = fwd(model, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"exact forward launches: {counts}")
    _check_outputs(out, model.cfg.TEST.RPN_POST_NMS_TOP_N, "exact, cloud 0")
    for name in ("fps", "three_nn", "group_gather", "fused_group_mlp_max"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the exact path")
    check_against_cpu(model, synthetic_cloud(1, model.cfg.RPN.NUM_POINTS, 5), "exact")
    _frames_per_s(fwd, model, batch["pts_input"], "exact")


def check_against_cpu(model, cloud, tag):
    """Batch-1 forward on the card against the port's plain path on the CPU
    (the path the CPU tests hold against JAX), same weights and cloud."""
    import copy

    from pointrcnn_tpu_torch.entry import forward

    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    ref = forward(cpu_model, {"pts_input": torch.from_numpy(cloud)})
    log(f"{tag}: cpu reference forward: {time.perf_counter() - t0:.1f} s")
    got = {k: v.cpu() for k, v in forward(model, {"pts_input": torch.from_numpy(cloud).cuda()}).items()}
    if not torch.equal(got["backbone_xyz"], ref["backbone_xyz"]):
        raise AssertionError(f"{tag}: backbone_xyz differs from the CPU reference")
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        e = (got[k] - ref[k]).abs().max().item()
        scale = ref[k].abs().max().item()
        log(f"{tag} vs cpu {k}: max err {e:.3e} (scale {scale:.3e})")
        if e > 0.05 * scale:
            raise AssertionError(f"{tag}: {k} differs from the CPU reference by {e} (scale {scale})")
    same = (got["rois"] - ref["rois"]).abs().amax(-1) < 1e-3
    frac = same.float().mean().item()
    log(f"{tag} vs cpu rois: {frac:.3f} of rois agree within 1e-3")
    if frac < 0.9:
        raise AssertionError(f"{tag}: only {frac:.3f} of rois agree with the CPU reference")
    sel = same.reshape(-1)
    for k in ("rcnn_cls", "rcnn_reg"):
        e = (got[k][sel] - ref[k][sel]).abs().max().item()
        scale = ref[k][sel].abs().max().item()
        log(f"{tag} vs cpu {k} on agreeing rois: max err {e:.3e} (scale {scale:.3e})")
        if e > 0.05 * scale + 1e-6:
            raise AssertionError(f"{tag}: {k} differs from the CPU reference by {e} (scale {scale})")


def _train_against_cpu():
    """A batch-2 train step's loss, gradient norm and gradients on the card
    against the port's CPU path, same weights and scene, dropout off."""
    from pointrcnn_tpu_torch.entry import rpn_config, train_entry
    from pointrcnn_tpu_torch.train.state import loss_and_grads

    cfg = rpn_config(["RPN.DP_RATIO", "0.0"])
    _, (state, batch) = train_entry(batch=2, device="cuda", seed=3, cfg=cfg)
    cpu_model = copy.deepcopy(state.model).cpu()
    t0 = time.perf_counter()
    cl, _, cg = loss_and_grads(cpu_model, cfg, {k: v.cpu() for k, v in batch.items()})
    log(f"train step vs cpu: cpu reference step {time.perf_counter() - t0:.1f} s")
    gl, _, gg = loss_and_grads(state.model, cfg, batch)
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())))
    card_norm = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in gg.values())))
    e_loss = abs(gl.item() / cl.item() - 1)
    e_norm = abs(card_norm / gnorm - 1)
    share = max(float((gg[k].cpu() - g).norm()) / gnorm for k, g in cg.items())
    log(f"train step vs cpu (batch 2, dropout off): loss {gl.item():.6f} vs {cl.item():.6f} "
        f"(rel {e_loss:.2e}, tol {TRAIN_LOSS_RTOL}), grad norm {card_norm:.6f} vs {gnorm:.6f} "
        f"(rel {e_norm:.2e}, tol {TRAIN_GNORM_RTOL}), worst gradient leaf {share:.2e} of the "
        f"global norm (tol {TRAIN_LEAF_SHARE})")
    if e_loss > TRAIN_LOSS_RTOL or e_norm > TRAIN_GNORM_RTOL or share > TRAIN_LEAF_SHARE:
        raise AssertionError("the card's train step differs from the CPU path")


def phase_train(train_launches):
    """The rpn training stage at batch 16 x 16384 points."""
    from pointrcnn_tpu_torch.entry import train_entry
    from pointrcnn_tpu_torch.train import checkpoint

    step, (state, batch) = train_entry(batch=TRAIN_BATCH, device="cuda", seed=0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"train batch {TRAIN_BATCH} x {batch['pts_input'].shape[1]} points: {1000 * dt:.3f} ms/step, "
        f"{TRAIN_BATCH / dt:.3f} frames/s ({TRAIN_TIMED} steps after {TRAIN_WARMUP} warm-up), "
        f"peak memory {peak / 2 ** 30:.3f} GiB")
    loss, gnorm = tb["loss"].item(), tb["grad_norm"].item()
    log(f"train launches over {TRAIN_TIMED} steps: {counts}; loss {loss:.6f}, grad norm "
        f"{gnorm:.6f}, foreground points {int(tb['rpn_fg_sum'])}")
    if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"train step: loss {loss}, grad norm {gnorm}")
    for name in ("group_gather", "gather_backward"):
        if counts[name] != 6 * TRAIN_TIMED:
            raise AssertionError(f"train step: {name} launched {counts[name]} times in "
                                 f"{TRAIN_TIMED} steps, not 6 a step")
    for name in TRAIN_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the train path")
    train_launches.update(counts)
    after = state.model.state_dict()
    params = dict(state.model.named_parameters())
    moved = [k for k in params if not torch.equal(after[k], before[k])]
    stats = [k for k, _ in state.model.named_buffers() if not torch.equal(after[k], before[k])]
    if len(moved) != len(params) or not stats:
        raise AssertionError(f"train step: {len(params) - len(moved)} parameters unchanged, "
                             f"{len(stats)} BN statistics changed")
    log(f"train step: all {len(params)} parameters and {len(stats)} BN statistics updated")

    _train_against_cpu()

    # checkpoint save -> load into a fresh state -> the next step's loss;
    # the checkpoint is the rcnn stage's RPN
    ckpt_dir = os.path.join(REPO, "pointrcnn_tpu_torch", "_build", "smoke_ckpt")
    path = checkpoint.save_checkpoint(ckpt_dir, state, epoch=1, it=state.step)
    state, tb = step(state, batch)
    del state
    _, (fresh, _) = train_entry(batch=TRAIN_BATCH, device="cuda", seed=1)
    fresh, epoch, it = checkpoint.load_checkpoint(path, fresh)
    fresh, tb2 = step(fresh, batch)
    if not torch.equal(tb["loss"], tb2["loss"]):
        raise AssertionError(f"resumed step loss {tb2['loss'].item()} != {tb['loss'].item()}")
    log(f"checkpoint resume (epoch {epoch}, it {it}): next-step loss bit-equal "
        f"({tb2['loss'].item():.6f})")
    return path


def _rcnn_against_cpu(rpn_ckpt):
    """A batch-1 rcnn step on the card against the port's CPU path: the
    same weights, the same target draws, and the card's RPN outputs handed
    to the CPU model (the RPN is fixed, and its eval forward is held to the
    CPU path in phase_default)."""
    from pointrcnn_tpu_torch.entry import train_entry
    from pointrcnn_tpu_torch.models.target import target_draws
    from pointrcnn_tpu_torch.train.state import loss_and_grads

    _, (state, batch) = train_entry(batch=1, device="cuda", seed=5, stage="rcnn", rpn_ckpt=rpn_ckpt)
    model, cfg = state.model, state.model.cfg
    cpu_model = copy.deepcopy(model).cpu()
    seen = {}
    model.register_forward_hook(lambda m, a, o: seen.update(card=o))
    cpu_model.register_forward_hook(lambda m, a, o: seen.update(cpu=o))
    with torch.no_grad():
        rpn_out = model.rpn(batch["pts_input"])
    model.rpn.forward = lambda pts, generator=None: dict(rpn_out)
    cpu_model.rpn.forward = lambda pts, generator=None: {k: v.cpu() for k, v in rpn_out.items()}
    draws = target_draws(cfg, torch.Generator(device="cuda").manual_seed(11), 1,
                         cfg.TRAIN.RPN_POST_NMS_TOP_N, device="cuda")
    gl, gtb, gg = loss_and_grads(model, cfg, batch, targets=draws)
    t0 = time.perf_counter()
    cl, _, cg = loss_and_grads(cpu_model, cfg, {k: v.cpu() for k, v in batch.items()},
                               targets={k: v.cpu() for k, v in draws.items()})
    log(f"rcnn step vs cpu: cpu reference step {time.perf_counter() - t0:.1f} s")
    for k in ("cls_label", "reg_valid_mask"):
        if not torch.equal(seen["card"][k].cpu(), seen["cpu"][k]):
            raise AssertionError(f"rcnn step vs cpu: the target layer's {k} differs")
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())))
    card_norm = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in gg.values())))
    e_loss, e_norm = abs(gl.item() / cl.item() - 1), abs(card_norm / gnorm - 1)
    share = max(float((gg[k].cpu() - g).norm()) / gnorm for k, g in cg.items()
                if k.startswith("rcnn_net."))
    log(f"rcnn step vs cpu (batch 1, {int(gtb['rcnn_cls_fg'])} fg / {int(gtb['rcnn_cls_bg'])} bg "
        f"rois, same decisions): loss {gl.item():.6f} vs {cl.item():.6f} (rel {e_loss:.2e}, tol "
        f"{RCNN_LOSS_RTOL}), grad norm {card_norm:.6f} vs {gnorm:.6f} (rel {e_norm:.2e}, tol "
        f"{RCNN_GNORM_RTOL}), worst RCNN gradient leaf {share:.2e} of the global norm "
        f"(tol {RCNN_LEAF_SHARE})")
    if e_loss > RCNN_LOSS_RTOL or e_norm > RCNN_GNORM_RTOL or share > RCNN_LEAF_SHARE:
        raise AssertionError("the card's rcnn step differs from the CPU path")


def phase_rcnn_train(rcnn_launches, rpn_ckpt):
    """The rcnn training stage at batch 4 x 16384 points, the RPN from the
    rpn stage's checkpoint."""
    from pointrcnn_tpu_torch.entry import KITTI_TRAIN_FRAMES, TRAIN_EPOCHS, train_entry
    from pointrcnn_tpu_torch.models import layers
    from pointrcnn_tpu_torch.ops import cuda_mlp
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer, steps_for

    step, (state, batch) = train_entry(device="cuda", seed=0, stage="rcnn", rpn_ckpt=rpn_ckpt)
    model = state.model
    if batch["pts_input"].shape[0] != RCNN_BATCH:
        raise AssertionError(f"rcnn stage batch {batch['pts_input'].shape[0]}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rpn_params = {k: v for k, v in model.named_parameters() if k.startswith("rpn.")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers.generic_grouped_train = 0
    cuda_mlp.reset_nomatch()
    for _ in range(TRAIN_WARMUP):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"rcnn train batch {RCNN_BATCH} x {batch['pts_input'].shape[1]} points: "
        f"{1000 * dt:.3f} ms/step, {RCNN_BATCH / dt:.3f} frames/s ({TRAIN_TIMED} steps after "
        f"{TRAIN_WARMUP} warm-up), peak memory {peak / 2 ** 30:.3f} GiB")
    loss, gnorm = tb["loss"].item(), tb["grad_norm"].item()
    log(f"rcnn train launches over {TRAIN_TIMED} steps: {counts}; loss {loss:.6f}, grad norm "
        f"{gnorm:.6f}, rcnn_cls_fg {int(tb['rcnn_cls_fg'])}, rcnn_cls_bg {int(tb['rcnn_cls_bg'])}, "
        f"rcnn_reg_fg {int(tb['rcnn_reg_fg'])}")
    if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"rcnn train step: loss {loss}, grad norm {gnorm}")
    for name, n in RCNN_STEP_LAUNCHES.items():
        if counts[name] != n * TRAIN_TIMED:
            raise AssertionError(f"rcnn train step: {name} launched {counts[name]} times in "
                                 f"{TRAIN_TIMED} steps, not {n} a step")
    for name in RCNN_TRAIN_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the rcnn train path")
    if layers.generic_grouped_train or cuda_mlp.nomatch_count():
        raise AssertionError(f"rcnn train step: {layers.generic_grouped_train} SA stacks off the "
                             f"fused route, {cuda_mlp.nomatch_count()} dropped maxima")
    rcnn_launches.update(counts)

    after = model.state_dict()
    rcnn = [k for k, _ in model.named_parameters() if k.startswith("rcnn_net.")]
    still = [k for k in rcnn if torch.equal(after[k], before[k])]
    if still:
        raise AssertionError(f"rcnn train step: RCNN parameters unchanged: {still}")
    # the fixed RPN: zero gradients, so Adam's update is 0 and each step
    # applies the weight decay alone, p <- p - lr * (wd * p), in the
    # optimizer's f32 arithmetic; its BN statistics do not move
    opt = build_optimizer(model.cfg, *steps_for(KITTI_TRAIN_FRAMES, RCNN_BATCH, TRAIN_EPOCHS))
    for k in rpn_params:
        p = before[k].clone()
        for count in range(TRAIN_WARMUP + TRAIN_TIMED):
            u = 0.0 + opt.weight_decay * p
            p = p + (-opt.lr(count) * u)
        if not torch.equal(after[k], p):
            raise AssertionError(f"rcnn train step: RPN parameter {k} moved by "
                                 f"{(after[k] - before[k]).abs().max().item()}, not by the "
                                 f"weight decay alone")
    moved_stats = [k for k, _ in model.named_buffers() if not torch.equal(after[k], before[k])]
    if moved_stats:
        raise AssertionError(f"rcnn train step: RPN BN statistics moved: {moved_stats[:3]}")
    log(f"rcnn train step: all {len(rcnn)} RCNN parameters updated; all {len(rpn_params)} RPN "
        f"parameters moved by the weight decay alone (bit-equal), BN statistics unchanged")
    del state, step, batch, model
    _rcnn_against_cpu(rpn_ckpt)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    tallies = {"fps": check_fps(), "three_nn": check_knn(), "group_gather": check_gather(),
               "fused_group_mlp_max": check_mlp(), "gather_backward": check_gather_bwd(),
               "fused_group_mlp_backward": check_mlp_bwd()}
    tallies["ball_query"], tallies["ball_query_banded"] = check_ballquery()
    launches, train_launches, rcnn_launches = {}, {}, {}
    phase_default(launches)
    phase_exact()
    ckpt = phase_train(train_launches)
    try:
        phase_rcnn_train(rcnn_launches, ckpt)
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    # launches: the count of the eval forward's run, or for a kernel that
    # only a training stage runs, of that stage's run (the rpn stage's for
    # the gather backward, the rcnn stage's for the MLP backward);
    # train_launches and rcnn_train_launches: each training run's
    rows = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name] if name in EVAL_KERNELS else
             (train_launches[name] if name in TRAIN_KERNELS else rcnn_launches[name]),
             "train_launches": train_launches[name], "rcnn_train_launches": rcnn_launches[name],
             **tallies[name].row()}
            for name, source, replaces, _, _ in KERNELS]
    log(f"{card}; chip_smoke {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
