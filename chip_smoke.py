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
   shapes the forward gives it, time both, and compute its bound; FPS (K1)
   and 3-NN (K3) also at the rpn step's batch-16 shapes (and K1 at the rcnn
   step's and the exact setting's rows), each shape under every launch plan
   the kernel takes, each plan's device ms (CUDA-graph replay) and the
   wrapper's (``ms``, CUDA events, as for every kernel) in the kernel
   line, K1's bound with the latency term of its dependent steps (the
   probe ``fps_step_probe``: one warp's shortest step); then K1 and K3
   on adversarial inputs (duplicated points, one repeated point, npoint ==
   N, ragged and tiny rows; lattice knowns with many equal distances,
   duplicated knowns, m = 3, m off the tile) under every launch plan the
   kernel takes, each equal to the plain version; the neighbourhood gather
   (K4) at every path shape with f32 and bf16 features, device-timed by
   CUDA-graph replay through its wrapper, then on layouts against its runs
   of output rows (runs ending mid-centroid, a ragged last run, rows that
   are not 16-byte multiples, one batch row, an unaligned table), captured
   in a CUDA graph through its wrapper (no host sync), and an index equal
   to N in a child process, which must trap with the kernel's message; the
   ball query (K5 full scan, K6 banded) at every shape of ``BQ_SHAPES``
   (the eval forward's RPN SA1 and SA2, the rpn step's at batch 16,
   car_2x.yaml's, K6's full-row branch with its thin-band flag false, a
   ragged pool) under every launch plan the kernels take, bit for bit
   equal to the plain version, each plan timed on the device (CUDA-graph
   replay) and the wrapper's choice through it; then on adversarial tables
   (duplicated points, a lattice, NaN coordinates in a centroid's classes,
   a NaN centroid, distances that overflow to inf, ragged blocks, bands one
   W wide and bands whose full-row branch folds from another W, each
   banded one with its flag true and false), and the banded stage
   (``fps_group_banded``) captured in a CUDA graph and replayed on a cloud
   whose flag reads false;
3b. the SA stages of every shipped config (``cfgs/default.yaml``,
   ``people.yaml``, ``car_2x.yaml``) that the port routes to the fused MLP
   kernels: each launches K2 (and, in the BN-free RCNN stacks' training
   direction, K7) once at its real widths, K and batch, and a refusal fails
   (ROADMAP C12);
4. drive the main path (``pointrcnn_tpu_torch.entry``: the two-stage eval
   forward of ``cfgs/default.yaml`` as it stands) at batch 4 x 16384 points
   on seeded clouds, check shapes, finiteness and that every kernel
   launched (and that K4 got the features' dtype it is timed in, as in
   phase 7, and that the banded stage's thin-band flag read true); run a
   cloud with a dense z-cluster whose flag must read false on the device,
   RPN SA1 then equal to the full scan of its sorted table; hold a batch-1
   forward against the port's plain path on the CPU; time frames/s;
5. the same for the exact-method setting (``entry.EXACT_OVERRIDES``) on
   one cloud;
6. the gather backward (K8) against its plain version at the ``rpn``
   training stage's shapes (RPN SA2-SA4, K = 16 and 32, batch 16):
   deterministic, equal to the plain version on the CPU, within the f32
   reorder bound of the plain version on the card, device-timed by
   CUDA-graph replay beside ``index_add_``; then on index patterns against
   its buckets and chunks (every position on one row, empty rows,
   descending indices, the ball query's backfill, runs of one row across
   chunks, a ragged S*K, 1024 channels), each deterministic and equal to
   the CPU plain version;
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
4b. (after 5) the KITTI eval CLI (``python -m pointrcnn_tpu_torch.eval``,
   its ``main()`` in-process on the card): a KITTI tree written here (64
   frames of 2-4 cars, 20000 points each inside the image frustum, a PNG
   written with zlib), a checkpoint of seeded random weights of
   ``cfgs/default.yaml`` with the RCNN; ``--eval_mode rcnn`` at batch 4,
   16 batches (K1-K6 launched 16 times the default forward's counts; a
   result file for every frame; recall and the official AP finite;
   candidates for the final NMS in some frame; the pipeline's frames/s
   over the cycles of batches 2-15 and their spread, the post-process's
   device span by CUDA events, beside the forward's ms), ``--eval_mode
   rpn``, whether the native host-op library loaded, and one batch's
   post-process on the card against the CPU from the same network
   outputs (the same NMS survivors in order, boxes and written lines
   within their tolerances) and its final NMS, one batched call against a
   call a frame (the same survivors; both timed).

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
# outside the tensor cores and bf16 tensor-core operations/ms.  The f32
# rate is one operation a lane a clock (132 SMs x 128 lanes x 1.98 GHz),
# half the published 67 TFLOP/s, which counts an FMA as two: every source
# is built with --fmad=false, so no two counted operations fuse
PEAK_BYTES_PER_MS = 3.35e12 / 1e3
PEAK_F32_PER_MS = 33.5e12 / 1e3
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


def graph_ms(fn, reps: int) -> float:
    """Device ms a call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's cost of a launch (which paces a short kernel
    that :func:`cuda_ms` times through its wrapper) stays out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rate(ops: float, ms: float, bound_ms: float) -> str:
    """A bf16 kernel's achieved rate and its time's share of the bound."""
    return f"{ops / ms / 1e9:.1f} TFLOP/s, bound / kernel {bound_ms / ms:.3f}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, ops, peak_per_ms, latency_ms=0.0):
    """(bound ms, the term that sets it): the largest of bytes over the
    memory rate, operations over the peak rate of their type and, for a
    chain of dependent steps, the chain's latency."""
    terms = {"bytes": n_bytes / PEAK_BYTES_PER_MS, "operations": ops / peak_per_ms,
             "latency": latency_ms}
    term = max(terms, key=terms.get)
    return terms[term], term


class Tally:
    """One kernel's sums over the main path's shapes: kernel and plain ms
    (CUDA events through the wrappers), the kernel's device ms where it is
    also timed by CUDA-graph replay, and the bound (:func:`bound`, per
    shape).  A latency term counts as operations in ``bound_by`` (a chain
    of dependent operations); the per-shape rows name it."""

    def __init__(self):
        self.err = self.ms = self.plain_ms = self.bound_ms = 0.0
        self.device_ms = None
        self.by = {"bytes": 0.0, "operations": 0.0}
        # the time of one PyTorch call computing the same function, where one exists
        self.library_ms = None
        # per-shape rows and other figures the kernel line lists beside the sums
        self.shapes, self.notes = [], {}

    def add(self, ms, plain_ms, n_bytes, ops, peak_per_ms, latency_ms=0.0, device_ms=None):
        b, term = bound(n_bytes, ops, peak_per_ms, latency_ms)
        self.ms, self.plain_ms = self.ms + ms, self.plain_ms + plain_ms
        if device_ms is not None:
            self.device_ms = (self.device_ms or 0.0) + device_ms
        self.bound_ms += b
        self.by["bytes" if term == "bytes" else "operations"] += b
        return b

    def row(self):
        return {"max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": max(self.by, key=self.by.get),
                "library_ms": self.library_ms,
                **({"device_ms": self.device_ms} if self.device_ms is not None else {}),
                **({"shapes": self.shapes} if self.shapes else {}), **self.notes}


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


# (name, rows, N, npoint, cloud, path): K1's rows on each path.  The eval
# forward (the main path, the tally's): RPN SA1 in 16 depth bands, SA2 in
# 4, SA3, SA4, RCNN SA1 and SA2 over 400 rois; the rpn step at batch 16;
# the rcnn step's RCNN stages over 4 x 64 rois (its RPN rows are the eval
# forward's); the exact setting's RPN SA1 and SA2 (a block a row)
FPS_SHAPES = (
    ("RPN SA1", 64, 1024, 256, "rpn", "eval"),
    ("RPN SA2", 16, 1024, 256, "rpn", "eval"),
    ("RPN SA3", 4, 1024, 256, "rpn", "eval"),
    ("RPN SA4", 4, 256, 64, "rpn", "eval"),
    ("RCNN SA1", 400, 512, 128, "roi", "eval"),
    ("RCNN SA2", 400, 128, 32, "roi", "eval"),
    ("RPN SA1", 256, 1024, 256, "rpn", "rpn step"),
    ("RPN SA2", 64, 1024, 256, "rpn", "rpn step"),
    ("RPN SA3", 16, 1024, 256, "rpn", "rpn step"),
    ("RPN SA4", 16, 256, 64, "rpn", "rpn step"),
    ("RCNN SA1", 256, 512, 128, "roi", "rcnn step"),
    ("RCNN SA2", 256, 128, 32, "roi", "rcnn step"),
    ("RPN SA1", 4, 16384, 4096, "rpn", "exact"),
    ("RPN SA2", 4, 4096, 1024, "rpn", "exact"),
)
# (name, B, n, m, path): K3's four FP stages at the eval forward's batch and
# the rpn step's
KNN_SHAPES = tuple((f"FP{k}", b, n, m, path)
                   for b, path in ((BATCH, "eval"), (TRAIN_BATCH, "rpn step"))
                   for k, n, m in ((4, 256, 64), (3, 1024, 256), (2, 4096, 1024),
                                   (1, 16384, 4096)))
# steps of the K1 latency probe: the difference of two chains over the
# difference of their lengths, so the launch's own cost cancels
PROBE_STEPS = (2048, 18432)


def cloud(kind, b, n, seed):
    return (_rpn_cloud if kind == "rpn" else _roi_cloud)(b, n, seed)


def fps_step_ms() -> float:
    """K1's latency term per step: the probe's time per dependent step
    (``fps_step_probe`` in csrc/fps.cu), the least of three runs."""
    from pointrcnn_tpu_torch.ops import cuda_fps

    short, long_ = PROBE_STEPS
    return min((cuda_fps.step_probe_ms(long_) - cuda_fps.step_probe_ms(short)) / (long_ - short)
               for _ in range(3))


def _plan_key(shape_plan) -> str:
    return ",".join(map(str, shape_plan))


def fps_case(rows, n, npoint, kind, t_step):
    """K1 at one shape under every plan the kernel takes, each held to the
    plain version (torch.equal) and timed on the device; the wrapper's
    own choice also timed through it -> (the shape's row, bytes,
    operations, latency ms)."""
    from pointrcnn_tpu_torch.ops import cuda_fps
    from pointrcnn_tpu_torch.ops.common import sm_count

    xyz = cloud(kind, rows, n, n)
    ref = cuda_fps.furthest_point_sample_plain(xyz, npoint)
    reps = 3 if n > 1024 else 20
    device = {}
    for shape_plan in cuda_fps.plans(n):
        run = lambda shape_plan=shape_plan: cuda_fps._launch(xyz, npoint, shape_plan)
        got = run()
        if not torch.equal(got, ref):
            raise AssertionError(f"fps {rows}x{n}->{npoint} plan {shape_plan}: "
                                 f"{(got != ref).sum().item()} picks differ")
        device[shape_plan] = graph_ms(run, reps)
    chosen = cuda_fps.plan(rows, n, sm_count(xyz.device))
    row = {"plan": list(chosen), "ms": cuda_ms(lambda: cuda_fps._launch(xyz, npoint), reps),
           "device_ms": device[chosen],
           "plans": {_plan_key(k): v for k, v in device.items()},
           "plain_ms": cuda_ms(lambda: cuda_fps.furthest_point_sample_plain(xyz, npoint), 1)}
    # per step and point: 3 sub, 3 mul, 2 add, a min and a compare
    return row, nbytes(xyz, ref), 10.0 * rows * (npoint - 1) * n, (npoint - 1) * t_step


def _fps_adversarial():
    """(name, xyz, npoint): ties the kernel must break as the
    plain version does."""
    g = torch.Generator().manual_seed(17)
    base = torch.rand((16, 256, 3), generator=g) * 40.0
    dup = base[:, torch.randint(0, 256, (1024,), generator=g)]  # each point ~4 times
    dup_long = base[:2, torch.randint(0, 256, (2048,), generator=g)]
    one = torch.full((2, 1024, 3), 3.25)
    distinct = torch.rand((8, 512, 3), generator=g) * 40.0
    return (("duplicated points", dup, 256), ("duplicated points, past the distinct ones", dup, 300),
            ("duplicated points, a block a row", dup_long, 1024), ("one repeated point", one, 64),
            ("npoint == N", distinct, 512), ("npoint == N = 1024", distinct.reshape(4, 1024, 3), 1024),
            ("N = 1000", torch.rand((3, 1000, 3), generator=g) * 40.0, 77),
            ("N = 77", distinct[:, :77], 40),
            ("N = 1500, a block a row", torch.rand((2, 1500, 3), generator=g), 300),
            ("N = 20 = npoint", distinct[:, :20], 20), ("N = 1", distinct[:3, :1], 1))


def check_fps():
    from pointrcnn_tpu_torch.ops import cuda_fps

    tally = Tally()
    t_step = fps_step_ms()
    tally.notes["t_step_ms"] = t_step
    log(f"fps latency probe: {t_step * 1e6:.1f} ns a dependent step (one warp, one point a lane; "
        f"{PROBE_STEPS[1]} - {PROBE_STEPS[0]} steps)")
    for name, rows, n, npoint, kind, path in FPS_SHAPES:
        row, nb, ops, lat = fps_case(rows, n, npoint, kind, t_step)
        if path == "eval":
            tally.add(row["ms"], row["plain_ms"], nb, ops, PEAK_F32_PER_MS, lat, row["device_ms"])
        b, term = bound(nb, ops, PEAK_F32_PER_MS, lat)
        tally.shapes.append({"path": path, "stage": name, "rows": rows, "n": n, "npoint": npoint,
                             **row, "bound_ms": b, "term": term})
        log(f"fps {path} {name} {rows}x{n}->{npoint} plan {tuple(row['plan'])}: exact match "
            f"under every plan; kernel {row['ms']:.4f} ms through its wrapper, "
            f"{row['device_ms']:.4f} device (plans {row['plans']}), plain {row['plain_ms']:.4f} ms, "
            f"bound {b:.4f} ms ({term})")
    # ties and ragged rows, under every plan the kernel takes at the row
    # length
    for name, xyz, npoint in _fps_adversarial():
        xyz = xyz.contiguous().cuda()
        ref = cuda_fps.furthest_point_sample_plain(xyz, npoint)
        plans = cuda_fps.plans(xyz.shape[1])
        for shape_plan in plans:
            got = cuda_fps._launch(xyz, npoint, shape_plan)
            if not torch.equal(got, ref):
                raise AssertionError(f"fps {name} {tuple(xyz.shape)}->{npoint} plan "
                                     f"{shape_plan}: {(got != ref).sum().item()} picks differ")
        log(f"fps {name} {tuple(xyz.shape)}->{npoint}: exact match under plans {list(plans)}")
    return tally


def knn_case(B, n, m):
    """K3 at one shape under every plan the kernel takes, indices and
    distances each held to the plain version (torch.equal) and timed on the
    device; the wrapper's own choice also timed through it -> (the shape's
    row, bytes, operations)."""
    from pointrcnn_tpu_torch.ops import cuda_knn
    from pointrcnn_tpu_torch.ops.common import sm_count

    u, kn = _rpn_cloud(B, n, n), _rpn_cloud(B, m, m + 1)
    rd, ri = cuda_knn.three_nn_plain(u, kn)
    device = {}
    for shape_plan in cuda_knn.PLANS:
        run = lambda shape_plan=shape_plan: cuda_knn._launch(u, kn, shape_plan)
        d, i = run()
        if not (torch.equal(i, ri) and torch.equal(d, rd)):
            raise AssertionError(f"three_nn B={B} {n}x{m} plan {shape_plan}: "
                                 f"{(i != ri).sum().item()} indices, {(d != rd).sum().item()} "
                                 f"distances differ")
        device[shape_plan] = graph_ms(run, 20)
    chosen = cuda_knn.plan(B, n, sm_count(u.device))
    row = {"plan": list(chosen), "ms": cuda_ms(lambda: cuda_knn._launch(u, kn), 20),
           "device_ms": device[chosen],
           "plans": {_plan_key(k): v for k, v in device.items()},
           "plain_ms": cuda_ms(lambda: cuda_knn.three_nn_plain(u, kn), 3)}
    # per pair: 3 sub, 3 mul, 2 add and a compare
    return row, nbytes(u, kn, rd, ri), 9.0 * B * n * m


def _knn_adversarial():
    """(name, unknown, known): equal distances the kernel must
    order by index as the plain version does."""
    g = torch.Generator().manual_seed(23)
    ax = torch.arange(8, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(1, 512, 3)
    lattice = lattice[:, torch.randperm(512, generator=g)].repeat(2, 1, 1)
    on_lattice = torch.randint(0, 16, (2, 700, 3), generator=g).float() * 0.5  # on points, edges, centres
    dup = torch.rand((2, 1500, 3), generator=g) * 20.0
    dup[:, 1000:1400] = dup[:, 37:437]  # duplicates 963 indices apart
    near = dup[:, torch.randint(0, 1500, (600,), generator=g)] + 0.01
    three = torch.rand((3, 3, 3), generator=g)
    return (("lattice knowns, lattice unknowns", on_lattice, lattice),
            ("duplicated knowns, m = 1500", near, dup),
            ("m = 3", torch.rand((3, 300, 3), generator=g), three),
            ("m = 37, n = 5", torch.rand((2, 5, 3), generator=g), dup[:, :37]),
            ("m = 1025", torch.rand((1, 999, 3), generator=g) * 20.0, dup[:1, :1025]))


def check_knn():
    from pointrcnn_tpu_torch.ops import cuda_knn

    tally = Tally()
    for name, B, n, m, path in KNN_SHAPES:
        row, nb, ops = knn_case(B, n, m)
        if path == "eval":
            tally.add(row["ms"], row["plain_ms"], nb, ops, PEAK_F32_PER_MS,
                      device_ms=row["device_ms"])
        b, term = bound(nb, ops, PEAK_F32_PER_MS)
        tally.shapes.append({"path": path, "stage": name, "b": B, "n": n, "m": m, **row,
                             "bound_ms": b, "term": term})
        log(f"three_nn {path} {name} B={B} n={n} m={m} plan {tuple(row['plan'])}: exact match "
            f"under every plan; kernel {row['ms']:.4f} ms through its wrapper, "
            f"{row['device_ms']:.4f} device (plans {row['plans']}), plain {row['plain_ms']:.4f} ms, "
            f"bound {b:.4f} ms ({term})")
    # ties, and knowns off the tile and group sizes, under every plan
    for name, u, kn in _knn_adversarial():
        u, kn = u.contiguous().cuda(), kn.contiguous().cuda()
        rd, ri = cuda_knn.three_nn_plain(u, kn)
        for shape_plan in cuda_knn.PLANS:
            d, i = cuda_knn._launch(u, kn, shape_plan)
            if not (torch.equal(i, ri) and torch.equal(d, rd)):
                raise AssertionError(f"three_nn {name} plan {shape_plan}: {(i != ri).sum().item()} "
                                     f"indices, {(d != rd).sum().item()} distances differ")
        log(f"three_nn {name} B={u.shape[0]} n={u.shape[1]} m={kn.shape[1]}: exact match under "
            f"all {len(cuda_knn.PLANS)} plans")
    return tally


# (name, B, N, C, S, features' dtype): the gather's tables: RPN SA2 of the
# eval forward; RPN SA2, SA3 and SA4 of the rpn training stage (every
# BN-train SA stage groups through it).  The dtype is the one each path
# hands K4 (every SA stage's output is f32: the max over K of f32
# activations); phase_default and phase_train check it at every launch
GATHER_SHAPES = (("eval RPN SA2", BATCH, 4096, 96, 1024, torch.float32),
                 ("train RPN SA2", TRAIN_BATCH, 4096, 96, 1024, torch.float32),
                 ("train RPN SA3", TRAIN_BATCH, 1024, 256, 256, torch.float32),
                 ("train RPN SA4", TRAIN_BATCH, 256, 512, 64, torch.float32))


def _gather_case(B, N, C, S, K, seed, dtype=torch.float32):
    """Seeded operands at one gather shape: neighbourhoods with repeats
    (the first quarter of the centroids backfilled from slot K/2 on, as the
    ball query backfills) and a bf16 cotangent."""
    g = torch.Generator().manual_seed(seed)
    xyz = _rpn_cloud(B, N, seed)
    feats = torch.randn((B, N, C), generator=g).to(dtype).cuda()
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    ct = torch.randn((B, S, K, 3 + C), generator=g).to(torch.bfloat16)
    return xyz, feats, (xyz[:, :S] + 0.1).contiguous(), idx.cuda(), ct


def _gather_equal(what, xyz, feats, cent, idx):
    from pointrcnn_tpu_torch.ops import cuda_gather

    got = cuda_gather._launch(xyz, feats, cent, idx)
    ref = cuda_gather.group_points_plain(xyz, feats, cent, idx)
    if not torch.equal(got, ref):
        raise AssertionError(f"gather {what}: {(got != ref).sum().item()} values differ")
    return got


def _gather_adversarial():
    """(name, B, N, C, S, K, seed): K4's runs (64 rows at C 96, 56 at 256,
    24 at 512) against the layout: runs that end mid-centroid, a ragged last
    run, rows that are not 16-byte multiples (the scalar feature path), one
    batch row, indices at both ends of the table."""
    return (("runs end mid-centroid (K 24)", 2, 1024, 96, 100, 24, 1),
            ("ragged last run (777 rows)", 3, 512, 32, 37, 7, 2),
            ("C 13, scalar feature path", 2, 300, 13, 50, 16, 3),
            ("C 100, scalar feature path", 2, 1024, 100, 64, 32, 4),
            ("C 8, K 1", 2, 256, 8, 19, 1, 5),
            ("B 1", 1, 4096, 96, 1024, 32, 6),
            ("B 1, C 512, ragged", 1, 256, 512, 61, 3, 7))


def check_gather():
    """K4 at every path shape (f32 and bf16 features), each held
    torch.equal to the plain version, timed through the wrapper (CUDA
    events) and on the device (20 launches through the wrapper captured in
    one CUDA graph); then the adversarial layouts."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    tally = Tally()
    for name, B, N, C, S, dtype in GATHER_SHAPES:
        for K in (16, 32):
            row = {"stage": name, "b": B, "n": N, "c": C, "s": S, "k": K,
                   "dtype": str(dtype).replace("torch.", "")}
            for dt in (torch.float32, torch.bfloat16):
                xyz, feats, cent, idx, _ = _gather_case(B, N, C, S, K, N + K, dt)
                got = _gather_equal(f"{name} K={K} {dt}", xyz, feats, cent, idx)
                run = lambda: cuda_gather._launch(xyz, feats, cent, idx)
                dev = graph_ms(run, 20)
                if dt != dtype:
                    row[f"device_ms_{str(dt).replace('torch.', '')}"] = dev
                    continue
                k = cuda_ms(run, 20)
                p = cuda_ms(lambda: cuda_gather.group_points_plain(xyz, feats, cent, idx), 5)
                nb = nbytes(xyz, feats, cent, idx, got)
                # a split, a subtraction and a cast per output value
                ops = 3.0 * got.numel()
                bound_ms = tally.add(k, p, nb, ops, PEAK_F32_PER_MS, device_ms=dev)
                row.update(ms=k, device_ms=dev, plain_ms=p, bound_ms=bound_ms,
                           term=bound(nb, ops, PEAK_F32_PER_MS)[1])
            tally.shapes.append(row)
            other = next(v for key, v in row.items() if key.startswith("device_ms_"))
            log(f"gather {name} B={B} N={N} C={C} S={S} K={K} ({row['dtype']} features): exact "
                f"match with f32 and bf16 features; kernel {row['ms']:.4f} ms through its wrapper, "
                f"{row['device_ms']:.4f} device ({other:.4f} with the other dtype), plain "
                f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    for name, B, N, C, S, K, seed in _gather_adversarial():
        for dt in (torch.float32, torch.bfloat16):
            xyz, feats, cent, idx, _ = _gather_case(B, N, C, S, K, seed, dt)
            idx[0, 0, 0], idx[-1, -1, -1] = 0, N - 1
            _gather_equal(f"{name} {dt}", xyz, feats, cent, idx)
        log(f"gather {name} (B={B} N={N} C={C} S={S} K={K}): exact match, f32 and bf16 features")
    # a feature table whose rows do not start 16-byte aligned (a view at an
    # offset of one element): the scalar path
    xyz, feats, cent, idx, _ = _gather_case(2, 512, 32, 64, 16, 8)
    base = torch.empty(feats.numel() + 1, device="cuda")
    shifted = base[1:].view(feats.shape)
    shifted.copy_(feats)
    _gather_equal("unaligned feature table", xyz, shifted, cent, idx)
    log("gather unaligned feature table (a view one element in): exact match")
    check_gather_graph()
    check_gather_trap()
    return tally


def check_gather_graph():
    """K4 through its wrapper captured in a CUDA graph (capture errors are
    not relaxed): the wrapper reads nothing back to the host."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    xyz, feats, cent, idx, _ = _gather_case(2, 4096, 96, 1024, 32, 11)
    ref = cuda_gather.group_points_plain(xyz, feats, cent, idx)
    cuda_gather._launch(xyz, feats, cent, idx)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = cuda_gather._launch(xyz, feats, cent, idx)
    g.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("gather captured in a CUDA graph: the replay differs from the "
                             "plain version")
    log("gather: captured in a CUDA graph through cuda_gather._launch; the replay equals the "
        "plain version")


# a child process launches K4 with one index equal to N: the kernel must
# print it and trap (which ends the child's CUDA context)
_TRAP_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from pointrcnn_tpu_torch.ops import cuda_gather
B, N, C, S, K = 2, 512, 16, 64, 8
xyz = torch.rand((B, N, 3), device="cuda")
feats = torch.randn((B, N, C), device="cuda")
idx = torch.randint(0, N, (B, S, K), dtype=torch.int32, device="cuda")
idx[1, 5, 3] = N
cuda_gather._launch(xyz, feats, xyz[:, :S].contiguous(), idx)
torch.cuda.synchronize()
print("no fault")
"""
TRAP_MESSAGE = "group_gather: index 512 outside [0, 512) at (batch 1, centroid 5, neighbour 3)"


def check_gather_trap():
    proc = subprocess.run([sys.executable, "-c", _TRAP_CHILD, REPO], capture_output=True,
                          text=True, timeout=300)
    said = proc.stdout + proc.stderr
    if proc.returncode == 0 or TRAP_MESSAGE not in said:
        raise AssertionError(f"gather with an index equal to N: the child exited "
                             f"{proc.returncode}, output:\n{said[-2000:]}")
    err = [line for line in said.splitlines() if "Error" in line or "error" in line]
    log(f"gather with an index equal to N: the child exited {proc.returncode} with the kernel's "
        f"message ({TRAP_MESSAGE!r}); {err[-1].strip() if err else ''}")


@contextlib.contextmanager
def gather_feature_dtypes(path: str):
    """Check that every K4 launch of a path at a shape of GATHER_SHAPES gets
    the features' dtype listed there (the dtype check_gather times it in)."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    listed = {(B, N, C): dt for _, B, N, C, _, dt in GATHER_SHAPES}
    seen, launch = set(), cuda_gather._launch

    def recording(xyz, features, new_xyz, idx):
        seen.add((tuple(features.shape), features.dtype))
        return launch(xyz, features, new_xyz, idx)

    cuda_gather._launch = recording
    try:
        yield
    finally:
        cuda_gather._launch = launch
    for shape, dt in seen:
        if listed.get(shape, dt) != dt:
            raise AssertionError(f"{path} path: K4 got {dt} features {shape}, check_gather "
                                 f"times {listed[shape]}")
    log(f"{path} path: K4's features {sorted((s, str(d)) for s, d in seen)}")


def _gather_bwd_adversarial():
    """(name, B, N, C, S, K, index rule): K8's buckets and warp runs
    against index patterns."""
    def all_one(B, N, S, K, g):
        return torch.full((B, S, K), N // 3, dtype=torch.int32)

    def few_rows(B, N, S, K, g):  # every other row of the first 40: the rest are empty
        return 2 * torch.randint(0, 20, (B, S, K), generator=g, dtype=torch.int32)

    def descending(B, N, S, K, g):
        p = torch.arange(S * K, dtype=torch.int32)
        return ((N - 1) - p % N).reshape(1, S, K).repeat(B, 1, 1)

    def backfill(B, N, S, K, g):
        idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
        idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
        return idx

    def straddle(B, N, S, K, g):  # runs of 100 equal indices across the warps' runs
        p = torch.arange(S * K, dtype=torch.int32)
        return ((p // 100) % N).reshape(1, S, K).repeat(B, 1, 1)

    return (("every position on one row", 2, 4096, 96, 1024, 32, all_one),
            ("empty rows", 2, 4096, 96, 256, 32, few_rows),
            ("descending indices", 2, 1024, 256, 256, 32, descending),
            ("backfill pattern", 3, 4096, 96, 512, 16, backfill),
            ("runs of one row across warp runs and buckets", 2, 1024, 96, 256, 32, straddle),
            ("ragged: S*K 259, C 13", 2, 300, 13, 37, 7, backfill),
            ("1024 channels (a 32-row tile)", 1, 4096, 1021, 64, 16, backfill))


def _check_bwd_case(what, idx, ct_cpu, N):
    """Two launches bit-equal and equal to the plain version on the CPU ->
    the kernel's (dtable, dcent) on the card."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    ct = ct_cpu.cuda()
    got = cuda_gather._launch_bwd(idx, ct, N)
    again = cuda_gather._launch_bwd(idx, ct, N)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"gather backward {what}: two launches differ")
    cpu = cuda_gather.group_points_backward_plain(idx.cpu(), ct_cpu, N)
    for name, a, b in zip(("dtable", "dcent"), got, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"gather backward {what}: {name} differs from the CPU plain "
                                 f"version in {(a.cpu() != b).sum().item()} places")
    return got, ct


def check_gather_bwd():
    """K8 at the training stage's shapes: two launches bit-equal (the
    design sums in a fixed order), bit-equal to the plain version on the CPU
    (index_add_ adds in ascending (s, k) order there, as the kernel does),
    and within the reorder bound 2 m 2^-24 sum|ct| (m = S*K terms at most)
    of the plain version on the card, whose index_add_ adds atomically in
    any order; timed through the wrapper and on the device (CUDA-graph
    replay); then adversarial index patterns."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    tally = Tally()
    tally.library_ms = 0.0
    for name, B, N, C, S, _ in GATHER_SHAPES[1:]:
        for K in (16, 32):
            _, _, _, idx, ct_cpu = _gather_case(B, N, C, S, K, 7 * N + K)
            got, ct = _check_bwd_case(f"{name} K={K}", idx, ct_cpu, N)
            ref = cuda_gather.group_points_backward_plain(idx, ct, N)
            abs_sum = cuda_gather.group_points_backward_plain(idx, ct.float().abs(), N)
            for what, a, b, m in zip(("dtable", "dcent"), got, ref, abs_sum):
                bound_ = 2 * S * K * 2.0 ** -24 * m.abs()
                if not bool(((a - b).abs() <= bound_).all()):
                    raise AssertionError(f"gather backward {name} K={K}: {what} outside the "
                                         f"reorder bound of the plain version")
                tally.err = max(tally.err, (a - b).abs().max().item())
            run = lambda: cuda_gather._launch_bwd(idx, ct, N)
            k = cuda_ms(run, 20)
            dev = graph_ms(run, 20)
            p = cuda_ms(lambda: cuda_gather.group_points_backward_plain(idx, ct, N), 5)
            rows = (idx.long() + torch.arange(B, device="cuda")[:, None, None] * N).reshape(-1)
            src = ct.reshape(-1, 3 + C).float()
            out = torch.zeros((B * N, 3 + C), device="cuda")
            lib = cuda_ms(lambda: out.index_add_(0, rows, src), 20)
            tally.library_ms += lib
            # read ct (bf16) and idx once, write dtable and dcent once; one
            # add per cotangent value
            nb = nbytes(idx, ct, *got)
            b_ms = tally.add(k, p, nb, float(ct.numel()), PEAK_F32_PER_MS, device_ms=dev)
            tally.shapes.append({"stage": name, "b": B, "n": N, "c": C, "s": S, "k": K, "ms": k,
                                 "device_ms": dev, "plain_ms": p, "library_ms": lib,
                                 "bound_ms": b_ms,
                                 "term": bound(nb, float(ct.numel()), PEAK_F32_PER_MS)[1]})
            log(f"gather backward {name} B={B} N={N} C={C} S={S} K={K}: deterministic, equal to "
                f"the CPU plain version, max err {tally.err:.3e} vs the card's plain version; "
                f"kernel {k:.4f} ms through its wrapper, {dev:.4f} device, plain {p:.4f} ms, "
                f"index_add_ {lib:.4f} ms, bound {b_ms:.4f} ms")
    for name, B, N, C, S, K, rule in _gather_bwd_adversarial():
        g = torch.Generator().manual_seed(S + K)
        idx = rule(B, N, S, K, g).contiguous().cuda()
        ct_cpu = torch.randn((B, S, K, 3 + C), generator=g).to(torch.bfloat16)
        _check_bwd_case(name, idx, ct_cpu, N)
        log(f"gather backward {name} (B={B} N={N} C={C} S={S} K={K}): deterministic, equal to "
            f"the CPU plain version")
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


# ROADMAP C12: the shipped configs whose SA stacks the card must admit
SHIPPED_CONFIGS = ("default.yaml", "people.yaml", "car_2x.yaml")


def _sa_stages(model, cfg):
    """(name, SharedMLP, N, S, K, batch, BN-free) for every grouped SA stage
    of the model: the RPN's at the eval batch, the RCNN's over the eval
    forward's rois (BATCH x TEST.RPN_POST_NMS_TOP_N) and, BN-free, over the
    rcnn stage's (RCNN_BATCH x ROI_PER_IMAGE) for the training direction."""
    net, r = model.rpn.Pointnet2MSG_0, cfg.RPN
    for k in range(net.n_sa):
        sa = getattr(net, f"SetAbstractionMSG_{k}")
        n = r.NUM_POINTS if k == 0 else r.SA_CONFIG.NPOINTS[k - 1]
        for i, (_, ns) in enumerate(sa.specs):
            yield f"RPN SA{k + 1}.{i}", getattr(sa, f"SharedMLP_{i}"), n, sa.npoint, ns, BATCH, False
    c, rois = cfg.RCNN, BATCH * cfg.TEST.RPN_POST_NMS_TOP_N
    for k in range(model.rcnn_net.n_sa):
        sa = getattr(model.rcnn_net, f"SetAbstraction_{k}")
        if sa.npoint is None:
            continue  # group-all: no neighbourhoods, not the fused route
        n = c.NUM_POINTS if k == 0 else c.SA_CONFIG.NPOINTS[k - 1]
        yield f"RCNN SA{k + 1}", sa.SharedMLP_0, n, sa.npoint, sa.nsample, rois, False
        if not c.USE_BN:
            yield (f"RCNN SA{k + 1} train", sa.SharedMLP_0, n, sa.npoint, sa.nsample,
                   RCNN_BATCH * c.ROI_PER_IMAGE, True)


def check_shipped_stages():
    """Every SA stage of the shipped configs that the port routes to K2 (the
    eval forward, and the fixed RPN of the rcnn stage) or to K2 + K7 (the
    BN-free RCNN stacks in training) runs on the card at its real widths, K
    and batch: each launches its kernels once through the model's own
    module, and a refusal fails."""
    from pointrcnn_tpu_torch.config import load_config
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
    from pointrcnn_tpu_torch.ops import cuda_mlp

    for cfg_name in SHIPPED_CONFIGS:
        cfg = load_config(os.path.join(REPO, "cfgs", cfg_name))
        model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0)).cuda()
        admitted = []
        for name, mlp, n, S, K, B, train in _sa_stages(model, cfg):
            g = torch.Generator().manual_seed(n + K)
            C = mlp.w0.shape[0] - 3
            xyz = _roi_cloud(B, n, n)
            feats = torch.relu(torch.randn((B, n, C), generator=g)).cuda() if C else None
            idx = torch.randint(0, n, (B, S, K), generator=g, dtype=torch.int32).cuda()
            dt = mlp.dtype or torch.float32
            fwd = cuda_mlp.fused_group_mlp_max_supported(feats, idx, dt)
            bwd = train and fwd and cuda_mlp.fused_group_bwd_supported(feats, idx)
            if not fwd or (train and not bwd):
                log(f"{cfg_name} {name} B={B} N={n} C={C} S={S} K={K}: generic route "
                    f"(not routed to the fused kernels)")
                continue
            group_args = (xyz, feats, xyz[:, :S].contiguous(), idx, True)
            f0, b0 = cuda_mlp.launches, cuda_mlp.bwd_launches
            try:
                mlp.train(train)
                if train:
                    feats.requires_grad_(True)
                    out = mlp(None, group_args=group_args)
                    (out * torch.randn(out.shape, generator=g).cuda()).sum().backward()
                else:
                    with torch.no_grad():
                        out = mlp(None, group_args=group_args)
                torch.cuda.synchronize()
            except Exception as e:
                raise AssertionError(f"{cfg_name} {name} B={B} N={n} C={C} S={S} K={K}: the card "
                                     f"refused the fused stage: {e}") from e
            finally:
                mlp.train(False)
            launched = (cuda_mlp.launches - f0, cuda_mlp.bwd_launches - b0)
            if launched != (1, int(train)) or not torch.isfinite(out).all():
                raise AssertionError(f"{cfg_name} {name}: launches (K2, K7) {launched}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            widths = tuple(getattr(mlp, f"w{j}").shape[1] for j in range(mlp.n))
            admitted.append(name)
            log(f"{cfg_name} {name} B={B} N={n} C={C} S={S} K={K} {widths}: admitted, K2"
                f"{' and K7' if train else ''} launched")
        log(f"{cfg_name}: every fused stage admitted ({len(admitted)}: {', '.join(admitted)})")
        del model


def _bq_ops(cand: float, S_total: int, W: int) -> float:
    """Per candidate: 3 sub, 3 mul, 2 add and a compare; per centroid the
    fold's W - 128 compares.  Ordering the kmax smallest of the 128 folded
    lanes needs far fewer than the scan and is not counted."""
    return 9.0 * cand + S_total * (W - 128)


def _bq_equal(what, got, ref):
    """Bit for bit (a NaN where the plain version has one)."""
    for name, a, b in zip(("dist2", "idx", "rel"), got, ref):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs in {(a != b).sum().item()} places")


# (path, stage, B, N, S, bands or None for the full scan, kmax, rel, the
# thin-band flag): the ball query's launches.  The eval forward's RPN SA1
# (K6) and SA2 (K5, no rel) are the main path's, the tallies'; the rpn step
# takes them at batch 16 (the rcnn step's RPN at the eval's); car_2x.yaml
# at N 32768 (16 bands of 2048) and 8192; K6's full-row branch (the flag
# false) on the sorted SA1 table; a ragged pool (W halves to 128, no fold)
BQ_SHAPES = (
    ("eval", "RPN SA1", BATCH, 16384, 4096, 16, 32, True, True),
    ("eval", "RPN SA2", BATCH, 4096, 1024, None, 32, False, None),
    ("rpn step", "RPN SA1", TRAIN_BATCH, 16384, 4096, 16, 32, True, True),
    ("rpn step", "RPN SA2", TRAIN_BATCH, 4096, 1024, None, 32, False, None),
    ("car_2x", "RPN SA1", BATCH, 32768, 8192, 16, 32, True, True),
    ("car_2x", "RPN SA2", BATCH, 8192, 2048, None, 32, False, None),
    ("guard false", "RPN SA1", BATCH, 16384, 4096, 16, 32, True, False),
    ("ragged", "pool 2176", 2, 2176, 256, None, 16, True, None),
)


def _bq_runs(x, c, kmax, rel, bands, flag):
    """(kernel under a plan (None: the wrapper's), plain version, centroids a
    band or None)."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq

    if bands is None:
        return (lambda p=None: bq._launch(x, c, kmax, emit_rel=rel, shape_plan=p),
                lambda: bq.ball_query_plain(x, c, kmax, emit_rel=rel), None)
    ok = torch.tensor(flag, device=x.device)
    return (lambda p=None: bq._launch_banded(x, c, kmax, bands, ok, shape_plan=p),
            lambda: bq.ball_query_banded_plain(x, c, kmax, bands, ok), c.shape[1] // bands)


def bq_case(B, N, S, bands, kmax, rel, flag, seed):
    """K5 or K6 at one shape under every plan the launch takes, each held
    bit for bit to the plain version and timed on the device; the
    wrapper's own choice also timed through it -> (the shape's row, bytes,
    operations)."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq
    from pointrcnn_tpu_torch.ops.common import gather_points, sm_count
    from pointrcnn_tpu_torch.ops.sampling import _banded_fps, _zsort, furthest_point_sample

    x = _rpn_cloud(B, N, seed)
    if bands is None:
        c = _rpn_cloud(B, S, seed + 1) if N % 512 else \
            gather_points(x, furthest_point_sample(x, S, method="blockwise"))
    else:
        x, _ = _zsort(x)
        c = gather_points(x, _banded_fps(x, S, bands))
    c = c.contiguous()
    run, plain, cpb = _bq_runs(x, c, kmax, rel, bands, flag)
    ref = plain()
    device = {}
    for shape_plan in bq.plans(cpb):
        _bq_equal(f"ball query B={B} N={N} S={S} bands={bands} flag={flag} plan {shape_plan}",
                  run(shape_plan), ref)
        device[shape_plan] = graph_ms(lambda p=shape_plan: run(p), 10)
    chosen = bq.plan(B, S, sm_count(x.device), cpb)
    row = {"plan": list(chosen), "ms": cuda_ms(run, 20), "device_ms": device[chosen],
           "plans": {_plan_key(k): v for k, v in device.items()},
           "plain_ms": cuda_ms(plain, 2)}
    if bands is not None and flag is not False:
        Ns = N // bands
        cand = B * cpb * Ns * sum(3 - (b == 0) - (b == bands - 1) for b in range(bands))
        W = bq.pick_w(Ns)
    else:
        cand, W = B * S * N, bq.pick_w(N)
    return row, nbytes(x, c, *ref), _bq_ops(cand, B * S, W)


def _bq_banded_table(g, n_bands, Ns, cpb):
    """A z-sorted (2, n_bands * Ns, 3) table and cpb centroids a band near
    its points, band-ordered."""
    from pointrcnn_tpu_torch.ops.sampling import _zsort

    xs, _ = _zsort(torch.rand((2, n_bands * Ns, 3), generator=g) * torch.tensor([8.0, 2.0, 16.0]))
    rows = torch.cat([b * Ns + torch.randperm(Ns, generator=g)[:cpb] for b in range(n_bands)])
    return xs, xs[:, rows] + (torch.rand((2, rows.numel(), 3), generator=g) - 0.5) * 0.05


def _bq_adversarial():
    """(name, table, centroids, kmax, rel, bands or None, flag): ties the
    kernels must break as the plain version does (duplicated points, a
    lattice, equal distances across classes), NaN and overflowing
    distances, ragged blocks, and bands of one W, of W 128 and of W 256
    whose full-row branch folds from 512."""
    g = torch.Generator().manual_seed(31)
    base = torch.rand((2, 512, 3), generator=g) * 8.0
    dup = base[:, torch.randint(0, 512, (4096,), generator=g)]  # each point ~8 times
    ax = torch.arange(16, dtype=torch.float32)
    lat = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(1, 4096, 3)
    lat = lat[:, torch.randperm(4096, generator=g)].repeat(2, 1, 1)
    on_lat = torch.randint(0, 32, (2, 100, 3), generator=g).float() * 0.5
    # the CPU tests' non-finite tables: NaN x one pass (512) before the
    # centroids' own points, a NaN centroid, far points whose d2 is inf
    tab = torch.rand((2, 2048, 3), generator=g) * 20.0 - 10.0
    own = torch.arange(600, 608)
    nan_class = tab.clone()
    nan_class[:, own - 512, 0] = float("nan")
    nan_cent = tab[:, own].clone()
    nan_cent[:, 3] = float("nan")
    far = tab.clone()
    keep = torch.zeros(2048, dtype=torch.bool)
    keep[own] = True
    far[:, ~keep, 0] = 1e20
    far[0, 640, 0] = tab[0, 640, 0]  # folded lane 0 of the first row
    cases = [("duplicated points", dup, dup[:, :64], 32, True, None, None),
             ("lattice, S = 100", lat, on_lat, 32, True, None, None),
             ("NaN x in the centroids' classes", nan_class, tab[:, own], 16, True, None, None),
             ("NaN centroid", tab, nan_cent, 16, True, None, None),
             ("d2 overflows to inf", far, tab[:, own], 16, True, None, None)]
    xs_dup = dup[:, torch.argsort(dup[0, :, 2], stable=True)]
    xs_dup[1] = xs_dup[0]
    cases.append(("duplicated points, 4 bands", xs_dup, xs_dup[:, ::64], 32, True, 4, True))
    xs_nan = _bq_banded_table(g, 4, 1024, 8)[0]
    rows = torch.cat([b * 1024 + torch.arange(600, 608) for b in range(4)])
    cent_nan = xs_nan[:, rows].clone()
    xs_nan[:, 88:96, 0] = float("nan")
    cases.append(("NaN x in band 0's classes, 4 bands", xs_nan, cent_nan, 32, True, 4, True))
    for name, n_bands, Ns, cpb in (("bands one W wide (Ns 512)", 8, 512, 8),
                                   ("Ns 128 (W 128, full row W 512)", 16, 128, 8),
                                   ("Ns 768 (W 256, full row W 512)", 4, 768, 16)):
        xs, cent = _bq_banded_table(g, n_bands, Ns, cpb)
        for flag in (True, False):
            cases.append((f"{name}, flag {flag}", xs, cent, 32, True, n_bands, flag))
    return cases


def check_ballquery():
    """K5 and K6 against their plain versions at every shape of BQ_SHAPES
    under every launch plan, then on adversarial tables, then the banded
    stage captured in a CUDA graph."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq

    k5, k6 = Tally(), Tally()
    for i, (path, stage, B, N, S, bands, kmax, rel, flag) in enumerate(BQ_SHAPES):
        row, nb, ops = bq_case(B, N, S, bands, kmax, rel, flag, 21 + 2 * i)
        tally = k5 if bands is None else k6
        if path == "eval":
            tally.add(row["ms"], row["plain_ms"], nb, ops, PEAK_F32_PER_MS,
                      device_ms=row["device_ms"])
        b, term = bound(nb, ops, PEAK_F32_PER_MS)
        tally.shapes.append({"path": path, "stage": stage, "b": B, "n": N, "s": S,
                             "bands": bands, "k": kmax, "rel": rel, "flag": flag, **row,
                             "bound_ms": b, "term": term})
        log(f"ball_query{'' if bands is None else '_banded'} {path} {stage} B={B} N={N} S={S} "
            f"bands={bands} k={kmax}{' rel' if rel else ''}"
            f"{'' if flag is None else f' flag {flag}'} plan {tuple(row['plan'])}: bit-equal "
            f"under every plan; kernel {row['ms']:.4f} ms through its wrapper, "
            f"{row['device_ms']:.4f} device (plans {row['plans']}), plain "
            f"{row['plain_ms']:.4f} ms, bound {b:.4f} ms ({term})")
    for name, x, c, kmax, rel, bands, flag in _bq_adversarial():
        x, c = x.contiguous().cuda(), c.contiguous().cuda()
        run, plain, cpb = _bq_runs(x, c, kmax, rel, bands, flag)
        ref = plain()
        for shape_plan in bq.plans(cpb):
            _bq_equal(f"ball query {name} plan {shape_plan}", run(shape_plan), ref)
        log(f"ball_query{'' if bands is None else '_banded'} {name} {tuple(x.shape)} "
            f"S={c.shape[1]} k={kmax}: bit-equal under plans {list(bq.plans(cpb))}")
    check_banded_graph()
    return k5, k6


def check_banded_graph():
    """The banded stage (``fps_group_banded``: z-sort, FPS, the thin-band
    flag and K6) captured in a CUDA graph, capture errors not relaxed, so
    nothing is read back to the host; captured on a cloud whose bands pass
    the guard, then replayed with the thin-band cloud copied into its
    input, where the flag reads false on the device and the replay equals
    the eager run on that cloud."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq
    from pointrcnn_tpu_torch.ops.grouping import fps_group_banded

    specs = ((0.1, 16), (0.5, 32))
    static = _rpn_cloud(BATCH, 16384, 0)
    thin = torch.from_numpy(thin_band_cloud(BATCH, 16384, 9)).cuda()
    want = [fps_group_banded(x, 4096, specs) for x in (static, thin)]
    torch.cuda.synchronize()
    before = bq.banded_launches
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fps_group_banded(static, 4096, specs)
    if bq.banded_launches != before + 1:
        raise AssertionError("the captured banded stage did not launch K6 once")
    for x, (w_xyz, w_rels), what in zip((static, thin), want, ("cloud 0", "thin-band cloud")):
        static.copy_(x)
        g.replay()
        torch.cuda.synchronize()
        _bq_equal(f"banded stage replayed on the {what}", (out[0], *out[1]), (w_xyz, *w_rels))
    log("ball_query_banded: fps_group_banded captured in a CUDA graph (no host read); replays on "
        "cloud 0 and on the thin-band cloud equal their eager runs")


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
    return 1000 * dt / TIMED_ITERS


def thin_band_cloud(batch: int, n: int, seed: int) -> np.ndarray:
    """A uniform cloud with half its points in a 0.3 m z-slab: the depth
    bands over the slab are thinner than RPN SA1's largest radius (0.5 m),
    so the banded stage must take the full-scan kernel."""
    from pointrcnn_tpu_torch.entry import synthetic_cloud

    pts = synthetic_cloud(batch, n, seed)
    rng = np.random.RandomState(seed + 100)
    pts[:, : n // 2, 2] = rng.uniform(30.0, 30.3, (batch, n // 2))
    return pts


@contextlib.contextmanager
def banded_calls():
    """Record each banded selection of the model: (table, centroids, kmax,
    bands, the thin-band flag, output)."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq

    calls, orig = [], bq.ball_query_banded

    def recording(xs, cent, kmax, n_bands, bands_ok):
        out = orig(xs, cent, kmax, n_bands, bands_ok)
        calls.append((xs, cent, kmax, n_bands, bands_ok, out))
        return out

    bq.ball_query_banded = recording
    try:
        yield calls
    finally:
        bq.ball_query_banded = orig


def check_thin_band(calls, counts):
    """The thin-band cloud's RPN SA1: the banded kernel read its flag false
    on the device and returned the full scan of the sorted table, which
    differs from the banded selection there (so a kernel that ignored the
    flag would fail)."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq

    if len(calls) != 1 or counts["ball_query_banded"] != 1 or counts["ball_query"] != 1:
        raise AssertionError(f"the thin-band cloud: {len(calls)} banded selections, {counts}")
    xs, cent, kmax, n_bands, flag, got = calls[0]
    if bool(flag):
        raise AssertionError("the thin-band cloud: the guard's flag read true")
    _bq_equal("the thin-band cloud's RPN SA1 against the full scan of the sorted table", got,
              bq.ball_query_plain(xs, cent, kmax, emit_rel=True))
    banded = bq.ball_query_banded_plain(xs, cent, kmax, n_bands, torch.ones_like(flag))
    if all(torch.equal(a, b) for a, b in zip(banded, got)):
        raise AssertionError("the thin-band cloud: the banded selection equals the full scan")
    log("thin-band cloud: the flag read false on the device, and RPN SA1's selection equals the "
        "full scan of the sorted table (not the banded one)")


def phase_default(launches):
    """The main path: the eval forward of cfgs/default.yaml -> its ms a
    batch."""
    from pointrcnn_tpu_torch.entry import entry, synthetic_cloud

    fwd, (model, _) = entry(batch=BATCH, device="cuda", seed=0)
    cfg = model.cfg
    clouds = [torch.from_numpy(synthetic_cloud(BATCH, cfg.RPN.NUM_POINTS, s)).cuda()
              for s in CLOUD_SEEDS]
    reset_counts()
    with gather_feature_dtypes("eval"), banded_calls() as calls:
        outs = [fwd(model, {"pts_input": pts}) for pts in clouds]
        torch.cuda.synchronize()
    counts = read_counts()
    if [bool(call[4]) for call in calls] != [True] * len(clouds):
        raise AssertionError("the banded stage's thin-band flag did not read true on the "
                             "seeded clouds")
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
    with banded_calls() as calls:
        out = fwd(model, {"pts_input": thin})
        torch.cuda.synchronize()
    counts = read_counts()
    log(f"thin-band cloud launches: {counts}")
    _check_outputs(out, cfg.TEST.RPN_POST_NMS_TOP_N, "default, thin-band cloud")
    check_thin_band(calls, counts)

    check_against_cpu(model, synthetic_cloud(1, cfg.RPN.NUM_POINTS, 5), "default")
    return _frames_per_s(fwd, model, clouds[0], "default")


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
    with gather_feature_dtypes("train"):
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
    with gather_feature_dtypes("rcnn train"):
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


# ---------------------------------------------------------------- KITTI eval

# the eval CLI's run: 64 frames at batch 4 (16 batches, a steady-state
# window after the first), each frame 2-4 cars, its KITTI tree, checkpoint
# and outputs under EVAL_WORK_DIR (removed after)
EVAL_FRAMES, EVAL_BATCH = 64, 4
EVAL_BATCHES = EVAL_FRAMES // EVAL_BATCH
EVAL_WORK_DIR = os.path.join(REPO, "pointrcnn_tpu_torch", "_build", "smoke_kitti")
# the fixture calibration (rect == lidar frame; f = 700, principal point
# (600, 200)) and image size of the KITTI tree the phase writes
KITTI_CALIB = """P0: 700 0 600 0 0 700 200 0 0 0 1 0
P1: 700 0 600 0 0 700 200 0 0 0 1 0
P2: 700 0 600 0 0 700 200 0 0 0 1 0
P3: 700 0 600 0 0 700 200 0 0 0 1 0
R0_rect: 1 0 0 0 1 0 0 0 1
Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0
Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0
"""
KITTI_PLANE = "# Plane\nWidth 4\nHeight 1\n0 -1 0 1.65\n"
IMG_W, IMG_H = 1242, 375
# a frame's points inside the image frustum and the range: more than the
# 16384 the dataset samples, so it samples without padding
FRAME_POINTS = 20000
# the post-process on the card against the CPU from the same outputs:
# refined boxes to 1e-5 of their largest magnitude, written numbers to 1e-4
POST_BOX_RTOL, POST_LINE_ATOL = 1e-5, 1e-4


def _png(width: int, height: int) -> bytes:
    """A black 8-bit grayscale PNG (zlib + struct, no image library)."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + bytes(width) for _ in range(height))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 0,
                                                               0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def _box2d(box):
    """The projected 2D box and KITTI alpha of a 3D box for KITTI_CALIB."""
    x, y, z, h, w, l, ry = box
    dx = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    dz = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    dy = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    c, s = np.cos(ry), np.sin(ry)
    cx, cz, cy = x + dx * c + dz * s, z - dx * s + dz * c, y + dy
    u, v = 700.0 * cx / cz + 600.0, 700.0 * cy / cz + 200.0
    beta = np.arctan2(z, x)
    return (u.min(), v.min(), u.max(), v.max()), -np.sign(beta) * np.pi / 2 + beta + ry


def _car_points(rng, box, n):
    """n points on a car's shell (4 walls and the roof), in the lidar frame."""
    x, y, z, h, w, l, ry = box
    face = rng.choice(5, size=n, p=np.array([l * h, l * h, w * h, w * h, l * w]) / (
        2 * l * h + 2 * w * h + l * w))
    u, v = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    sign = np.where((face == 0) | (face == 2), 1.0, -1.0)
    px = np.where(face <= 1, u * l, np.where(face <= 3, sign * l / 2, u * l))
    pz = np.where(face <= 1, sign * w / 2, np.where(face <= 3, u * w, v * w))
    py = np.where(face == 4, -h, -(v + 0.5) * h)
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([x + px * c + pz * s, y + py, z - px * s + pz * c], 1)


def write_kitti_tree(root: str, frames: int = EVAL_FRAMES, seed: int = 0) -> list[int]:
    """A KITTI tree of ``frames`` frames in the formats of the KITTI devkit:
    calibration text, label lines (cars with their projected 2D boxes and a
    DontCare region), velodyne ``.bin`` float32 (x, y, z, intensity),
    ground planes, a 1242 x 375 PNG, and a ``val`` split listing every
    frame.  Each frame: 2-4 cars at 10-40 m with 500 points on each, the
    rest ground and low clutter, all inside the image frustum and the
    point-cloud range -> the cars' boxes a frame."""
    rng = np.random.RandomState(seed)
    training = os.path.join(root, "KITTI", "object", "training")
    for sub in ("velodyne", "calib", "label_2", "planes", "image_2"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "KITTI", "ImageSets"), exist_ok=True)
    png = _png(IMG_W, IMG_H)
    all_boxes = []
    for i in range(frames):
        n_car = rng.randint(2, 5)
        boxes = []
        for _ in range(n_car):
            z = rng.uniform(10.0, 40.0)
            boxes.append((rng.uniform(-0.5, 0.5) * z, 1.65, z,
                          *(np.array([1.52, 1.63, 3.88]) * rng.uniform(0.9, 1.1, 3)),
                          rng.uniform(-np.pi, np.pi)))
        per_car = 500
        n_bg = FRAME_POINTS - per_car * n_car
        # ground and clutter: u, v inside the image (the ground from 7 m),
        # depth up to 70 m
        z = rng.uniform(7.0, 70.0, n_bg)
        lo, hi = -np.minimum(0.72 * z, 39.0), np.minimum(0.77 * z, 39.0)  # |x| <= 40 m
        x = lo + (hi - lo) * rng.rand(n_bg)
        clutter = rng.rand(n_bg) < 0.2
        y = np.where(clutter, rng.uniform(0.2, 1.6, n_bg), 1.65 + rng.normal(0, 0.03, n_bg))
        pts = [np.stack([x, y, z], 1)] + [_car_points(rng, b, per_car) for b in boxes]
        pts = np.concatenate(pts).astype(np.float32)
        cloud = np.concatenate([pts, rng.rand(len(pts), 1).astype(np.float32)], 1)
        sid = "%06d" % i
        cloud.tofile(os.path.join(training, "velodyne", sid + ".bin"))
        with open(os.path.join(training, "calib", sid + ".txt"), "w") as f:
            f.write(KITTI_CALIB)
        with open(os.path.join(training, "planes", sid + ".txt"), "w") as f:
            f.write(KITTI_PLANE)
        with open(os.path.join(training, "image_2", sid + ".png"), "wb") as f:
            f.write(png)
        with open(os.path.join(training, "label_2", sid + ".txt"), "w") as f:
            for b in boxes:
                (x1, y1, x2, y2), alpha = _box2d(b)
                x, y, z, h, w, l, ry = b
                f.write(f"Car 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} {h:.2f} "
                        f"{w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}\n")
            f.write("DontCare -1 -1 -10 0.00 0.00 20.00 20.00 -1 -1 -1 -1000 -1000 -1000 -10\n")
        all_boxes.append(np.array(boxes, np.float32))
    with open(os.path.join(root, "KITTI", "ImageSets", "val.txt"), "w") as f:
        f.write("\n".join("%06d" % i for i in range(frames)) + "\n")
    return all_boxes


@contextlib.contextmanager
def eval_instruments():
    """Record, for the eval CLI's run, without a sync of its own: the host
    span of each batch's device step (``_pipelined_epoch``'s ``enqueue``:
    upload, forward, post-process) and of its host processing
    (``process``: fetch, recall, files), the epoch's span, CUDA events
    around each joint post-process (its device span: from the forward's
    end to its own), and each post-process's candidates for the final NMS
    (``norm_scores > RCNN.SCORE_THRESH`` and ``roi_valid``) and survivors
    per frame, kept on the card and read after the epoch."""
    from pointrcnn_tpu_torch.eval import evaluator

    rec = {"enq": [], "proc": [], "epoch": [], "post_events": [], "cand": [], "kept": []}
    orig_epoch, orig_post = evaluator._pipelined_epoch, evaluator.joint_postprocess

    def spanned(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            rec[key].append((t0, time.perf_counter()))
            return out
        return run

    def epoch(loader, enqueue, process):
        t0 = time.perf_counter()
        orig_epoch(loader, spanned(enqueue, "enq"), spanned(process, "proc"))
        rec["epoch"].append((t0, time.perf_counter()))

    def post(cfg, out, gt_boxes3d=None):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = orig_post(cfg, out, gt_boxes3d)
        end.record()
        rec["post_events"].append((start, end))
        rec["cand"].append(((res["norm_scores"] > cfg.RCNN.SCORE_THRESH)
                            & res["roi_valid"]).sum(1))
        rec["kept"].append(res["sel_valid"].sum(1))
        return res

    evaluator._pipelined_epoch, evaluator.joint_postprocess = epoch, post
    try:
        yield rec
    finally:
        evaluator._pipelined_epoch, evaluator.joint_postprocess = orig_epoch, orig_post
        torch.cuda.synchronize()
        rec["post"] = [a.elapsed_time(b) for a, b in rec.pop("post_events")]
        rec["cand"] = torch.cat(rec["cand"]).tolist() if rec["cand"] else []
        rec["kept"] = torch.cat(rec["kept"]).tolist() if rec["kept"] else []


def _read_lines(path):
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines()]


def check_postprocess(cfg, ckpt, data_root, work):
    """One batch's network outputs on the card, the joint post-process run
    on the card and on the CPU from the same outputs: the same NMS
    survivors in the same order, refined boxes to POST_BOX_RTOL, and the
    written KITTI lines equal after parsing to POST_LINE_ATOL a number."""
    from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
    from pointrcnn_tpu_torch.eval import evaluator
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
    from pointrcnn_tpu_torch.ops.iou3d import boxes_iou_bev
    from pointrcnn_tpu_torch.ops.nms import nms_bev
    from pointrcnn_tpu_torch.train.checkpoint import load_checkpoint
    from pointrcnn_tpu_torch.train.state import TrainState
    from pointrcnn_tpu_torch.utils.box_ops import boxes3d_to_bev

    ds = KittiRCNNDataset(data_root, cfg, npoints=cfg.RPN.NUM_POINTS, split="val", mode="EVAL",
                          rpn_eval_labels=False)
    batch = ds.collate_batch([ds.getitem(i, np.random.RandomState(i)) for i in range(EVAL_BATCH)])
    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0)).to("cuda")
    load_checkpoint(ckpt, TrainState(step=0, model=model, opt_state={}))
    model.eval()
    gt = torch.from_numpy(batch["gt_boxes3d"])
    with torch.inference_mode():
        out = model({"pts_input": torch.from_numpy(batch["pts_input"]).cuda()})
        card = {k: v.cpu() for k, v in evaluator.joint_postprocess(cfg, out, gt.cuda()).items()}
        cpu = evaluator.joint_postprocess(cfg, {k: v.cpu() for k, v in out.items()}, gt)
    same = (torch.equal(card["sel_valid"], cpu["sel_valid"])
            and torch.equal(card["sel_idx"][card["sel_valid"]], cpu["sel_idx"][cpu["sel_valid"]]))
    if not same:
        for b in range(EVAL_BATCH):
            a = card["sel_idx"][b][card["sel_valid"][b]].tolist()
            c = cpu["sel_idx"][b][cpu["sel_valid"][b]].tolist()
            if a != c:
                diff = sorted(set(a) ^ set(c))
                bev = boxes3d_to_bev(cpu["pred_boxes3d"][b])
                iou = boxes_iou_bev(bev, bev)
                log(f"post-process frame {b}: card kept {a}, cpu kept {c}; the pairs' IoU "
                    f"(RCNN.NMS_THRESH {cfg.RCNN.NMS_THRESH}): "
                    + ", ".join(f"{i}-{j} {iou[i, j].item():.7f}" for i in diff for j in c + a
                                if i != j and iou[i, j] > 0))
        raise AssertionError("the card's final NMS kept other boxes than the CPU's")
    scale = cpu["pred_boxes3d"].abs().max().item()
    err = (card["pred_boxes3d"] - cpu["pred_boxes3d"]).abs().max().item()
    if err > POST_BOX_RTOL * scale:
        raise AssertionError(f"pred_boxes3d: card vs cpu max err {err} (scale {scale})")
    n_lines, worst = 0, 0.0
    for name, res in (("card", card), ("cpu", cpu)):
        os.makedirs(os.path.join(work, name), exist_ok=True)
        for b in range(EVAL_BATCH):
            sel = res["sel_idx"][b][res["sel_valid"][b]].numpy()
            sid = int(batch["sample_id"][b])
            evaluator.save_kitti_format(sid, ds.get_calib(sid), res["pred_boxes3d"][b].numpy()[sel],
                                        os.path.join(work, name), res["raw_scores"][b].numpy()[sel],
                                        ds.get_image_shape(sid), cfg.CLASSES,
                                        res["pred_cls"][b].numpy()[sel])
    for fname in sorted(os.listdir(os.path.join(work, "cpu"))):
        a = _read_lines(os.path.join(work, "card", fname))
        c = _read_lines(os.path.join(work, "cpu", fname))
        if len(a) != len(c) or any(x[0] != y[0] for x, y in zip(a, c)):
            raise AssertionError(f"{fname}: the card's KITTI lines differ from the CPU's")
        for x, y in zip(a, c):
            worst = max(worst, float(np.abs(np.array(x[1:], float) - np.array(y[1:], float)).max()))
        n_lines += len(c)
    if worst > POST_LINE_ATOL:
        raise AssertionError(f"KITTI lines: card vs cpu differ by {worst} (tol {POST_LINE_ATOL})")
    log(f"post-process card vs cpu (batch {EVAL_BATCH}, same network outputs): "
        f"{int(cpu['sel_valid'].sum())} NMS survivors identical in order, pred_boxes3d max err "
        f"{err:.3e} (scale {scale:.3e}, tol {POST_BOX_RTOL} relative), {n_lines} KITTI lines "
        f"equal to {worst:.1e} (tol {POST_LINE_ATOL})")

    # the final NMS on these inputs: the batch's frames in one call, as the
    # evaluator runs it, against one call a frame
    bev = boxes3d_to_bev(card["pred_boxes3d"].cuda())
    scores, keep = card["raw_scores"].cuda(), (card["norm_scores"] > cfg.RCNN.SCORE_THRESH).cuda()
    keep &= card["roi_valid"].cuda()
    M, thresh = bev.shape[1], cfg.RCNN.NMS_THRESH
    batched = lambda: nms_bev(bev, scores, thresh, M, M, rotated=True, valid=keep)
    framed = lambda: [nms_bev(bev[b], scores[b], thresh, M, M, rotated=True, valid=keep[b])
                      for b in range(EVAL_BATCH)]
    if not all(torch.equal(x[b], y) for x, f in zip(batched(), zip(*framed()))
               for b, y in enumerate(f)):
        raise AssertionError("the batched final NMS differs from one call a frame")
    with torch.inference_mode():
        nms_ms = [(cuda_ms(batched, 10), cuda_ms(framed, 10)) for _ in range(3)]
    log(f"final NMS over {EVAL_BATCH} frames x {M} boxes on the card, three runs of 10 calls: "
        f"one batched call ms {', '.join(f'{a:.3f}' for a, _ in nms_ms)}; a call a frame ms "
        f"{', '.join(f'{b:.3f}' for _, b in nms_ms)} (the same survivors)")


def phase_kitti_eval(launches, fwd_ms, card):
    """The eval CLI (``python -m pointrcnn_tpu_torch.eval``) in-process on a
    KITTI tree written here, from a port checkpoint of seeded random
    weights of cfgs/default.yaml with the RCNN: ``--eval_mode rcnn`` at
    batch 4 (EVAL_BATCHES batches; K1-K6 launched EVAL_BATCHES times a
    forward's count of phase_default), then ``--eval_mode rpn``; the
    post-process on the card against the CPU.  ``launches``:
    phase_default's counts over its forwards -> the rcnn run's counts."""
    from pointrcnn_tpu_torch.entry import default_config
    from pointrcnn_tpu_torch.eval.__main__ import main as eval_main
    from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer
    from pointrcnn_tpu_torch.train.state import create_train_state
    from pointrcnn_tpu_torch.utils import native

    work = EVAL_WORK_DIR
    shutil.rmtree(work, ignore_errors=True)
    try:
        data_root = os.path.join(work, "data")
        boxes = write_kitti_tree(data_root)
        lib = native.get_lib()
        log(f"native host ops: {'loaded ' + native.library_path() if lib is not None else 'not loaded, numpy fallbacks'}")
        cfg = default_config(["RCNN.ENABLED", "True"])
        state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=0, device="cuda")
        ckpt = save_checkpoint(os.path.join(work, "ckpt"), state, epoch=1, it=0)
        del state
        common = ["--cfg_file", os.path.join(REPO, "cfgs", "default.yaml"), "--data_root",
                  data_root, "--batch_size", str(EVAL_BATCH), "--device", "cuda"]
        reset_counts()
        t0 = time.perf_counter()
        with eval_instruments() as rec:
            ret = eval_main(common + ["--eval_mode", "rcnn", "--ckpt", ckpt,
                                      "--output_dir", os.path.join(work, "rcnn")])
        run_s = time.perf_counter() - t0
        counts = read_counts()
        log(f"eval CLI rcnn launches: {counts}")
        per_fwd = {k: v / len(CLOUD_SEEDS) for k, v in launches.items()}
        for name in EVAL_KERNELS:
            if counts[name] != EVAL_BATCHES * per_fwd[name]:
                raise AssertionError(f"eval CLI: {name} launched {counts[name]} times, not "
                                     f"{EVAL_BATCHES} times the default forward's {per_fwd[name]}")
        final = os.path.join(work, "rcnn", "final_result", "data")
        missing = [i for i in range(EVAL_FRAMES) if not os.path.isfile(os.path.join(final, "%06d.txt" % i))]
        if missing:
            raise AssertionError(f"eval CLI: no result file for frames {missing}")
        scalars = {k: float(v) for k, v in ret.items()}
        want = ["recall_0.1", "recall_0.7", "roi_recall_0.7", "Car_3d_easy", "Car_bev_moderate",
                "Car_image_hard"]
        if any(k not in scalars for k in want) or not all(np.isfinite(list(scalars.values()))):
            raise AssertionError(f"eval CLI: recall / AP missing or not finite: {scalars}")
        log(f"eval CLI rcnn: {int(scalars['final_total'])} boxes written over {EVAL_FRAMES} "
            f"frames ({sum(len(b) for b in boxes)} gt cars); recall@0.1/0.5/0.7 "
            f"{scalars['recall_0.1']:.4f}/{scalars['recall_0.5']:.4f}/{scalars['recall_0.7']:.4f}"
            f", Car 3d AP easy/moderate/hard {scalars['Car_3d_easy']:.4f}/"
            f"{scalars['Car_3d_moderate']:.4f}/{scalars['Car_3d_hard']:.4f} (random weights)")
        log(f"eval CLI final NMS: candidates above RCNN.SCORE_THRESH a frame {rec['cand']}, "
            f"survivors {rec['kept']}")
        if max(rec["cand"]) == 0:
            raise AssertionError("eval CLI: no frame had a candidate for the final NMS")
        (e0, e1), enq, proc = rec["epoch"][0], rec["enq"], rec["proc"]
        if len(proc) != EVAL_BATCHES:
            raise AssertionError(f"eval CLI: {len(proc)} batches, not {EVAL_BATCHES}")
        ms = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
        # steady state: a cycle of the pipeline, from one batch's device
        # step to the next's, holds a device step, the previous batch's
        # host processing and the loader's hand-off; the cycles of batches
        # 2 to EVAL_BATCHES - 1 (the first warms up, the last drains)
        gaps = [1000 * (b[0] - a[0]) for a, b in zip(enq[1:], enq[2:])]
        steady_fps = EVAL_BATCH * len(gaps) / (enq[-1][0] - enq[1][0])
        log(f"{card}: eval pipeline batch {EVAL_BATCH} x {cfg.RPN.NUM_POINTS} points, loader to "
            f"files: {steady_fps:.3f} frames/s over batches 2-{EVAL_BATCHES - 1} ({len(gaps)} "
            f"cycles, one batch's device step to the next's, ms min {min(gaps):.3f} median "
            f"{float(np.median(gaps)):.3f} max {max(gaps):.3f}); the epoch of {EVAL_FRAMES} "
            f"frames {1000 * (e1 - e0):.3f} ms ({EVAL_FRAMES / (e1 - e0):.3f} frames/s, the "
            f"loader's first batch included), whole CLI run {run_s:.3f} s (model, restore, "
            f"loader, epoch, AP)")
        log(f"eval pipeline a batch: cycles ms [{ms(gaps)}]; device step host span (upload, "
            f"forward, post-process) ms [{ms(1000 * (b - a) for a, b in enq)}]; post-process "
            f"device span by CUDA events (decode, rotated NMS, recall IoUs) ms "
            f"[{ms(rec['post'])}]; host processing (fetch, recall, files) ms "
            f"[{ms(1000 * (b - a) for a, b in proc)}]; waiting on the loader "
            f"{1000 * (enq[0][0] - e0):.3f} ms before the first batch; the default forward "
            f"alone {fwd_ms:.3f} ms a batch (phase 4)")

        reset_counts()
        rpn = eval_main(common + ["--eval_mode", "rpn", "--rpn_ckpt", ckpt,
                                  "--output_dir", os.path.join(work, "rpn")])
        rpn_counts = read_counts()
        if rpn_counts["fused_group_mlp_max"] <= 0 or "rpn_seg_iou" not in rpn \
                or not np.isfinite(rpn["recall_0.7"]):
            raise AssertionError(f"eval CLI rpn: {rpn}, launches {rpn_counts}")
        log(f"eval CLI rpn: recall@0.5/0.7 {rpn['recall_0.5']:.4f}/{rpn['recall_0.7']:.4f}, seg "
            f"IoU {rpn['rpn_seg_iou']:.4f}, launches {rpn_counts}")

        check_postprocess(cfg, ckpt, data_root, os.path.join(work, "post"))
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    check_shipped_stages()
    launches, train_launches, rcnn_launches = {}, {}, {}
    fwd_ms = phase_default(launches)
    phase_exact()
    eval_cli_launches = phase_kitti_eval(launches, fwd_ms, card)
    ckpt = phase_train(train_launches)
    try:
        phase_rcnn_train(rcnn_launches, ckpt)
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    # launches: the count of the eval forward's run, or for a kernel that
    # only a training stage runs, of that stage's run (the rpn stage's for
    # the gather backward, the rcnn stage's for the MLP backward);
    # train_launches and rcnn_train_launches: each training run's;
    # eval_cli_launches: the eval CLI's rcnn run's (64 frames, 16 batches)
    rows = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name] if name in EVAL_KERNELS else
             (train_launches[name] if name in TRAIN_KERNELS else rcnn_launches[name]),
             "train_launches": train_launches[name], "rcnn_train_launches": rcnn_launches[name],
             "eval_cli_launches": eval_cli_launches[name], **tallies[name].row()}
            for name, source, replaces, _, _ in KERNELS]
    log(f"{card}; chip_smoke {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
