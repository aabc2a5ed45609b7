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
   whose flag reads false; K9 (F-FPS) at 3DSSD's shapes; K10 (the exact
   ball query) index-equal to its plain version at 3DSSD's four queries
   and the exact setting's stages, on random, duplicated and on-sphere
   points under every block size, timed beside its bound;
3b. the SA stages of every shipped config (``cfgs/default.yaml``,
   ``people.yaml``, ``car_2x.yaml``), of default.yaml + ``WIDE_OVERRIDES``
   and of car_2x.yaml + ``EXACT_OVERRIDES`` that the port routes to the
   fused MLP kernels: each launches K2 (and, in the BN-free RCNN stacks'
   training direction, K7) once at its real widths, K and batch, and a
   refusal fails (ROADMAP C12); then every kernel at the shapes past its
   first plans (``check_port_limits``): K1 over rows of 32768-140000
   points (``torch.equal``), K4 and K8 at 3 + 1024 channels, K2 and K7 at
   one layer, K 128, five layers up to 640, ``use_xyz`` False, each with
   its bound, the global plan's bits against the first plan's;
4. drive the main path (``pointrcnn_tpu_torch.entry``: the two-stage eval
   forward of ``cfgs/default.yaml`` as it stands) at batch 4 x 16384 points
   on seeded clouds, check shapes, finiteness and that every kernel
   launched (and that K4 got the features' dtype it is timed in, as in
   phase 7, and that the banded stage's thin-band flag read true); run a
   cloud with a dense z-cluster whose flag must read false on the device,
   RPN SA1 then equal to the full scan of its sorted table; hold a batch-1
   forward against the port's plain path on the CPU; time frames/s;
5. the same for the exact-method setting (``entry.EXACT_OVERRIDES``) on
   one cloud, every ball query on K10 (one launch a sampling SA stage);
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
10. (after 9) the train CLI (``python -m pointrcnn_tpu_torch.train``, its
   ``main()`` in-process on the card) at ``cfgs/default.yaml`` as it stands
   (AUG_DATA, GT_AUG, 16384 points, bf16) on a 64-frame KITTI tree with its
   train split's gt database (``python -m
   pointrcnn_tpu_torch.tools.generate_gt_database``): (a) rpn at batch 16,
   one epoch; (b) its resume from (a)'s checkpoint for a second epoch with
   the val epoch over ``smallval``; (c) rcnn at batch 4 from (b)'s RPN;
   (a) and (c) launch every kernel their steps times the per-step counts
   of phases 7 and 9; every loss finite; each run's ms/step over its steps
   after the first (CUDA events around each step, no added sync) with its
   min, median and max, the loader's wait before the first batch and the
   peak memory; each checkpoint loads back bit for bit; (c) updates every
   RCNN parameter and moves the fixed RPN by the weight decay alone.
9b. (after 9) ``RCNN.USE_RPN_FEATURES`` False (RCNN SA1 on 3 + 130
   channels, no up or merge layer; its SA stages also in 3b): the joint eval
   forward at batch 4 launches a forward's counts of phase 4 with finite
   outputs; one rcnn step launches K2 6 and K7 2 times, every stack on the
   fused route, with a finite loss.
11. (after 10) the reference's offline recipe through the CLIs on the same
   tree, from (b)'s RPN: (d) ``--eval_mode rpn --save_rpn_feature`` over the
   train split at 300 proposals a frame and over smallval (the RPN's share
   of phase 4's launches a batch); (e) ``--train_mode rcnn_offline`` at
   batch 4, one epoch, ``--train_with_eval`` over the smallval dump (K1, K2
   and K7 twice a step, K1 and K2 twice a val batch, nothing else; ms/step
   by CUDA events, peak memory, the checkpoint loaded back bit for bit),
   and (e') the same with ``--worker_processes`` (its ms/step beside (e)'s);
   (f) ``--eval_mode rcnn_offline`` of (e)'s checkpoint on smallval with the
   official AP (K1 and K2 twice a batch; frames/s, peak memory); then,
   from seeded weights, an offline train step (one frame's rois sampled
   from its proposals and gt boxes, with foreground) against the CPU path
   with phase 9's tolerances, and an offline eval batch: its pooled
   inputs, the RCNN's outputs and the post-process against the CPU's.
12. (after 11) data parallel on the one card: (a)
   ``entry.dryrun_multichip(2)``, the two ranks under ``gloo`` on this card
   (NCCL refuses two ranks on one card): three joint steps of its mid-size
   config, a checkpoint round trip whose restored state gives the saved
   state's next loss, a sharded eval step against the whole batch's on one
   rank, every kernel launched on rank 0; (b) the default rpn step at
   global batch 16 through torchrun (``python -m
   pointrcnn_tpu_torch.tools.dp_step``), world 1 under ``nccl`` and world
   2 under ``gloo`` with both ranks on cuda:0: each rank's ms/step, peak
   memory and launches (K4 and K8 6 a step, every kernel of the path),
   world 2 within the CPU tests' bf16 bounds of world 1 (loss, gradient
   norm, parameters, BN statistics), and a world 2 with a planted fault
   (each rank's batch norms on its own rows) outside them; (c) the train CLI under torchrun, rpn
   at batch 16 for one epoch of phase 10's tree, world 1 ``nccl`` and world
   2 ``gloo`` on cuda:0, each logging its process group and checkpoint,
   the last losses within the same bound.  A 4-card run is not possible on
   this machine;
13. cfgs/car_2x.yaml at full width (32768 points): the eval forward at
   batch 4 (two clouds, every eval kernel, frames/s, peak memory, a batch-1
   forward against the CPU path), the rpn step at batch 16 and the rcnn
   step at batch 4 from its checkpoint (each ms/step, frames/s, peak
   memory, the per-step launches of phases 7 and 9, every trained
   parameter moved, a batch-1 step against the CPU path);
14. cfgs/people.yaml's joint step (RPN and 3-class RCNN trained together,
   as shipped) at batch 4: the same records, K4 and K8 6 and K2 and K7 2 a
   step, and a batch-1 step against the CPU path with the card's proposals
   and target draws handed to it, on the joint scene and on one whose gt
   boxes all sit on proposals (few foreground points: held within 5 times
   what the CPU's own step moves when its input moves by one ulp);
15. path W (default.yaml + ``WIDE_OVERRIDES``): the eval forward at batch
   4, the rpn step at 16 and the rcnn step at 4 from its checkpoint, and
   path X (car_2x.yaml + ``EXACT_OVERRIDES``): the eval forward at batch 4,
   each with the records of phase 13 and its launches.

The second-to-last line is the kernel table as JSON (with the launches of
phases 12-15 and each kernel's ``limit_shapes``), the last line
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

from pointrcnn_tpu_torch.ops import counts as kernel_counts

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

# (kernel, source, TPU kernel it replaces); its launches are counted in
# pointrcnn_tpu_torch.ops.counts
KERNELS = (
    ("fps", "pointrcnn_tpu_torch/csrc/fps.cu", "pointrcnn_tpu/ops/pallas_fps.py:34"),
    ("three_nn", "pointrcnn_tpu_torch/csrc/knn.cu", "pointrcnn_tpu/ops/pallas_knn.py:25"),
    ("group_gather", "pointrcnn_tpu_torch/csrc/gather.cu",
     "pointrcnn_tpu/ops/pallas_gather.py:69"),
    ("fused_group_mlp_max", "pointrcnn_tpu_torch/csrc/mlp.cu",
     "pointrcnn_tpu/ops/pallas_mlp.py:84"),
    ("ball_query", "pointrcnn_tpu_torch/csrc/ballquery.cu",
     "pointrcnn_tpu/ops/pallas_ballquery.py:151"),
    ("ball_query_banded", "pointrcnn_tpu_torch/csrc/ballquery.cu",
     "pointrcnn_tpu/ops/pallas_ballquery.py:229"),
    ("gather_backward", "pointrcnn_tpu_torch/csrc/gather.cu",
     "pointrcnn_tpu/ops/pallas_gather.py:95"),
    ("fused_group_mlp_backward", "pointrcnn_tpu_torch/csrc/mlp.cu",
     "pointrcnn_tpu/ops/pallas_mlp.py:458"),
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
               ("mlp", _build.NO_FMAD), ("ballquery", _build.NO_FMAD),
               ("ballquery_first_k", _build.NO_FMAD), ("bn_train", _build.NO_FMAD))
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


# K9 (F-FPS) at 3DSSD's batch-4 shapes: (stage, rows, table rows, values a
# row, picks, range start, range end): SA2's F-FPS half of fusion sampling
# over 4096 rows of 3 + 64, SA3's over the first 512 of 1024 rows of 3 + 128
FFPS_SHAPES = (("3DSSD SA2", BATCH, 4096, 67, 512, 0, 4096),
               ("3DSSD SA3", BATCH, 1024, 131, 256, 0, 512))


def _ffps_rows(b, n, d, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((b, n, 3), generator=g) * 40.0
    feats = torch.relu(torch.randn((b, n, d - 3), generator=g)) * 3.0
    return torch.cat([xyz, feats], -1).cuda()


def check_ffps():
    """K9 against its plain version (torch.equal) at 3DSSD's shapes, on
    random rows and on rows each given twice (every step ties), timed
    through its wrapper, with its bound: the table's bytes, (npoint - 1) x n
    x (3 d + 1) operations at the f32 rate, K1's step latency."""
    from pointrcnn_tpu_torch.ops import cuda_fps

    tally = Tally()
    t_step = fps_step_ms()
    for name, B, N, D, npoint, start, end in FFPS_SHAPES:
        rows = _ffps_rows(B, N, D, N + D)
        half = rows[:, : N // 2]
        for what, x in (("random rows", rows), ("every row twice", torch.cat([half, half], 1))):
            got = cuda_fps.feature_fps(x, npoint, start, end)
            ref = cuda_fps.feature_fps_plain(x, npoint, start, end)
            if not torch.equal(got, ref):
                raise AssertionError(f"ffps {name} {what}: {(got != ref).sum().item()} picks "
                                     f"differ from the plain version")
        ms = cuda_ms(lambda: cuda_fps.feature_fps(rows, npoint, start, end), 10)
        plain_ms = cuda_ms(lambda: cuda_fps.feature_fps_plain(rows, npoint, start, end), 1)
        n = end - start
        nb, ops = 4 * B * (n * D + npoint), float(B) * (npoint - 1) * n * (3 * D + 1)
        lat = (npoint - 1) * t_step
        tally.add(ms, plain_ms, nb, ops, PEAK_F32_PER_MS, lat)
        b, term = bound(nb, ops, PEAK_F32_PER_MS, lat)
        tally.shapes.append({"stage": name, "rows": B, "n": n, "d": D, "npoint": npoint,
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "term": term})
        log(f"ffps {name} {B}x{n}x{D}->{npoint}: exact match on random and duplicated rows; "
            f"kernel {ms:.4f} ms through its wrapper, plain {plain_ms:.1f} ms, bound {b:.4f} ms "
            f"({term}), bound / kernel {b / ms:.3f}")
    return tally


# K10's shapes (name, B, N, S, specs, cloud): 3DSSD's four exact queries at
# batch 4 (cfgs/3dssd_car.yaml; the tally's: SA2's fusion sampling gives 2 x
# 512 centres, SA3 queries its 2 x 256 over SA2's 1024 rows, the votes 256
# over SA3's 512), then the exact setting's PointRCNN stages (entry.EXACT_OVERRIDES: RPN SA1-SA4 at batch 4, RCNN SA1
# and SA2 over 400 rois) and path K's nsample past N
FIRST_K_SHAPES = (
    ("3DSSD SA1", BATCH, 16384, 4096, ((0.2, 32), (0.4, 32), (0.8, 64)), "rpn"),
    ("3DSSD SA2", BATCH, 4096, 1024, ((0.4, 32), (0.8, 32), (1.6, 64)), "rpn"),
    ("3DSSD SA3", BATCH, 1024, 512, ((1.6, 32), (3.2, 32), (4.8, 32)), "rpn"),
    ("3DSSD votes", BATCH, 512, 256, ((4.8, 16), (6.4, 32)), "rpn"),
    ("exact RPN SA1", BATCH, 16384, 4096, ((0.1, 16), (0.5, 32)), "rpn"),
    ("exact RPN SA2", BATCH, 4096, 1024, ((0.5, 16), (1.0, 32)), "rpn"),
    ("exact RPN SA3", BATCH, 1024, 256, ((1.0, 16), (2.0, 32)), "rpn"),
    ("exact RPN SA4", BATCH, 256, 64, ((2.0, 16), (4.0, 32)), "rpn"),
    ("exact RCNN SA1", 400, 512, 128, ((0.2, 64),), "roi"),
    ("exact RCNN SA2", 400, 128, 32, ((0.4, 64),), "roi"),
    ("nsample past N", 400, 128, 32, ((0.4, 512),), "roi"),
)


def _first_k_equal(what, got, ref):
    for (radius, nsample), a, b in zip(what[1], got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"ball_query_first_k {what[0]} r={radius} ns={nsample}: "
                                 f"{(a != b).sum().item()} indices differ from the plain version")


def _first_k_pairs(x, c, specs) -> int:
    """The (centre, point) pairs the selection needs: per centre the points
    up to the one at which every spec holds its nsample hits, the whole row
    where one never does (what K10 scans, before its steps of 32)."""
    from pointrcnn_tpu_torch.ops.common import radius_sq, square_distance_exact

    N = x.shape[1]
    total = 0
    for cc in c.split(256, dim=1):
        d2 = square_distance_exact(cc, x)
        need = torch.zeros(cc.shape[:2], dtype=torch.int64, device=x.device)
        for radius, nsample in specs:
            full = (d2 < radius_sq(radius)).cumsum(-1, dtype=torch.int32) >= nsample
            need = torch.maximum(need, torch.where(full.any(-1), full.int().argmax(-1) + 1, N))
        total += int(need.sum())
    return total


def _sphere_table(c, specs, per: int, seed: int):
    """Points on the sphere of each radius around each centre of ``c`` (B,
    S, 3): the six along the axes (d2 == r2 or its neighbour after
    rounding) and ``per`` more in random directions, the rows shuffled."""
    g = torch.Generator().manual_seed(seed)
    B, S, _ = c.shape
    axes = torch.cat([torch.eye(3), -torch.eye(3)])
    pts = []
    for radius, _ in specs:
        u = torch.randn((B, S, per, 3), generator=g)
        u = torch.cat([axes.expand(B, S, 6, 3), u / u.norm(dim=-1, keepdim=True)], 2)
        r = torch.tensor(radius, dtype=torch.float32)
        pts.append(c.cpu()[:, :, None, :] + r * u)
    pts = torch.cat(pts, 2).reshape(B, -1, 3)
    return pts[:, torch.randperm(pts.shape[1], generator=g)].contiguous().cuda()


def check_ball_query_first_k():
    """K10 index-equal to its plain version on the card at every shape of
    FIRST_K_SHAPES, on random points, on every point given twice and on
    points placed on the sphere of each radius; timed through its wrapper
    and on the device (CUDA-graph replay)
    beside the plain version, with its bound: the table, centres and indices
    once, 8 FP32 operations and a compare a spec for each (centre, point)
    pair the selection needs (:func:`_first_k_pairs`); then more specs than
    a launch takes (two launches)."""
    from pointrcnn_tpu_torch.ops import cuda_ballquery as bq

    tally = Tally()
    for i, (name, B, N, S, specs, kind) in enumerate(FIRST_K_SHAPES):
        g = torch.Generator().manual_seed(31 + i)
        x = cloud(kind, B, N, 31 + i)
        c = x[:, torch.randperm(N, generator=g)[:S].cuda()].contiguous()
        half = x[:, :N // 2]
        twice = torch.cat([half, half], 1).contiguous()
        sphere_c = c[:, :64].contiguous()
        cases = (("random", x, c), ("every point twice", twice, c),
                 ("on the spheres", _sphere_table(sphere_c, specs, 10, i), sphere_c))
        for what, xx, cc in cases:
            _first_k_equal((f"{name} {what}", specs), bq.ball_query_first_k(xx, cc, specs),
                           bq.ball_query_first_k_plain(xx, cc, specs))
        run = lambda: bq.ball_query_first_k(x, c, specs)  # noqa: E731
        ms = cuda_ms(run, 20)
        device_ms = graph_ms(run, 10)
        plain_ms = cuda_ms(lambda: bq.ball_query_first_k_plain(x, c, specs), 1)
        pairs = _first_k_pairs(x, c, specs)
        nb = nbytes(x, c) + 4 * B * S * sum(ns for _, ns in specs)
        ops = float(pairs) * (8 + len(specs))
        b, term = bound(nb, ops, PEAK_F32_PER_MS)
        if name.startswith("3DSSD"):
            tally.add(ms, plain_ms, nb, ops, PEAK_F32_PER_MS, device_ms=device_ms)
        tally.shapes.append({"stage": name, "b": B, "n": N, "s": S, "specs": specs,
                             "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "pairs": pairs,
                             "pairs_share": pairs / (B * S * N), "bound_ms": b, "term": term})
        log(f"ball_query_first_k {name} B={B} N={N} S={S} specs {specs}: index-equal on random, "
            f"duplicated and on-sphere points; kernel {ms:.4f} ms through its wrapper, "
            f"{device_ms:.4f} device, plain {plain_ms:.3f} ms, bound {b:.4f} ms ({term}; "
            f"{pairs / (B * S * N):.3f} of the pairs needed), bound / device {b / device_ms:.3f}")
    x = cloud("rpn", 2, 3000, 7)
    c = x[:, :300].contiguous()
    specs = [(0.5 * (k + 1), 4 + 3 * k) for k in range(bq.FIRST_K_SPECS + 2)]
    before = kernel_counts.read()["ball_query_first_k"]
    _first_k_equal(("six specs", specs), bq.ball_query_first_k(x, c, specs),
                   bq.ball_query_first_k_plain(x, c, specs))
    launched = kernel_counts.read()["ball_query_first_k"] - before
    if launched != 2:
        raise AssertionError(f"six specs took {launched} launches, not 2")
    log(f"ball_query_first_k {len(specs)} specs, N=3000 (no multiple of a tile): index-equal "
        f"in two launches")
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


# the training SharedMLP stacks with batch norm at batch 16 (ops/cuda_bn.py):
# (config, npoints, nsamples, SA widths per stage and radius, FP widths
# (rows: the FP level's points), as cfgs/default.yaml and cfgs/car_2x.yaml)
BN_TRAIN_BATCH = 16
BN_SA_MLPS = ([[16, 16, 32], [32, 32, 64]], [[64, 64, 128], [64, 96, 128]],
              [[128, 196, 256], [128, 196, 256]], [[256, 256, 512], [256, 384, 512]])
BN_CONFIGS = (("car", (4096, 1024, 256, 64), 16384), ("car-2x", (8192, 2048, 512, 128), 32768))
BN_NSAMPLES = (16, 32)
BN_FP_MLPS = ([512, 512], [512, 512], [256, 256], [128, 128])
# kernel against plain version: the backward's coefficients come from f64
# sums in another order, rounded to f32 (an ulp apart at most); the
# statistics and element-wise outputs from the same f32 operations
BN_STATS_REL_TOL = 1e-6


def bn_train_layers():
    """(name, rows, C, K, rd) of every BN layer of both configs' rpn step:
    K > 0 at the last layer of an SA stack (the max over K), rd bf16 where
    the output is the next layer's bf16 operand, else None."""
    out = []
    for cfg, npoints, n_pts in BN_CONFIGS:
        for st, (S, mlps) in enumerate(zip(npoints, BN_SA_MLPS)):
            for scale, (K, widths) in enumerate(zip(BN_NSAMPLES, mlps)):
                for i, c in enumerate(widths):
                    last = i == len(widths) - 1
                    out.append((f"{cfg} SA{st + 1}.{scale} layer {i}", BN_TRAIN_BATCH * S * K, c,
                                K if last else 0, None if last else torch.bfloat16))
        levels = (npoints[2], npoints[1], npoints[0], n_pts)
        for j, (n, widths) in enumerate(zip(levels, BN_FP_MLPS)):
            for i, c in enumerate(widths):
                out.append((f"{cfg} FP{j + 1} layer {i}", BN_TRAIN_BATCH * n, c, 0,
                            torch.bfloat16 if i < len(widths) - 1 else None))
    return out


def _bn_rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def check_bn_train():
    """The four kernels of ops/cuda_bn.py at every BN layer of the rpn step
    of both configs at batch 16, each against its plain version on the card
    from the same inputs: the statistics and running statistics (the same
    reductions, then the finalize) and the element-wise outputs
    (apply, max and tie count, dy) equal, the backward's sums and
    coefficients within BN_STATS_REL_TOL (f64 sums in another order).  Device
    ms by graph replay, bound = bytes over 3.35 TB/s -> a Tally a kernel.
    ``bn_train_stats`` is PyTorch's two reductions (``y.mean``,
    ``(y * y).mean``: four passes over y) and the finalize kernel; its bound
    is one read of y, what a one-pass statistics kernel would need."""
    from pointrcnn_tpu_torch.ops import cuda_bn

    tallies = {k: Tally() for k in ("bn_train_stats", "bn_train_apply", "bn_train_bwd_sums",
                                    "bn_train_bwd_apply")}
    tallies["bn_train_stats"].notes["work"] = (
        "PyTorch's y.mean and (y * y).mean (four passes over y) and the finalize kernel; "
        "bound: one read of y")
    for name, rows, C, K, rd in bn_train_layers():
        g = torch.Generator(device="cuda").manual_seed(rows + C)
        mu = torch.randn(C, device="cuda", generator=g)
        sd = torch.rand(C, device="cuda", generator=g) * 2 + 0.1
        y = torch.randn((rows, C), device="cuda", generator=g) * sd + mu
        if K:
            # a ball query's padding: the first neighbour repeated, so maxima tie
            y.view(-1, K, C)[:, K // 2:] = y.view(-1, K, C)[:, :1]
        scale = torch.rand(C, device="cuda", generator=g) + 0.5
        bias = torch.randn(C, device="cuda", generator=g) * 0.3
        run = [torch.rand(C, device="cuda", generator=g) for _ in range(2)]
        groups = rows // K if K else rows
        gin = torch.randn((groups, C), device="cuda", generator=g)
        r1, r2 = run[0].clone(), run[1].clone()
        st = cuda_bn.layer_stats(y, scale, r1, r2, 0.1, 1)
        n = float(rows)
        ref = cuda_bn.stats_finalize_plain(*cuda_bn.moments(y, 1), 0.1, n / (n - 1), scale,
                                           run[0], run[1])
        # the statistics and running update are the plain version's bit for bit
        if not (torch.equal(st, ref) and torch.equal(r1, run[0]) and torch.equal(r2, run[1])):
            raise AssertionError(f"bn_train {name}: statistics off the plain version by "
                                 f"{max(_bn_rel(st[i], ref[i]) for i in range(4)):.3e}")
        if K:
            (out, cnt), (out_p, cnt_p) = (cuda_bn.layer_apply(y, st, bias, K=K),
                                          cuda_bn.apply_max_plain(y, K, st, bias))
            same = torch.equal(out, out_p) and torch.equal(cnt, cnt_p)
            tied = (cnt[out > 0] >= 2).float().mean().item()
        else:
            out, out_p = cuda_bn.layer_apply(y, st, bias, rd), \
                cuda_bn.apply_plain(y, st, bias, rd)
            same, cnt, tied = torch.equal(out, out_p), None, 0.0
        if not same:
            raise AssertionError(f"bn_train {name}: apply differs from its plain version")
        extra = (K, out, cnt) if K else ()
        (ds, db), coef = cuda_bn.layer_bwd_sums(y, gin, st, bias, rd, 1, *extra)
        sums = cuda_bn.bwd_sums_plain(y, gin, st, bias, rd, *extra)
        ds_p, db_p = cuda_bn.bwd_grads_plain(sums, st)
        coef_p = cuda_bn.bwd_finalize_plain(sums, st, rows)
        err = max(_bn_rel(ds, ds_p), _bn_rel(db, db_p),
                  *(_bn_rel(coef[i], coef_p[i]) for i in range(3)))
        if not err <= BN_STATS_REL_TOL:
            raise AssertionError(f"bn_train {name}: backward sums off the plain version by "
                                 f"{err:.3e}")
        dy = cuda_bn.layer_bwd_apply(y, gin, st, bias, coef, rd, *extra)
        dy_p = cuda_bn.bwd_apply_plain(y, gin, st, bias, coef, rd, *extra)
        if not torch.equal(dy, dy_p):
            raise AssertionError(f"bn_train {name}: dy off its plain version by "
                                 f"{_bn_rel(dy, dy_p):.3e}")
        side = nbytes(out, cnt) if K else 0
        cases = {
            "bn_train_stats": (lambda: cuda_bn.layer_stats(y, scale, r1, r2, 0.1, 1),
                               lambda: cuda_bn.stats_finalize_plain(
                                   *cuda_bn.moments(y, 1), 0.1, n / (n - 1), scale, run[0],
                                   run[1]), nbytes(y)),
            "bn_train_apply": ((lambda: cuda_bn.layer_apply(y, st, bias, K=K)) if K else
                               (lambda: cuda_bn.layer_apply(y, st, bias, rd)),
                               (lambda: cuda_bn.apply_max_plain(y, K, st, bias)) if K else
                               (lambda: cuda_bn.apply_plain(y, st, bias, rd)),
                               nbytes(y, out, cnt)),
            "bn_train_bwd_sums": (lambda: cuda_bn.layer_bwd_sums(y, gin, st, bias, rd, 1,
                                                                 *extra),
                                  lambda: cuda_bn.bwd_sums_plain(y, gin, st, bias, rd,
                                                                 *extra),
                                  nbytes(y, gin) + side),
            "bn_train_bwd_apply": (lambda: cuda_bn.layer_bwd_apply(y, gin, st, bias, coef,
                                                                   rd, *extra),
                                   lambda: cuda_bn.bwd_apply_plain(y, gin, st, bias, coef,
                                                                   rd, *extra),
                                   nbytes(y, gin, dy) + side),
        }
        line = []
        for kname, (fn, plain, nb) in cases.items():
            ms, dev, pl = cuda_ms(fn, 3), graph_ms(fn, 5), cuda_ms(plain, 1)
            b = tallies[kname].add(ms, pl, nb, 0.0, PEAK_F32_PER_MS, device_ms=dev)
            tallies[kname].shapes.append({"shape": name, "rows": rows, "C": C, "K": K,
                                          "bytes": nb, "ms": ms, "device_ms": dev,
                                          "bound_ms": b, "bound_by": "bytes"})
            line.append(f"{kname[9:]} {dev:.4f} ms (bound {b:.4f}, plain {pl:.3f})")
        for t in ("bn_train_bwd_sums", "bn_train_bwd_apply"):
            tallies[t].err = max(tallies[t].err, err)
        log(f"bn_train {name}: rows {rows} C {C} K {K}: bwd sums {err:.2e} of the "
            f"plain version; statistics, running statistics, apply, dy equal"
            f"{f', {tied:.2f} of positive maxima tied' if K else ''}; "
            + "; ".join(line))
        del y, gin, out, out_p, dy, dy_p
    for kname, t in tallies.items():
        log(f"bn_train {kname}: device {t.device_ms:.3f} ms over both configs' layers, bound "
            f"{t.bound_ms:.3f} ms (bytes), share of the bound {t.bound_ms / t.device_ms:.3f}")
    return tallies


# ROADMAP C12: the shipped configs whose SA stacks the card must admit
# each shipped config, and default.yaml without RPN features in the RCNN
# (``RCNN.USE_RPN_FEATURES`` False: SA1 takes 3 + 130 channels)
# (a name: that override list of pointrcnn_tpu_torch.entry)
SHIPPED_CONFIGS = (("default.yaml", ()), ("people.yaml", ()), ("car_2x.yaml", ()),
                   ("default.yaml", ("RCNN.USE_RPN_FEATURES", "False")),
                   ("default.yaml", "WIDE_OVERRIDES"), ("car_2x.yaml", "EXACT_OVERRIDES"),
                   ("default.yaml", "DEEP_K_OVERRIDES"))


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
            yield (f"RPN SA{k + 1}.{i}", getattr(sa, f"SharedMLP_{i}"), n, sa.sampler[0].npoint, ns,
                   BATCH, False)
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
    from pointrcnn_tpu_torch import entry
    from pointrcnn_tpu_torch.config import load_config
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
    from pointrcnn_tpu_torch.ops import cuda_mlp

    for cfg_file, overrides in SHIPPED_CONFIGS:
        named = isinstance(overrides, str)
        cfg_name = f"{cfg_file} + {overrides}" if named else " ".join((cfg_file,) + overrides)
        overrides = getattr(entry, overrides) if named else overrides
        cfg = load_config(os.path.join(REPO, "cfgs", cfg_file), list(overrides))
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
            before = kernel_counts.read()
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
            after = kernel_counts.read()
            launched = tuple(after[k] - before[k]
                             for k in ("fused_group_mlp_max", "fused_group_mlp_backward"))
            if launched != (1, int(train)) or not torch.isfinite(out).all():
                raise AssertionError(f"{cfg_name} {name}: launches (K2, K7) {launched}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            widths = tuple(getattr(mlp, f"w{j}").shape[1] for j in range(mlp.n))
            admitted.append(name)
            log(f"{cfg_name} {name} B={B} N={n} C={C} S={S} K={K} {widths}: admitted, K2"
                f"{' and K7' if train else ''} launched")
        log(f"{cfg_name}: every fused stage admitted ({len(admitted)}: {', '.join(admitted)})")
        del model


# The shapes past the kernels' first plans (ROADMAP C12), each held to its
# plain version on the card.  K2 + K7 (name, B, N, C, S, K, widths, mode):
# one-layer stacks (hilo; fold at K 128: WIDE_OVERRIDES' RCNN SA1), K 128 at
# three layers (a resident plan of 128-row tiles), WIDE_OVERRIDES' RCNN SA2
# (five layers up to 640 wide, K 128: the global plans, weights past shared
# memory), a stack whose forward streams a layer while its backward takes the
# global plan, and mode "none" (use_xyz False); then the shapes of path K
# (entry.DEEP_K_OVERRIDES: a centroid over 2, 4 or 8 tiles of 128 rows; K7
# at 256 only, the TPU backward predicate's reach, the forward alone past
# it), one layer at K 256, 17 and 40 layers (the layer table), and layer 0
# past shared memory (1536 wide at K 64, 768 at K 128: the global plan's
# gathered rows in its scratch)
LIMIT_MLP_SHAPES = (
    ("one layer", 16, 128, 128, 32, 64, (128,), "hilo"),
    ("W RCNN SA1, one layer", 4 * 64, 512, 128, 128, 128, (128,), "fold"),
    ("K 128, three layers", 64, 512, 128, 128, 128, (128, 128, 128), "fold"),
    ("streamed forward, global backward", 16, 256, 128, 64, 32, (128, 256, 256), "hilo"),
    ("use_xyz False", 16, 256, 64, 64, 32, (64, 128), "none"),
    ("RCNN SA2", 4 * 64, 128, 128, 32, 64, (128, 128, 256), "hilo"),
    ("W RCNN SA2, five layers", 4 * 64, 128, 128, 32, 128, (128, 256, 256, 512, 640), "hilo"),
    ("K RCNN SA1", 4 * 64, 512, 128, 128, 256, (128, 128, 128), "fold"),
    ("K 256 hilo", 64, 512, 128, 128, 256, (128, 128, 256), "hilo"),
    ("K 256, one layer", 64, 512, 128, 128, 256, (128,), "fold"),
    ("K 200, one layer", 64, 512, 128, 128, 200, (64,), "hilo"),
    ("K RCNN SA2", 4 * 100, 128, 128, 32, 512, (128, 128, 256), "hilo"),
    ("K 512 fold", 64, 256, 128, 32, 512, (128, 128, 128), "fold"),
    ("K 1024 fold", 32, 512, 128, 32, 1024, (128, 128, 128), "fold"),
    ("K 1024 hilo", 32, 512, 128, 32, 1024, (128, 128, 256), "hilo"),
    ("17 layers", 16, 256, 32, 64, 32, (32,) * 16 + (64,), "hilo"),
    ("40 layers", 8, 256, 16, 64, 16, (32,) * 40, "fold"),
    ("wide layer 0", 16, 256, 64, 64, 64, (1536, 128), "hilo"),
    ("wide layer 0, one layer", 16, 256, 64, 64, 64, (1536,), "fold"),
    ("wide layer 0, K 128", 16, 256, 64, 32, 128, (768, 64), "fold"),
)
# the shapes whose K7 is held on exact data (_exact_mlp_case): on random data
# the departure from the plain version compounds through the layers (five
# layers at K 128, H100: db4 1.3e-3, dw4 3.4e-3 ... dtable 7.5e-3 of the norm,
# smoothly from the last layer down; three layers at K 128: 2.6e-3, at K 64
# 1.5e-3), past MLP_BWD_REL_TOL, calibrated on three-layer stacks.  It is
# logged there, and K7 is held to the bound where both sides compute the
# same activations
LIMIT_EXACT_BWD = ("W RCNN SA2, five layers", "K RCNN SA1", "K 256, one layer", "17 layers",
                   "40 layers")
# the shapes whose first plans keep activations or weights in shared memory
# (resident, 128-row centroids, a streamed forward layer, the default RCNN
# SA2): the global plan must give the same forward and per-row gradients
LIMIT_PLAN_EQUAL = ("K 128, three layers", "streamed forward, global backward", "RCNN SA2",
                    "K RCNN SA1", "K 256, one layer", "K RCNN SA2", "K 1024 hilo", "17 layers")
# K1 (name, B, N, npoint): car_2x's RPN SA1 in the exact setting (a cluster
# of 2 blocks a row), rows for clusters of 4 and 8, and a row past a
# cluster's reach (the global-memory kernel)
LIMIT_FPS_SHAPES = (("X RPN SA1", 4, 32768, 8192), ("cluster of 4", 2, 40000, 300),
                    ("cluster of 8", 1, 100000, 200), ("global memory", 1, 140000, 200))
# K4 + K8 (name, B, N, C, S, K): RPN SA4 of WIDE_OVERRIDES' rpn step, 3 + 1024
# channels
LIMIT_GATHER_SHAPES = (("W RPN SA4", TRAIN_BATCH, 256, 1024, 64, 16),
                       ("W RPN SA4", TRAIN_BATCH, 256, 1024, 64, 32))


def _check_exact_bwd(name, fold, xyz, idx, ops, ct):
    """K2 and K7 on _exact_mlp_case's operands: the forward equal to the
    plain version's, K7 deterministic, no dropped tie, each output within
    MLP_BWD_REL_TOL of the plain version in norm."""
    from pointrcnn_tpu_torch.ops import cuda_mlp

    table, cent, w0x, ws, bs = ops
    N, K = table.shape[1], idx.shape[2]
    idx_p = cuda_mlp.pad_idx(idx, N)
    out = cuda_mlp._launch(fold, table, xyz, cent, w0x, ws, bs, idx_p, checked=True)
    ref = cuda_mlp.fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
    if not torch.equal(out, ref):
        raise AssertionError(f"fused mlp {name} (exact data): {(out != ref).sum().item()} "
                             f"maxima differ from the plain version")
    bwd = lambda: cuda_mlp._launch_bwd(fold, table, xyz, cent, w0x, ws, bs, idx_p, K, out, ct)
    got, again = bwd(), bwd()
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(_named(got), _named(again))):
        raise AssertionError(f"mlp backward {name} (exact data): two launches differ")
    torch.cuda.synchronize()
    if cuda_mlp.nomatch_count():
        raise AssertionError(f"mlp backward {name} (exact data): maxima found no match")
    bref = cuda_mlp.fused_group_backward_plain(fold, table, xyz, cent, w0x, ws, bs, idx, ref, ct)
    rels = {what: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for (what, a), (_, b) in zip(_named(got), _named(bref))}
    log(f"mlp backward {name} (exact data): forward equal to the plain version, deterministic, "
        f"no dropped tie; each output's departure in norm: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    for what, rel in rels.items():
        if not rel <= MLP_BWD_REL_TOL:
            raise AssertionError(f"mlp backward {name} (exact data): {what} off the plain version "
                                 f"by {rel:.3e} of its norm")


def _limit_mlp_case(B, N, C, S, K, widths, mode, seed):
    from pointrcnn_tpu_torch.models.layers import xavier_normal
    from pointrcnn_tpu_torch.ops import cuda_mlp

    g = torch.Generator().manual_seed(seed)
    xyz = _roi_cloud(B, N, seed)
    feats = torch.relu(torch.randn((B, N, C), generator=g)).cuda()
    new_xyz = xyz[:, :S].contiguous()
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]  # the ball query's backfill
    idx = idx.cuda()
    ws, bs, cin = [], [], (3 if mode != "none" else 0) + C
    for f in widths:
        ws.append(xavier_normal(cin, f, g).cuda())
        bs.append((torch.randn(f, generator=g) * 0.1).cuda())
        cin = f
    fold = mode != "hilo"
    ops = cuda_mlp.prepare_operands(fold, xyz, feats, new_xyz, ws, bs, mode != "none")
    ct = torch.randn((B, S, ops[3][-1].shape[1] if len(ws) > 1 else ops[0].shape[2]),
                     generator=g).cuda()
    return fold, xyz, idx, ops, ct


def check_port_limits():
    """K2 and K7, K1, K4 and K8 at the shapes their first plans refused
    (ROADMAP C12), each against its plain version on the card, each timed
    with its bound -> {kernel: [per-shape rows]}."""
    rows = {"fused_group_mlp_max": [], "fused_group_mlp_backward": [], "fps": [],
            "group_gather": [], "gather_backward": []}
    check_limit_fps(rows)
    check_limit_gather(rows)
    check_limit_mlp(rows)
    check_limit_grid()
    return rows


def _exact_mlp_case(B, N, C, S, K, widths, mode, seed):
    """Operands on which every forward sum is exact in f32 whatever its
    order: small integer features, coordinates and cotangents, weights in
    {-1, 0, 1} (nine in ten 0) and integer biases, so the kernel and the
    plain version compute the same activations, take the same maxima and
    ties (many: integer activations tie often) and apply the same ReLU
    masks; only the backward's own bf16 products then sum in another order."""
    from pointrcnn_tpu_torch.ops import cuda_mlp

    g = torch.Generator().manual_seed(seed)
    ints = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g).float()
    xyz = ints(-8, 9, (B, N, 3)).cuda()
    feats = ints(0, 4, (B, N, C)).cuda()
    new_xyz = xyz[:, :S].contiguous()
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    idx = idx.cuda()
    ws, bs, cin = [], [], (3 if mode != "none" else 0) + C
    for f in widths:
        w = ints(-1, 2, (cin, f)) * (torch.rand((cin, f), generator=g) < 0.1)
        ws.append(w.cuda())
        bs.append(ints(-2, 3, (f,)).cuda())
        cin = f
    fold = mode != "hilo"
    ops = cuda_mlp.prepare_operands(fold, xyz, feats, new_xyz, ws, bs, mode != "none")
    ct = ints(-4, 5, (B, S, ops[3][-1].shape[1] if len(ws) > 1 else ops[0].shape[2])).cuda()
    return fold, xyz, idx, ops, ct


def check_limit_mlp(rows):
    """K2 within MLP_REL_TOL of the output's scale, K7 deterministic with no
    dropped tie and each output within MLP_BWD_REL_TOL of the plain version
    in norm; the global plan's bits equal to the first plan's where both
    exist."""
    from pointrcnn_tpu_torch.ops import cuda_mlp

    cuda_mlp.reset_nomatch()
    for name, B, N, C, S, K, widths, mode in LIMIT_MLP_SHAPES:
        fold, xyz, idx, ops, ct = _limit_mlp_case(B, N, C, S, K, widths, mode, N + K + B)
        if name in LIMIT_EXACT_BWD:
            _check_exact_bwd(name, *_exact_mlp_case(B, N, C, S, K, widths, mode, N + K))
        table, cent, w0x, ws, bs = ops
        idx_p = cuda_mlp.pad_idx(idx, N)
        fwd = lambda: cuda_mlp._launch(fold, table, xyz, cent, w0x, ws, bs, idx_p, checked=True)
        out = fwd()
        ref = cuda_mlp.fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
        scale, e = ref.abs().max().item(), (out - ref).abs().max().item()
        if not (torch.isfinite(out).all() and e <= MLP_REL_TOL * scale):
            raise AssertionError(f"fused mlp {name}: max err {e} vs scale {scale}")
        k = cuda_ms(fwd, 5)
        p = cuda_ms(lambda: cuda_mlp.fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx),
                    1)
        f0p = table.shape[2]
        pw = [f0p] + [w.shape[1] for w in ws]
        macs = (0 if fold else 3 * f0p) + sum(a * b for a, b in zip(pw, pw[1:]))
        ops_n = 2.0 * B * S * K * macs
        nb = nbytes(table, None if fold else xyz, cent, w0x, *ws, *bs, idx, out)
        b_ms, term = bound(nb, ops_n, PEAK_BF16_PER_MS)
        rows["fused_group_mlp_max"].append(
            {"shape": name, "b": B, "n": N, "c": C, "s": S, "k": K, "widths": list(widths),
             "mode": mode, "max_abs_err": e, "ms": k, "plain_ms": p, "bound_ms": b_ms,
             "bound_by": term})
        log(f"fused mlp {name} B={B} N={N} C={C} S={S} K={K} {widths} {mode}: max err {e:.3e} "
            f"(scale {scale:.3e}); kernel {k:.4f} ms, plain {p:.4f} ms, bound {b_ms:.4f} ms; "
            f"{_rate(ops_n, k, b_ms)}")
        if cuda_mlp.padded_k(K) > cuda_mlp._MAX_KP_BWD:
            # the TPU backward predicate refuses K past 256: the forward alone
            if name in LIMIT_PLAN_EQUAL:
                with cuda_mlp.global_plan():
                    g_out = fwd()
                if not torch.equal(g_out, out):
                    raise AssertionError(f"fused mlp {name}: the global plan's forward differs")
                log(f"fused mlp {name}: the global plan gives the same bits forward")
                del g_out
            del out
            continue
        bwd = lambda: cuda_mlp._launch_bwd(fold, table, xyz, cent, w0x, ws, bs, idx_p, K, out, ct)
        got, again = bwd(), bwd()
        if not all(torch.equal(a, b) for (_, a), (_, b) in zip(_named(got), _named(again))):
            raise AssertionError(f"mlp backward {name}: two launches differ")
        torch.cuda.synchronize()
        nomatch = cuda_mlp.nomatch_count()
        if nomatch:
            raise AssertionError(f"mlp backward {name}: {nomatch} maxima found no match")
        plain_out = cuda_mlp.fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
        bref = cuda_mlp.fused_group_backward_plain(fold, table, xyz, cent, w0x, ws, bs, idx,
                                                   plain_out, ct)
        worst = err = 0.0
        rels = {}
        for (what, a), (_, b) in zip(_named(got), _named(bref)):
            rels[what] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            worst, err = max(worst, rels[what]), max(err, (a - b).abs().max().item())
        log(f"mlp backward {name}: each output's departure from the plain version in norm: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + (" (random data; held on exact data above)" if name in LIMIT_EXACT_BWD else ""))
        for (what, a), _ in zip(_named(got), _named(bref)):
            if not torch.isfinite(a).all() or (name not in LIMIT_EXACT_BWD
                                               and rels[what] > MLP_BWD_REL_TOL):
                raise AssertionError(f"mlp backward {name}: {what} off the plain version by "
                                     f"{rels[what]:.3e} of its norm")
        if name in LIMIT_PLAN_EQUAL:
            # the forward and every per-row output (the table, xyz and
            # centroid gradients) bit for bit; the parameter gradients sum
            # the blocks' partials, whose tiles follow the grid, which the
            # plans' shared memory sets: equal up to that order
            with cuda_mlp.global_plan():
                g_out = fwd()
                g_got = bwd()
            if not torch.equal(g_out, out):
                raise AssertionError(f"fused mlp {name}: the global plan's forward differs")
            for (what, a), (_, b) in zip(_named(g_got), _named(got)):
                if what in ("dtable", "dxyz", "dcent"):
                    ok = torch.equal(a, b)
                else:
                    ok = ((a - b).norm() <= 1e-5 * b.norm()).item()
                if not ok:
                    raise AssertionError(f"fused mlp {name}: the global plan's {what} differs")
            log(f"fused mlp {name}: the global plan gives the same bits forward and in the "
                f"per-row gradients, the parameter gradients within 1e-5 in norm")
            del g_out, g_got
        kb = cuda_ms(bwd, 3)
        pb = cuda_ms(lambda: cuda_mlp.fused_group_backward_plain(
            fold, table, xyz, cent, w0x, ws, bs, idx, plain_out, ct), 1)
        del bref, plain_out
        ops_b = 2.0 * B * S * K * 3 * sum(a * b for a, b in zip(pw, pw[1:]))
        nb_b = nbytes(table, None if fold else xyz, cent, w0x, *ws, *bs, idx, out, ct,
                      *(t for _, t in _named(got)))
        bb_ms, bterm = bound(nb_b, ops_b, PEAK_BF16_PER_MS)
        rows["fused_group_mlp_backward"].append(
            {"shape": name, "b": B, "n": N, "c": C, "s": S, "k": K, "widths": list(widths),
             "mode": mode, "worst_norm_rel": worst, "max_abs_err": err, "ms": kb,
             "plain_ms": pb, "bound_ms": bb_ms, "bound_by": bterm})
        log(f"mlp backward {name}: deterministic, no dropped tie, worst {worst:.3e} of the plain "
            f"version's norm (tol {MLP_BWD_REL_TOL}); kernel {kb:.4f} ms, plain {pb:.4f} ms, "
            f"bound {bb_ms:.4f} ms")
        del got, again, out


# the grid over which K2 and K7 must take every shape the TPU predicates
# admit: K (padded to 16 .. 1024; 200 pads to 256), depth (layers of 32 after
# layer 0) and layer 0's width, hilo and fold in turn, at B 2, N 64, S 8
LIMIT_GRID_K = (16, 32, 64, 128, 200, 256, 512, 1024)
LIMIT_GRID_DEPTH = (1, 2, 17, 40)
LIMIT_GRID_F0 = (16, 144, 768, 1536)


def check_limit_grid():
    """Every (K, depth, width) of the grid that the TPU predicates admit
    (``cuda_mlp.fused_group_mlp_max_supported`` / ``fused_group_bwd_supported``,
    their twins) launches K2, and K7 where the backward predicate admits it:
    the forward within MLP_REL_TOL of its plain version, K7 finite and
    deterministic with no dropped tie.  A refusal fails the run."""
    from pointrcnn_tpu_torch.ops import cuda_mlp

    B, N, C, S = 2, 64, 16, 8
    n_fwd = n_bwd = 0
    worst = 0.0
    t0 = time.perf_counter()
    cuda_mlp.reset_nomatch()
    for i, (K, depth, f0) in enumerate((K, d, f) for K in LIMIT_GRID_K for d in LIMIT_GRID_DEPTH
                                       for f in LIMIT_GRID_F0):
        widths = (f0,) + (32,) * (depth - 1)
        mode = ("hilo", "fold")[i % 2]
        feats, kidx = torch.empty((B, N, C)), torch.empty((B, S, K), dtype=torch.int32)
        if not cuda_mlp.fused_group_mlp_max_supported(feats, kidx, torch.bfloat16):
            continue
        fold, xyz, idx, ops, ct = _limit_mlp_case(B, N, C, S, K, widths, mode, i)
        table, cent, w0x, ws, bs = ops
        what = f"fused mlp grid K={K} depth {depth} layer 0 {f0} {mode}"
        try:
            idx_p = cuda_mlp.pad_idx(idx, N)
            out = cuda_mlp._launch(fold, table, xyz, cent, w0x, ws, bs, idx_p, checked=True)
            ref = cuda_mlp.fused_group_plain(fold, table, xyz, cent, w0x, ws, bs, idx)
            e, scale = (out - ref).abs().max().item(), ref.abs().max().item()
            if not (torch.isfinite(out).all() and e <= MLP_REL_TOL * max(scale, 1e-30)):
                raise AssertionError(f"{what}: max err {e} vs scale {scale}")
            worst = max(worst, e / max(scale, 1e-30))
            n_fwd += 1
            if cuda_mlp.fused_group_bwd_supported(feats, kidx):
                bwd = lambda: cuda_mlp._launch_bwd(fold, table, xyz, cent, w0x, ws, bs, idx_p, K,
                                                   out, ct)
                got, again = bwd(), bwd()
                if not all(torch.equal(a, b) and torch.isfinite(a).all()
                           for (_, a), (_, b) in zip(_named(got), _named(again))):
                    raise AssertionError(f"{what}: the backward is not finite or deterministic")
                n_bwd += 1
        except (ValueError, RuntimeError) as e:
            raise AssertionError(f"{what}: refused or failed on the card: {e}") from e
    torch.cuda.synchronize()
    if cuda_mlp.nomatch_count():
        raise AssertionError(f"fused mlp grid: {cuda_mlp.nomatch_count()} maxima found no match")
    log(f"fused mlp grid: K {LIMIT_GRID_K} x depth {LIMIT_GRID_DEPTH} x layer 0 "
        f"{LIMIT_GRID_F0}: every shape the TPU predicates admit taken, {n_fwd} forwards (worst "
        f"{worst:.3e} of the output's scale) and {n_bwd} backwards (deterministic, no dropped "
        f"tie); {time.perf_counter() - t0:.1f} s")


def check_limit_fps(rows):
    """K1 torch.equal to its plain version over rows past 16384 points."""
    from pointrcnn_tpu_torch.ops import cuda_fps

    t_step = fps_step_ms()
    for name, B, N, npoint in LIMIT_FPS_SHAPES:
        xyz = _rpn_cloud(B, N, N)
        got = cuda_fps._launch(xyz, npoint)
        ref = cuda_fps.furthest_point_sample_plain(xyz, npoint)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps {name} {B}x{N}->{npoint}: {(got != ref).sum().item()} "
                                 f"picks differ")
        k = cuda_ms(lambda: cuda_fps._launch(xyz, npoint), 2)
        p = cuda_ms(lambda: cuda_fps.furthest_point_sample_plain(xyz, npoint), 1)
        b_ms, term = bound(nbytes(xyz, got), 10.0 * B * (npoint - 1) * N, PEAK_F32_PER_MS,
                           (npoint - 1) * t_step)
        rows["fps"].append({"shape": name, "b": B, "n": N, "npoint": npoint, "ms": k,
                            "plain_ms": p, "bound_ms": b_ms, "term": term,
                            "step_us": 1000 * k / (npoint - 1)})
        log(f"fps {name} {B}x{N}->{npoint}: equal to the plain version; kernel {k:.4f} ms "
            f"({1000 * k / (npoint - 1):.3f} us a step), plain {p:.4f} ms, bound {b_ms:.4f} ms "
            f"({term}; probe step {1000 * t_step:.4f} us)")


def check_limit_gather(rows):
    """K4 torch.equal to its plain version at 3 + 1024 channels, K8
    deterministic and equal to the CPU plain version."""
    from pointrcnn_tpu_torch.ops import cuda_gather

    for name, B, N, C, S, K in LIMIT_GATHER_SHAPES:
        xyz, feats, cent, idx, ct_cpu = _gather_case(B, N, C, S, K, 11 * N + K)
        fwd = _gather_equal(f"{name} 3 + {C} channels K={K}", xyz, feats, cent, idx)
        kf = cuda_ms(lambda: cuda_gather._launch(xyz, feats, cent, idx), 10)
        pf = cuda_ms(lambda: cuda_gather.group_points_plain(xyz, feats, cent, idx), 3)
        nbf = nbytes(xyz, feats, cent, idx, fwd)
        rows["group_gather"].append({"shape": name, "b": B, "n": N, "c": C, "s": S, "k": K,
                                     "ms": kf, "plain_ms": pf,
                                     "bound_ms": nbf / PEAK_BYTES_PER_MS, "bound_by": "bytes"})
        got, ct = _check_bwd_case(f"{name} 3 + {C} channels K={K}", idx, ct_cpu, N)
        run = lambda: cuda_gather._launch_bwd(idx, ct, N)
        kb = cuda_ms(run, 10)
        pb = cuda_ms(lambda: cuda_gather.group_points_backward_plain(idx, ct, N), 3)
        rws = (idx.long() + torch.arange(B, device="cuda")[:, None, None] * N).reshape(-1)
        src, acc = ct.reshape(-1, 3 + C).float(), torch.zeros((B * N, 3 + C), device="cuda")
        lib = cuda_ms(lambda: acc.index_add_(0, rws, src), 10)
        b_ms, term = bound(nbytes(idx, ct, *got), float(ct.numel()), PEAK_F32_PER_MS)
        rows["gather_backward"].append({"shape": name, "b": B, "n": N, "c": C, "s": S, "k": K,
                                        "ms": kb, "plain_ms": pb, "library_ms": lib,
                                        "bound_ms": b_ms, "bound_by": term})
        log(f"gather {name} B={B} N={N} 3 + {C} channels S={S} K={K}: K4 equal to the plain "
            f"version, {kf:.4f} ms (plain {pf:.4f}); K8 deterministic, equal to the CPU plain "
            f"version, {kb:.4f} ms, plain {pb:.4f} ms, index_add_ {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms")


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
# false) on the sorted SA1 table; a ragged pool (W halves to 128, no fold);
# the striped AP gate's RPN SA2 (tests/cfgs_ap.yaml at 4096 points: 48
# neighbours, the kernels' path past 32)
BQ_SHAPES = (
    ("eval", "RPN SA1", BATCH, 16384, 4096, 16, 32, True, True),
    ("eval", "RPN SA2", BATCH, 4096, 1024, None, 32, False, None),
    ("rpn step", "RPN SA1", TRAIN_BATCH, 16384, 4096, 16, 32, True, True),
    ("rpn step", "RPN SA2", TRAIN_BATCH, 4096, 1024, None, 32, False, None),
    ("car_2x", "RPN SA1", BATCH, 32768, 8192, 16, 32, True, True),
    ("car_2x", "RPN SA2", BATCH, 8192, 2048, None, 32, False, None),
    ("guard false", "RPN SA1", BATCH, 16384, 4096, 16, 32, True, False),
    ("ragged", "pool 2176", 2, 2176, 256, None, 16, True, None),
    ("striped gate", "RPN SA2", BATCH, 2048, 512, None, 48, False, None),
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
    whose full-row branch folds from 512; the path past 32 neighbours on
    ties and on rows whose finite candidates run out."""
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
             ("duplicated points, k 128", dup, dup[:, :64], 128, True, None, None),
             ("lattice, S = 100", lat, on_lat, 32, True, None, None),
             ("NaN x in the centroids' classes", nan_class, tab[:, own], 16, True, None, None),
             ("NaN centroid", tab, nan_cent, 16, True, None, None),
             ("d2 overflows to inf", far, tab[:, own], 16, True, None, None),
             ("d2 overflows to inf, k 128", far, tab[:, own], 128, True, None, None)]
    xs_dup = dup[:, torch.argsort(dup[0, :, 2], stable=True)]
    xs_dup[1] = xs_dup[0]
    cases.append(("duplicated points, 4 bands", xs_dup, xs_dup[:, ::64], 32, True, 4, True))
    cases.append(("duplicated points, 4 bands, k 48", xs_dup, xs_dup[:, ::64], 48, True, 4, True))
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
    before = kernel_counts.read()["ball_query_banded"]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fps_group_banded(static, 4096, specs)
    if kernel_counts.read()["ball_query_banded"] != before + 1:
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
    kernel_counts.reset()
    with gather_feature_dtypes("eval"), banded_calls() as calls:
        outs = [fwd(model, {"pts_input": pts}) for pts in clouds]
        torch.cuda.synchronize()
    counts = kernel_counts.read()
    if [bool(call[4]) for call in calls] != [True] * len(clouds):
        raise AssertionError("the banded stage's thin-band flag did not read true on the "
                             "seeded clouds")
    log(f"default forward x{len(clouds)} launches: {counts}")
    for s, out in zip(CLOUD_SEEDS, outs):
        _check_outputs(out, cfg.TEST.RPN_POST_NMS_TOP_N, f"default, cloud {s}")
    for name in EVAL_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the default path")
    if counts["gather_backward"] or counts["ball_query_first_k"]:
        raise AssertionError("the eval forward launched the gather backward or the exact "
                             "ball query")
    launches.update(counts)

    thin = torch.from_numpy(thin_band_cloud(BATCH, cfg.RPN.NUM_POINTS, 9)).cuda()
    kernel_counts.reset()
    with banded_calls() as calls:
        out = fwd(model, {"pts_input": thin})
        torch.cuda.synchronize()
    counts = kernel_counts.read()
    log(f"thin-band cloud launches: {counts}")
    _check_outputs(out, cfg.TEST.RPN_POST_NMS_TOP_N, "default, thin-band cloud")
    check_thin_band(calls, counts)

    check_against_cpu(model, synthetic_cloud(1, cfg.RPN.NUM_POINTS, 5), "default")
    return _frames_per_s(fwd, model, clouds[0], "default")


# 3DSSD's eval step (pointrcnn_tpu_torch/cfgs/3dssd_car.yaml) a forward:
# D-FPS at SA1, SA2 (fusion) and SA3, F-FPS at SA2 and SA3, K2 at the nine
# SA scales and the two vote-aggregation scales, K10 at SA1-SA3 and the vote
# aggregation (every scale of a stage in one launch)
SSD3D_LAUNCHES = {"fps": 3, "ffps": 2, "fused_group_mlp_max": 11, "ball_query_first_k": 4}


def phase_ssd3d(card):
    """3DSSD's eval step at batch 4 x 16384 points on the card (K9 and K2 at
    their widths; frames/s), and a batch-1 forward against the port's CPU
    path: every index set equal, features, votes and head outputs within
    5% of their scale (K2 against its plain version, bf16 roundings in
    another order), the survivors of the same boxes equal."""
    from pointrcnn_tpu_torch import ssd3d_config
    from pointrcnn_tpu_torch.entry import synthetic_cloud
    from pointrcnn_tpu_torch.eval.evaluator import build_ssd3d_eval_step
    from pointrcnn_tpu_torch.models.ssd3d import SSD3D, postprocess

    cfg = ssd3d_config.load_config(os.path.join(REPO, "pointrcnn_tpu_torch", "cfgs",
                                                "3dssd_car.yaml"))
    model = SSD3D(cfg, torch.Generator().manual_seed(0)).cuda().eval()

    def frames(b, seed):
        xyz = torch.from_numpy(synthetic_cloud(b, cfg.NUM_POINTS, seed))
        inten = torch.rand((b, cfg.NUM_POINTS, 1), generator=torch.Generator().manual_seed(seed))
        return torch.cat([xyz, inten], -1)

    step = build_ssd3d_eval_step(model, cfg, with_gt=False)
    pts = frames(BATCH, 0).cuda()
    step(pts)
    torch.cuda.synchronize()
    kernel_counts.reset()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        out = step(pts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_ITERS
    counts = kernel_counts.read()
    want = {k: v * TIMED_ITERS for k, v in SSD3D_LAUNCHES.items()}
    if {k: counts[k] for k in want} != want or any(
            v for k, v in counts.items() if k not in want and k != "bn_train_plain"):
        raise AssertionError(f"3DSSD launches {counts}, expected {want} and nothing else")
    if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()):
        raise AssertionError("3DSSD step: non-finite outputs")
    log(f"3DSSD eval step at {BATCH} x {cfg.NUM_POINTS}: {ms:.2f} ms a batch "
        f"({BATCH * 1e3 / ms:.1f} frames/s), launches a step {SSD3D_LAUNCHES}; {card}")

    one = frames(1, 5)
    cpu = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu(one)
        got = {k: v for k, v in model(one.cuda()).items()}
    log(f"3DSSD batch-1 cpu comparison: {time.perf_counter() - t0:.1f} s")
    for k in ("sa1_sample_idx", "sa2_sample_idx", "sa3_sample_idx"):
        if not torch.equal(got[k].cpu(), ref[k]):
            raise AssertionError(f"3DSSD {k} differs from the CPU path")
    for k in ("sa1_query_idx", "sa2_query_idx", "sa3_query_idx", "agg_query_idx"):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got[k], ref[k])):
            raise AssertionError(f"3DSSD {k} differs from the CPU path")
    for k in ("sa1_features", "sa2_features", "sa3_features", "votes", "cls", "reg"):
        e = (got[k].cpu() - ref[k]).abs().max().item()
        scale = ref[k].abs().max().item()
        log(f"3DSSD vs cpu {k}: max err {e:.3e} (scale {scale:.3e})")
        if e > 0.05 * scale:
            raise AssertionError(f"3DSSD {k} differs from the CPU path by {e} (scale {scale})")
    post_cpu = postprocess(cfg, {k: got[k].cpu() for k in ("cls", "reg", "votes")})
    post_card = postprocess(cfg, {k: got[k] for k in ("cls", "reg", "votes")})
    for k in ("sel_idx", "sel_valid"):
        if not torch.equal(post_card[k].cpu(), post_cpu[k]):
            raise AssertionError(f"3DSSD post-process {k}: the card's differs from the CPU's")
    return {"ms": ms, "launches": counts}


def exact_query_launches(model) -> int:
    """K10's launches a forward of a model whose ball queries are all exact:
    one for each sampling SA stage's specs, up to FIRST_K_SPECS a launch."""
    from pointrcnn_tpu_torch.models.pointnet2 import SetAbstraction, SetAbstractionMSG
    from pointrcnn_tpu_torch.ops.cuda_ballquery import FIRST_K_SPECS

    return sum(-(-len(getattr(m, "specs", [None])) // FIRST_K_SPECS) for m in model.modules()
               if isinstance(m, SetAbstractionMSG) and m.sampler is not None
               or isinstance(m, SetAbstraction) and m.npoint is not None)


def phase_exact():
    """The exact-method setting (entry.EXACT_OVERRIDES), on one cloud."""
    from pointrcnn_tpu_torch.entry import entry, slice_config, synthetic_cloud

    fwd, (model, batch) = entry(batch=BATCH, device="cuda", seed=0, cfg=slice_config())
    kernel_counts.reset()
    out = fwd(model, batch)
    torch.cuda.synchronize()
    counts = kernel_counts.read()
    log(f"exact forward launches: {counts}")
    _check_outputs(out, model.cfg.TEST.RPN_POST_NMS_TOP_N, "exact, cloud 0")
    for name in ("fps", "three_nn", "group_gather", "fused_group_mlp_max"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the exact path")
    if counts["ball_query_first_k"] != exact_query_launches(model):
        raise AssertionError(f"exact forward: {counts['ball_query_first_k']} ball_query_first_k "
                             f"launches, expected {exact_query_launches(model)}")
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


def _train_against_cpu(cfg=None, batch_size=2, tag="train step"):
    """A train step's loss, gradient norm and gradients on the card against
    the port's CPU path, same weights and scene, dropout off: the rpn stage
    of ``cfg`` (default cfgs/default.yaml's) at ``batch_size`` frames."""
    from pointrcnn_tpu_torch.entry import rpn_config, train_entry
    from pointrcnn_tpu_torch.train.state import loss_and_grads

    cfg = rpn_config(["RPN.DP_RATIO", "0.0"]) if cfg is None else cfg
    _, (state, batch) = train_entry(batch=batch_size, device="cuda", seed=3, cfg=cfg)
    cpu_model = copy.deepcopy(state.model).cpu()
    t0 = time.perf_counter()
    cl, _, cg = loss_and_grads(cpu_model, cfg, {k: v.cpu() for k, v in batch.items()})
    log(f"{tag} vs cpu: cpu reference step {time.perf_counter() - t0:.1f} s")
    gl, _, gg = loss_and_grads(state.model, cfg, batch)
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())))
    card_norm = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in gg.values())))
    e_loss = abs(gl.item() / cl.item() - 1)
    e_norm = abs(card_norm / gnorm - 1)
    share = max(float((gg[k].cpu() - g).norm()) / gnorm for k, g in cg.items())
    log(f"{tag} vs cpu (batch {batch_size}, dropout off): loss {gl.item():.6f} vs "
        f"{cl.item():.6f} "
        f"(rel {e_loss:.2e}, tol {TRAIN_LOSS_RTOL}), grad norm {card_norm:.6f} vs {gnorm:.6f} "
        f"(rel {e_norm:.2e}, tol {TRAIN_GNORM_RTOL}), worst gradient leaf {share:.2e} of the "
        f"global norm (tol {TRAIN_LEAF_SHARE})")
    if e_loss > TRAIN_LOSS_RTOL or e_norm > TRAIN_GNORM_RTOL or share > TRAIN_LEAF_SHARE:
        raise AssertionError(f"the card's {tag} differs from the CPU path")


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
    kernel_counts.reset()
    t0 = time.perf_counter()
    with gather_feature_dtypes("train"):
        for _ in range(TRAIN_TIMED):
            state, tb = step(state, batch)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    counts = kernel_counts.read()
    peak = torch.cuda.max_memory_allocated()
    log(f"train batch {TRAIN_BATCH} x {batch['pts_input'].shape[1]} points: {1000 * dt:.3f} ms/step, "
        f"{TRAIN_BATCH / dt:.3f} frames/s ({TRAIN_TIMED} steps after {TRAIN_WARMUP} warm-up), "
        f"peak memory {peak / 2 ** 30:.3f} GiB")
    loss, gnorm = tb["loss"].item(), tb["grad_norm"].item()
    log(f"train launches over {TRAIN_TIMED} steps: {counts}; loss {loss:.6f}, grad norm "
        f"{gnorm:.6f}, foreground points {int(tb['rpn_fg_sum'])}")
    if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"train step: loss {loss}, grad norm {gnorm}")
    for name, n in RPN_STEP_LAUNCHES.items():
        if counts[name] != n * TRAIN_TIMED:
            raise AssertionError(f"train step: {name} launched {counts[name]} times in "
                                 f"{TRAIN_TIMED} steps, not {n} a step")
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


def _rcnn_against_cpu(rpn_ckpt, cfg=None, tag="rcnn step", batch_size=1):
    """A rcnn step (of ``cfg``, default cfgs/default.yaml's; batch 1 unless
    ``batch_size``) on the card against the port's CPU path: the same
    weights, the same target draws, and the card's RPN outputs handed to the
    CPU model (the RPN is fixed, and its eval forward is held to the CPU path
    in phase_default)."""
    from pointrcnn_tpu_torch.entry import train_entry
    from pointrcnn_tpu_torch.models.target import target_draws
    from pointrcnn_tpu_torch.train.state import loss_and_grads

    _, (state, batch) = train_entry(batch=batch_size, device="cuda", seed=5, cfg=cfg,
                                    stage="rcnn", rpn_ckpt=rpn_ckpt)
    model, cfg = state.model, state.model.cfg
    cpu_model = copy.deepcopy(model).cpu()
    seen = {}
    model.register_forward_hook(lambda m, a, o: seen.update(card=o))
    cpu_model.register_forward_hook(lambda m, a, o: seen.update(cpu=o))
    with torch.no_grad():
        rpn_out = model.rpn(batch["pts_input"])
    model.rpn.forward = lambda pts, generator=None: dict(rpn_out)
    cpu_model.rpn.forward = lambda pts, generator=None: {k: v.cpu() for k, v in rpn_out.items()}
    draws = target_draws(cfg, torch.Generator(device="cuda").manual_seed(11), batch_size,
                         cfg.TRAIN.RPN_POST_NMS_TOP_N, device="cuda")
    gl, gtb, gg = loss_and_grads(model, cfg, batch, targets=draws)
    t0 = time.perf_counter()
    cl, _, cg = loss_and_grads(cpu_model, cfg, {k: v.cpu() for k, v in batch.items()},
                               targets={k: v.cpu() for k, v in draws.items()})
    log(f"{tag} vs cpu: cpu reference step {time.perf_counter() - t0:.1f} s")
    for k in ("cls_label", "reg_valid_mask"):
        if not torch.equal(seen["card"][k].cpu(), seen["cpu"][k]):
            raise AssertionError(f"{tag} vs cpu: the target layer's {k} differs")
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())))
    card_norm = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in gg.values())))
    e_loss, e_norm = abs(gl.item() / cl.item() - 1), abs(card_norm / gnorm - 1)
    share = max(float((gg[k].cpu() - g).norm()) / gnorm for k, g in cg.items()
                if k.startswith("rcnn_net."))
    log(f"{tag} vs cpu (batch {batch_size}, {int(gtb['rcnn_cls_fg'])} fg / {int(gtb['rcnn_cls_bg'])} bg "
        f"rois, same decisions): loss {gl.item():.6f} vs {cl.item():.6f} (rel {e_loss:.2e}, tol "
        f"{RCNN_LOSS_RTOL}), grad norm {card_norm:.6f} vs {gnorm:.6f} (rel {e_norm:.2e}, tol "
        f"{RCNN_GNORM_RTOL}), worst RCNN gradient leaf {share:.2e} of the global norm "
        f"(tol {RCNN_LEAF_SHARE})")
    if e_loss > RCNN_LOSS_RTOL or e_norm > RCNN_GNORM_RTOL or share > RCNN_LEAF_SHARE:
        raise AssertionError(f"the card's {tag} differs from the CPU path")


def decayed(p, opt, steps):
    """``p`` after ``steps`` updates of the weight decay alone (a zero
    gradient: Adam's update is 0), p <- p - lr * (wd * p), in the
    optimizer's f32 arithmetic."""
    for count in range(steps):
        p = p + (-opt.lr(count) * (0.0 + opt.weight_decay * p))
    return p


def phase_rcnn_train(rcnn_launches, rpn_ckpt):
    """The rcnn training stage at batch 4 x 16384 points, the RPN from the
    rpn stage's checkpoint."""
    from pointrcnn_tpu_torch.entry import KITTI_TRAIN_FRAMES, TRAIN_EPOCHS, train_entry
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
    cuda_mlp.reset_nomatch()
    for _ in range(TRAIN_WARMUP):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    kernel_counts.reset()
    t0 = time.perf_counter()
    with gather_feature_dtypes("rcnn train"):
        for _ in range(TRAIN_TIMED):
            state, tb = step(state, batch)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    counts = kernel_counts.read()
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
    if counts["generic_grouped_train"] or cuda_mlp.nomatch_count():
        raise AssertionError(f"rcnn train step: {counts['generic_grouped_train']} SA stacks off "
                             f"the fused route, {cuda_mlp.nomatch_count()} dropped maxima")
    rcnn_launches.update(counts)

    after = model.state_dict()
    rcnn = [k for k, _ in model.named_parameters() if k.startswith("rcnn_net.")]
    still = [k for k in rcnn if torch.equal(after[k], before[k])]
    if still:
        raise AssertionError(f"rcnn train step: RCNN parameters unchanged: {still}")
    # the fixed RPN: the weight decay alone moves it; its BN statistics stay
    opt = build_optimizer(model.cfg, *steps_for(KITTI_TRAIN_FRAMES, RCNN_BATCH, TRAIN_EPOCHS))
    for k in rpn_params:
        if not torch.equal(after[k], decayed(before[k], opt, TRAIN_WARMUP + TRAIN_TIMED)):
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
IMG_W, IMG_H = 1242, 375
# a frame's points inside the image frustum and the range: more than the
# 16384 the dataset samples, so it samples without padding
FRAME_POINTS = 20000
# the post-process on the card against the CPU from the same outputs:
# refined boxes to 1e-5 of their largest magnitude, written numbers to 1e-4
POST_BOX_RTOL, POST_LINE_ATOL = 1e-5, 1e-4


def _box2d(box):
    """The projected 2D box and KITTI alpha of a 3D box for the fixture's
    calibration (rect == lidar frame; f = 700, principal point (600, 200))."""
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
    ground planes, a 1242 x 375 PNG, ``val`` and ``train`` splits listing
    every frame and a ``smallval`` split (``cfgs/default.yaml``'s
    ``TRAIN.VAL_SPLIT``) listing the first quarter.  Each frame: 2-4 cars
    at 10-40 m with 500 points on each, the rest ground and low clutter,
    all inside the image frustum and the point-cloud range -> the cars'
    boxes a frame."""
    from pointrcnn_tpu_torch.tools.fixture import CALIB_TXT, PLANE_TXT, png_bytes

    rng = np.random.RandomState(seed)
    training = os.path.join(root, "KITTI", "object", "training")
    for sub in ("velodyne", "calib", "label_2", "planes", "image_2"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "KITTI", "ImageSets"), exist_ok=True)
    png = png_bytes(IMG_W, IMG_H)
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
            f.write(CALIB_TXT)
        with open(os.path.join(training, "planes", sid + ".txt"), "w") as f:
            f.write(PLANE_TXT)
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
    for split, n in (("val", frames), ("train", frames), ("smallval", max(frames // 4, 1))):
        with open(os.path.join(root, "KITTI", "ImageSets", split + ".txt"), "w") as f:
            f.write("\n".join("%06d" % i for i in range(n)) + "\n")
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
        kernel_counts.reset()
        t0 = time.perf_counter()
        with eval_instruments() as rec:
            ret = eval_main(common + ["--eval_mode", "rcnn", "--ckpt", ckpt,
                                      "--output_dir", os.path.join(work, "rcnn")])
        run_s = time.perf_counter() - t0
        counts = kernel_counts.read()
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

        kernel_counts.reset()
        rpn = eval_main(common + ["--eval_mode", "rpn", "--rpn_ckpt", ckpt,
                                  "--output_dir", os.path.join(work, "rpn")])
        rpn_counts = kernel_counts.read()
        if rpn_counts["fused_group_mlp_max"] <= 0 or "rpn_seg_iou" not in rpn \
                or not np.isfinite(rpn["recall_0.7"]):
            raise AssertionError(f"eval CLI rpn: {rpn}, launches {rpn_counts}")
        log(f"eval CLI rpn: recall@0.5/0.7 {rpn['recall_0.5']:.4f}/{rpn['recall_0.7']:.4f}, seg "
            f"IoU {rpn['rpn_seg_iou']:.4f}, launches {rpn_counts}")

        check_postprocess(cfg, ckpt, data_root, os.path.join(work, "post"))
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- train CLI

# the train CLI's runs on a KITTI tree of write_kitti_tree (EVAL_FRAMES
# frames, its train split's gt database), each in a directory of its own
# under TRAIN_WORK_DIR (removed after): (a) rpn at TRAIN_BATCH, one epoch,
# checkpoint every epoch; (b) (a)'s checkpoint resumed for a second epoch
# with the loss-only val epoch over smallval; (c) rcnn at RCNN_BATCH, one
# epoch, the RPN from (b)'s checkpoint
TRAIN_WORK_DIR = os.path.join(REPO, "pointrcnn_tpu_torch", "_build", "smoke_train")


def prepare_train_cli(work: str, frames: int = EVAL_FRAMES) -> tuple[str, str]:
    """Write the KITTI tree under ``work`` and the gt database of its train
    split (``python -m pointrcnn_tpu_torch.tools.generate_gt_database``)
    -> (data root, database path)."""
    from pointrcnn_tpu_torch.tools import generate_gt_database

    data_root = os.path.join(work, "data")
    write_kitti_tree(data_root, frames=frames)
    db = generate_gt_database.main(["--data_root", data_root, "--save_dir",
                                    os.path.join(work, "gt_database"), "--split", "train"])
    return data_root, db


@contextlib.contextmanager
def train_instruments():
    """Record, for each step of a train CLI run, without a sync of its own:
    CUDA events around the step (its span on the card), its loss (kept on
    the card), the state it returned, and a copy of the model's tensors
    before the first step."""
    from pointrcnn_tpu_torch.train import trainer

    rec = {"events": [], "losses": [], "state": None, "before": None}
    orig = trainer.make_train_step

    def make_train_step(cfg, tx, seed=0):
        step = orig(cfg, tx, seed)

        def timed(state, batch, bn_momentum, targets=None):
            if rec["before"] is None:
                rec["before"] = {k: v.clone() for k, v in state.model.state_dict().items()}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, tb = step(state, batch, bn_momentum, targets)
            end.record()
            rec["events"].append((start, end))
            rec["losses"].append(tb["loss"])
            rec["state"] = state
            return state, tb

        return timed

    trainer.make_train_step = make_train_step
    try:
        yield rec
    finally:
        trainer.make_train_step = orig
        torch.cuda.synchronize()
        rec["ms"] = [a.elapsed_time(b) for a, b in rec.pop("events")]
        rec["losses"] = [float(x) for x in rec["losses"]]


def _train_cli_run(what, argv, card):
    """One in-process run of the train CLI on the card -> (its TrainRun,
    the instruments' record, the kernels' launches)."""
    from pointrcnn_tpu_torch.train.__main__ import main as train_main

    kernel_counts.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with train_instruments() as rec:
        run = train_main(argv)
    run_s = time.perf_counter() - t0
    counts = kernel_counts.read()
    peak = torch.cuda.max_memory_allocated()
    ms, steps = rec["ms"], sum(e["steps"] for e in run.history)
    if len(ms) != steps or not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"train CLI {what}: {len(ms)} steps timed of {steps}, losses "
                             f"{rec['losses']}")
    timed = ms[1:]
    epochs = ", ".join(f"epoch {e['epoch']}: {e['steps']} steps in {1000 * e['seconds']:.3f} ms "
                       f"after {1000 * e['wait']:.3f} ms on the loader, last loss {e['loss']:.6f}"
                       + (f", val loss {e['val_loss']:.6f}" if "val_loss" in e else "")
                       for e in run.history)
    log(f"{card}: train CLI {what}: {steps} steps, ms/step over steps 2-{steps} (CUDA events "
        f"around each step) min {min(timed):.3f} median {float(np.median(timed)):.3f} max "
        f"{max(timed):.3f}; the first {ms[0]:.3f}; {epochs}; peak memory {peak / 2 ** 30:.3f} "
        f"GiB; whole CLI run {run_s:.3f} s (config, backup, dataset, model, epochs, checkpoints)")
    log(f"train CLI {what}: losses [{', '.join(f'{x:.6f}' for x in rec['losses'])}]; "
        f"launches {counts}")
    return run, rec, counts


def _check_ckpt_loads(what, path, cfg, rec, epoch, it):
    """``path`` loads into a state of other weights and gives back the run's
    last state bit for bit, with ``epoch`` and ``it``."""
    from pointrcnn_tpu_torch.train.checkpoint import load_checkpoint
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer
    from pointrcnn_tpu_torch.train.state import create_train_state

    def same(a, b):
        if isinstance(b, dict):
            return isinstance(a, dict) and a.keys() == b.keys() and all(same(a[k], b[k])
                                                                        for k in b)
        return torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b

    live = rec["state"]
    fresh = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=7, device="cuda")
    fresh, e, i = load_checkpoint(path, fresh)
    equal = (same(fresh.model.state_dict(), live.model.state_dict())
             and same(fresh.opt_state, live.opt_state) and fresh.step == live.step)
    if not equal or (e, i) != (epoch, it):
        raise AssertionError(f"train CLI {what}: {path} loads back as epoch {e}, it {i} (want "
                             f"{epoch}, {it}), state equal {equal}")
    log(f"train CLI {what}: {os.path.basename(path)} loads back bit for bit (epoch {e}, it {i}, "
        f"step {fresh.step})")


def phase_train_cli(train_launches, rcnn_launches, card):
    """The train CLI (``python -m pointrcnn_tpu_torch.train``) in-process on
    the card at ``cfgs/default.yaml`` as it stands (AUG_DATA, GT_AUG from the
    tree's database, 16384 points, bf16): runs (a), (b), (c) of
    TRAIN_WORK_DIR.  Runs (a) and (c) launch every kernel their steps times
    the per-step counts of phase_train / phase_rcnn_train (``train_launches``
    and ``rcnn_launches``: their counts over TRAIN_TIMED steps); (c) updates
    every RCNN parameter and moves the fixed RPN by the weight decay alone
    -> (each run's launches, run (b)'s checkpoint, the tree's data root and
    gt database); the caller removes TRAIN_WORK_DIR."""
    from pointrcnn_tpu_torch.entry import rcnn_config, rpn_config
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer

    work = TRAIN_WORK_DIR
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    data_root, db = prepare_train_cli(work)
    log(f"train CLI data: {EVAL_FRAMES} frames and the train split's gt database "
        f"({os.path.getsize(db)} bytes) in {time.perf_counter() - t0:.3f} s")
    common = ["--cfg_file", os.path.join(REPO, "cfgs", "default.yaml"), "--data_root",
              data_root, "--gt_database", db, "--device", "cuda", "--ckpt_save_interval", "1"]
    rpn = common + ["--train_mode", "rpn", "--batch_size", str(TRAIN_BATCH)]
    run_a, rec_a, counts_a = _train_cli_run(
        "rpn (a)", rpn + ["--epochs", "1", "--output_dir", os.path.join(work, "rpn")], card)
    ckpt_a = os.path.join(run_a.ckpt_dir, "checkpoint_epoch_1")
    _check_ckpt_loads("rpn (a)", ckpt_a, rpn_config(), rec_a, 1, run_a.it)
    del rec_a
    run_b, rec_b, counts_b = _train_cli_run(
        "rpn resume (b)", rpn + ["--ckpt", ckpt_a, "--epochs", "2", "--train_with_eval",
                                 "--output_dir", os.path.join(work, "resume")], card)
    ckpt_b = os.path.join(run_b.ckpt_dir, "checkpoint_epoch_2")
    if run_b.it != 2 * run_a.it or not np.isfinite(run_b.history[-1]["val_loss"]):
        raise AssertionError(f"train CLI resume: it {run_b.it}, history {run_b.history}")
    _check_ckpt_loads("rpn resume (b)", ckpt_b, rpn_config(), rec_b, 2, 2 * run_a.it)
    del rec_b
    run_c, rec_c, counts_c = _train_cli_run(
        "rcnn (c)", common + ["--train_mode", "rcnn", "--batch_size", str(RCNN_BATCH),
                              "--rpn_ckpt", ckpt_b, "--epochs", "1",
                              "--output_dir", os.path.join(work, "rcnn")], card)
    _check_ckpt_loads("rcnn (c)", os.path.join(run_c.ckpt_dir, "checkpoint_epoch_1"),
                      rcnn_config(), rec_c, 1, run_c.it)

    for what, run, counts, per in (("rpn (a)", run_a, counts_a, train_launches),
                                   ("rcnn (c)", run_c, counts_c, rcnn_launches)):
        want = {k: run.it * v // TRAIN_TIMED for k, v in per.items()}
        if counts != want or any(v % TRAIN_TIMED for v in per.values()):
            raise AssertionError(f"train CLI {what}: launches {counts}, not {run.it} times "
                                 f"the step's {({k: v / TRAIN_TIMED for k, v in per.items()})}")
    log(f"train CLI: rpn (a) and rcnn (c) launch every kernel {run_a.it} and {run_c.it} "
        f"times the per-step counts of phase_train and phase_rcnn_train")

    # (c): every RCNN parameter updated; the fixed RPN moved by the
    # weight decay alone and its BN statistics still
    model, before = rec_c["state"].model, rec_c["before"]
    after = model.state_dict()
    rcnn = [k for k, _ in model.named_parameters() if k.startswith("rcnn_net.")]
    still = [k for k in rcnn if torch.equal(after[k], before[k])]
    if still:
        raise AssertionError(f"train CLI rcnn: RCNN parameters unchanged: {still}")
    opt = build_optimizer(model.cfg, run_c.it, run_c.it)
    rpn_params = [k for k, _ in model.named_parameters() if k.startswith("rpn.")]
    for k in rpn_params:
        if not torch.equal(after[k], decayed(before[k], opt, run_c.it)):
            raise AssertionError(f"train CLI rcnn: RPN parameter {k} moved by "
                                 f"{(after[k] - before[k]).abs().max().item()}, not by the "
                                 f"weight decay alone")
    moved_stats = [k for k, _ in model.named_buffers() if not torch.equal(after[k], before[k])]
    if moved_stats:
        raise AssertionError(f"train CLI rcnn: BN statistics moved: {moved_stats[:3]}")
    log(f"train CLI rcnn (c): all {len(rcnn)} RCNN parameters updated; all "
        f"{len(rpn_params)} RPN parameters moved by the weight decay alone (bit-equal), BN "
        f"statistics unchanged")
    return {"rpn": counts_a, "resume": counts_b, "rcnn": counts_c}, ckpt_b, data_root, db

# ---------------------------------------------------------------- RCNN without RPN features


def phase_no_rpn_features(launches, rpn_ckpt):
    """``RCNN.USE_RPN_FEATURES`` False (no up or merge layer: RCNN SA1 takes
    the 2 extra channels and the 128 RPN features as its features): the
    joint eval forward at batch 4 launches every kernel a forward's counts
    of phase_default with finite outputs, and one rcnn step from the rpn
    stage's checkpoint launches K2 and K7 as phase_rcnn_train's step does,
    no stack off the fused route, with a finite loss and gradient norm."""
    from pointrcnn_tpu_torch.entry import default_config, entry, rcnn_config, train_entry
    from pointrcnn_tpu_torch.ops import cuda_mlp

    override = ["RCNN.USE_RPN_FEATURES", "False"]
    fwd, (model, batch) = entry(batch=BATCH, device="cuda", seed=0, cfg=default_config(override))
    if hasattr(model.rcnn_net, "xyz_up_layer") or model.rcnn_net.SetAbstraction_0.SharedMLP_0.w0 \
            .shape[0] != 3 + 2 + 128:
        raise AssertionError("RCNN.USE_RPN_FEATURES False: the RCNN kept its up layer or SA1's "
                             "input is not 133 channels")
    kernel_counts.reset()
    out = fwd(model, batch)
    torch.cuda.synchronize()
    counts = kernel_counts.read()
    _check_outputs(out, model.cfg.TEST.RPN_POST_NMS_TOP_N, "no RPN features, cloud 0")
    per_fwd = {k: v // len(CLOUD_SEEDS) for k, v in launches.items()}
    if counts != per_fwd:
        raise AssertionError(f"no RPN features forward: launches {counts}, not {per_fwd}")
    log(f"no RPN features forward batch {BATCH}: launches {counts} (phase_default's a forward)")
    del fwd, model, batch, out

    step, (state, data) = train_entry(device="cuda", seed=0, stage="rcnn", rpn_ckpt=rpn_ckpt,
                                      cfg=rcnn_config(override))
    cuda_mlp.reset_nomatch()
    kernel_counts.reset()
    state, tb = step(state, data)
    torch.cuda.synchronize()
    counts = kernel_counts.read()
    loss, gnorm = tb["loss"].item(), tb["grad_norm"].item()
    log(f"no RPN features rcnn step batch {RCNN_BATCH}: loss {loss:.6f}, grad norm {gnorm:.6f}, "
        f"launches {counts}")
    if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"no RPN features rcnn step: loss {loss}, grad norm {gnorm}")
    for name, n in RCNN_STEP_LAUNCHES.items():
        if counts[name] != n:
            raise AssertionError(f"no RPN features rcnn step: {name} launched {counts[name]} "
                                 f"times, not {n}")
    if counts["generic_grouped_train"] or cuda_mlp.nomatch_count():
        raise AssertionError(f"no RPN features rcnn step: {counts['generic_grouped_train']} SA "
                             f"stacks off the fused route, {cuda_mlp.nomatch_count()} dropped "
                             f"maxima")


# ---------------------------------------------------------------- offline RCNN

# the reference's offline recipe on the train CLI's tree (its rpn run (b)):
# (d) the rpn eval's feature dump of the train split at 300 proposals a
# frame and of smallval at TEST.RPN_POST_NMS_TOP_N (100); (e) rcnn_offline
# at batch 4 for one epoch with the val epoch over the smallval dump; (f)
# the offline eval of (e)'s checkpoint on smallval with the official AP
OFFLINE_MODE = ["RPN.ENABLED", "False", "RCNN.ENABLED", "True", "RCNN.ROI_SAMPLE_JIT", "False"]
# launches of the offline RCNN: K1 and K2 at RCNN SA1 (fold) and SA2 (hilo)
# a forward, K7 at both in the backward; no other kernel
OFFLINE_FWD_LAUNCHES = {"fps": 2, "fused_group_mlp_max": 2}
OFFLINE_STEP_LAUNCHES = {"fps": 2, "fused_group_mlp_max": 2, "fused_group_mlp_backward": 2}
# the RCNN's eval outputs on the card against the CPU path, on agreeing
# inputs: check_against_cpu's bound for the RCNN outputs
OFFLINE_OUT_RTOL = 0.05


def _expect(per, n):
    return {name: per.get(name, 0) * n for name in kernel_counts.read()}


def _with_gt_rois(data_root, roi_dir, out_dir):
    """``roi_dir``'s proposal files with each frame's gt boxes first, the
    rois a trained RPN proposes: the sampled batch then has foreground."""
    labels = os.path.join(data_root, "KITTI", "object", "training", "label_2")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(roi_dir):
        with open(os.path.join(labels, name)) as f:
            gt = "".join(ln + " 1.0\n" for ln in f.read().splitlines() if ln.startswith("Car"))
        with open(os.path.join(roi_dir, name)) as f, open(os.path.join(out_dir, name), "w") as g:
            g.write(gt + f.read())
    return out_dir


def _offline_step_against_cpu(cfg, data_root, rois, feats):
    """One offline train step (a frame: ROI_PER_IMAGE rois sampled from its
    proposals and gt boxes) on the card against the port's CPU path, from
    the same seeded weights: _rcnn_against_cpu's tolerances."""
    from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer
    from pointrcnn_tpu_torch.train.state import create_train_state, loss_and_grads
    from pointrcnn_tpu_torch.train.trainer import batch_to_device

    ds = KittiRCNNDataset(data_root, cfg, npoints=cfg.RPN.NUM_POINTS, split="train", mode="TRAIN",
                          rcnn_training_roi_dir=rois, rcnn_training_feature_dir=feats)
    batch = ds.collate_batch([ds.getitem(0, np.random.RandomState(0))])
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=1, device="cuda")
    cpu_model = copy.deepcopy(state.model).cpu()
    gl, gtb, gg = loss_and_grads(state.model, cfg, batch_to_device(batch, "cuda"))
    t0 = time.perf_counter()
    cl, _, cg = loss_and_grads(cpu_model, cfg, batch_to_device(batch, "cpu"))
    log(f"offline step vs cpu: cpu reference step {time.perf_counter() - t0:.1f} s")
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())))
    card_norm = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in gg.values())))
    e_loss, e_norm = abs(gl.item() / cl.item() - 1), abs(card_norm / gnorm - 1)
    share = max(float((gg[k].cpu() - g).norm()) / gnorm for k, g in cg.items())
    log(f"offline step vs cpu ({batch['pts_input'].shape[0]} rois, {int(gtb['rcnn_cls_fg'])} fg / "
        f"{int(gtb['rcnn_cls_bg'])} bg, {int(gtb['rcnn_reg_fg'])} reg fg): loss {gl.item():.6f} vs "
        f"{cl.item():.6f} (rel {e_loss:.2e}, tol {RCNN_LOSS_RTOL}), grad norm {card_norm:.6f} vs "
        f"{gnorm:.6f} (rel {e_norm:.2e}, tol {RCNN_GNORM_RTOL}), worst gradient leaf {share:.2e} "
        f"of the global norm (tol {RCNN_LEAF_SHARE})")
    if not (int(gtb["rcnn_cls_fg"]) and int(gtb["rcnn_reg_fg"])):
        raise AssertionError("offline step vs cpu: the sampled batch has no foreground")
    if e_loss > RCNN_LOSS_RTOL or e_norm > RCNN_GNORM_RTOL or share > RCNN_LEAF_SHARE:
        raise AssertionError("the card's offline step differs from the CPU path")


def _offline_eval_against_cpu(cfg, data_root, rois, feats):
    """One offline eval batch (EVAL_BATCH frames of smallval) from seeded
    weights on the card against the port's CPU path: the pooled inputs,
    the RCNN's outputs on them (OFFLINE_OUT_RTOL of their magnitude), and
    the post-process on the card's outputs run on both (the same NMS
    survivors in order, boxes to POST_BOX_RTOL)."""
    from pointrcnn_tpu_torch.eval import evaluator
    from pointrcnn_tpu_torch.eval.__main__ import ProposalDataset
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN

    ds = ProposalDataset(data_root, cfg, npoints=cfg.RPN.NUM_POINTS, split="smallval",
                         mode="EVAL", rcnn_eval_roi_dir=rois, rcnn_eval_feature_dir=feats)
    frames = min(EVAL_BATCH, len(ds))
    batch = ds.collate_batch([ds.getitem(i, np.random.RandomState(i)) for i in range(frames)])
    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(1)).to("cuda")
    model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    args = [torch.from_numpy(batch[k]) for k in evaluator.OFFLINE_INPUTS]
    with torch.inference_mode():
        card_in = evaluator.rcnn_offline_inputs(cfg, *[a.cuda() for a in args[:-1]])
        cpu_in = evaluator.rcnn_offline_inputs(cfg, *args[:-1])
        e_in = (card_in.cpu() - cpu_in).abs().max().item()
        scale_in = cpu_in.abs().max().item()
        out = model({"pts_input": card_in})
        t0 = time.perf_counter()
        ref = cpu_model({"pts_input": card_in.cpu()})
        log(f"offline eval vs cpu: cpu reference forward {time.perf_counter() - t0:.1f} s")
        errs = {k: ((out[k].cpu() - ref[k]).abs().max().item(), ref[k].abs().max().item())
                for k in ("rcnn_cls", "rcnn_reg")}
        rois_t, valid = args[-2], args[-1]
        card = {k: v.cpu() for k, v in evaluator.refine_postprocess(
            cfg, rois_t.cuda(), valid.cuda(), out["rcnn_cls"], out["rcnn_reg"]).items()}
        cpu = evaluator.refine_postprocess(cfg, rois_t, valid, out["rcnn_cls"].cpu(),
                                           out["rcnn_reg"].cpu())
    log(f"offline eval vs cpu (batch {frames}, {int(valid.sum())} valid of "
        f"{valid.numel()} rois): pooled input max err {e_in:.3e} (scale {scale_in:.3e}); "
        + ", ".join(f"{k} max err {e:.3e} (scale {sc:.3e})" for k, (e, sc) in errs.items())
        + f" (tol {OFFLINE_OUT_RTOL} relative)")
    if e_in > 1e-5 * scale_in or any(e > OFFLINE_OUT_RTOL * sc + 1e-6 for e, sc in errs.values()):
        raise AssertionError("the card's offline eval forward differs from the CPU path")
    same = (torch.equal(card["sel_valid"], cpu["sel_valid"])
            and torch.equal(card["sel_idx"][card["sel_valid"]], cpu["sel_idx"][cpu["sel_valid"]]))
    scale = cpu["pred_boxes3d"].abs().max().item()
    err = (card["pred_boxes3d"] - cpu["pred_boxes3d"]).abs().max().item()
    if not same or err > POST_BOX_RTOL * scale or not int(cpu["sel_valid"].sum()):
        raise AssertionError(f"offline post-process card vs cpu: same survivors {same} (of "
                             f"{int(cpu['sel_valid'].sum())}), boxes max err {err} (scale {scale})")
    log(f"offline post-process card vs cpu (same network outputs): "
        f"{int(cpu['sel_valid'].sum())} NMS survivors identical in order, pred_boxes3d max err "
        f"{err:.3e} (scale {scale:.3e}, tol {POST_BOX_RTOL} relative)")


def phase_offline(launches, data_root, rpn_ckpt, card):
    """The reference's offline recipe through the port's CLIs in-process on
    the card, at cfgs/default.yaml as it stands, from the train CLI's rpn
    run (b): (d) ``--eval_mode rpn --save_rpn_feature`` over the train split
    (``TEST.RPN_POST_NMS_TOP_N`` 300, as the README's recipe) and over
    smallval; (e) ``--train_mode rcnn_offline`` at batch 4, one epoch, with
    ``--train_with_eval`` over the smallval dump, and (e') the same with
    ``--worker_processes``; (f) ``--eval_mode rcnn_offline`` of (e)'s
    checkpoint on smallval with the official AP.
    Launches: (d) phase_default's per-forward RPN counts a batch; (e) K1,
    K2 and K7 twice a step and K1, K2 twice a val batch; (f) K1 and K2
    twice a batch; nothing else.  Then an offline step and an offline eval
    batch from seeded weights against the CPU path.  ``launches``: phase_default's counts over
    its forwards -> each run's launches."""
    from pointrcnn_tpu_torch.entry import default_config
    from pointrcnn_tpu_torch.eval.__main__ import main as eval_main

    work = os.path.join(TRAIN_WORK_DIR, "offline")
    cfg_file = os.path.join(REPO, "cfgs", "default.yaml")
    base = ["--cfg_file", cfg_file, "--data_root", data_root, "--device", "cuda"]
    counts, dirs = {}, {}
    # (d): the RPN's share of a forward of phase_default, a batch
    rpn_fwd = {k: v // len(CLOUD_SEEDS) - OFFLINE_FWD_LAUNCHES.get(k, 0)
               for k, v in launches.items()}
    for split, top_n in (("train", 300), ("smallval", None)):
        out = os.path.join(work, f"dump_{split}")
        sets = ["TEST.SPLIT", split] + (["TEST.RPN_POST_NMS_TOP_N", str(top_n)] if top_n else [])
        kernel_counts.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eval_instruments() as rec:
            ret = eval_main(base + ["--eval_mode", "rpn", "--rpn_ckpt", rpn_ckpt,
                                    "--batch_size", str(EVAL_BATCH), "--save_rpn_feature",
                                    "--output_dir", out, "--set", *sets])
        run_s = time.perf_counter() - t0
        counts[f"d_{split}"] = kernel_counts.read()
        (e0, e1), n_frames = rec["epoch"][0], len(os.listdir(os.path.join(out, "rpn_result",
                                                                            "data")))
        rois = [sum(1 for _ in open(os.path.join(out, "rpn_result", "data", f)))
                for f in sorted(os.listdir(os.path.join(out, "rpn_result", "data")))]
        log(f"{card}: offline (d) rpn dump {split}: {n_frames} frames, {min(rois)}-{max(rois)} "
            f"proposals a frame, epoch {1000 * (e1 - e0):.3f} ms ({n_frames / (e1 - e0):.3f} "
            f"frames/s, files included), whole CLI run {run_s:.3f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; recall@0.5/0.7 "
            f"{ret['recall_0.5']:.4f}/{ret['recall_0.7']:.4f}; launches {counts[f'd_{split}']}")
        dirs[split] = (os.path.join(out, "rpn_result", "data"), os.path.join(out, "features"))
        if counts[f"d_{split}"] != _expect(rpn_fwd, len(rec["enq"])):
            raise AssertionError(f"offline (d) {split}: launches {counts[f'd_{split}']}, not "
                                 f"{len(rec['enq'])} times the RPN's {rpn_fwd}")
        if len(os.listdir(dirs[split][1])) != 5 * n_frames:
            raise AssertionError(f"offline (d) {split}: {len(os.listdir(dirs[split][1]))} feature "
                                 f"files for {n_frames} frames")

    # (e)
    flags = ["--rcnn_training_roi_dir", dirs["train"][0], "--rcnn_training_feature_dir",
             dirs["train"][1], "--rcnn_eval_roi_dir", dirs["smallval"][0],
             "--rcnn_eval_feature_dir", dirs["smallval"][1]]
    run_e, rec_e, counts["e"] = _train_cli_run(
        "rcnn_offline (e)", base + ["--train_mode", "rcnn_offline", "--batch_size",
                                    str(RCNN_BATCH), "--epochs", "1", "--ckpt_save_interval", "1",
                                    "--train_with_eval", "--output_dir",
                                    os.path.join(work, "train"), *flags], card)
    ckpt_e = os.path.join(run_e.ckpt_dir, "checkpoint_epoch_1")
    ms_e, losses_e = rec_e["ms"], rec_e["losses"]
    cfg = default_config(OFFLINE_MODE)
    _check_ckpt_loads("rcnn_offline (e)", ckpt_e, cfg, rec_e, 1, run_e.it)
    val_batches = -(-len(open(os.path.join(data_root, "KITTI", "ImageSets", "smallval.txt"))
                         .read().split()) // RCNN_BATCH)
    if not np.isfinite(run_e.history[-1]["val_loss"]):
        raise AssertionError(f"offline (e): val loss {run_e.history[-1]}")
    model, before = rec_e["state"].model, rec_e["before"]
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    if hasattr(model, "rpn") or not moved:
        raise AssertionError("offline (e): an RPN was built, or no parameter moved")
    log(f"offline (e): {len(moved)} of {len(before)} RCNN parameters moved, no RPN; val loss "
        f"{run_e.history[-1]['val_loss']:.6f} over {val_batches} batches")
    del rec_e, model, before
    # (e'): the same run with the loader in forked processes, not threads
    # (its sampling and pooling are Python loops that hold the interpreter
    # lock the step's launches need): the same batches, so the same losses
    # and launches
    run_p, rec_p, counts["e_processes"] = _train_cli_run(
        "rcnn_offline (e') worker processes",
        base + ["--train_mode", "rcnn_offline", "--batch_size", str(RCNN_BATCH), "--epochs", "1",
                "--train_with_eval", "--worker_processes", "--output_dir",
                os.path.join(work, "train_processes"), *flags], card)
    log(f"offline (e) against (e'): median ms/step over steps 2-{run_e.it} threads "
        f"{float(np.median(ms_e[1:])):.3f}, processes {float(np.median(rec_p['ms'][1:])):.3f}; "
        f"epoch s {run_e.history[0]['seconds']:.3f} and {run_p.history[0]['seconds']:.3f}; the "
        f"same losses: {losses_e == rec_p['losses']}")
    del rec_p

    # (f)
    kernel_counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with eval_instruments() as rec:
        ret = eval_main(base + ["--eval_mode", "rcnn_offline", "--ckpt", ckpt_e, "--batch_size",
                                str(EVAL_BATCH), "--rcnn_eval_roi_dir", dirs["smallval"][0],
                                "--rcnn_eval_feature_dir", dirs["smallval"][1],
                                "--output_dir", os.path.join(work, "eval"),
                                "--set", "TEST.SPLIT", "smallval"])
    run_s = time.perf_counter() - t0
    counts["f"] = kernel_counts.read()
    peak = torch.cuda.max_memory_allocated()
    final = os.path.join(work, "eval", "final_result", "data")
    n_frames = len(open(os.path.join(data_root, "KITTI", "ImageSets", "smallval.txt"))
                   .read().split())
    scalars = {k: float(v) for k, v in ret.items()}
    if len(os.listdir(final)) != n_frames or "Car_3d_easy" not in scalars \
            or not all(np.isfinite(list(scalars.values()))):
        raise AssertionError(f"offline (f): {len(os.listdir(final))} result files for {n_frames} "
                             f"frames, {scalars}")
    (e0, e1), enq = rec["epoch"][0], rec["enq"]
    log(f"{card}: offline (f) eval smallval batch {EVAL_BATCH}: {n_frames / (e1 - e0):.3f} "
        f"frames/s over the epoch of {n_frames} frames ({1000 * (e1 - e0):.3f} ms, loader to "
        f"files), device step host spans ms [{', '.join(f'{1000 * (b - a):.3f}' for a, b in enq)}]"
        f", whole CLI run {run_s:.3f} s, peak memory {peak / 2 ** 30:.3f} GiB; recall@0.5/0.7 "
        f"{scalars['recall_0.5']:.4f}/{scalars['recall_0.7']:.4f}, Car 3d AP easy/moderate/hard "
        f"{scalars['Car_3d_easy']:.4f}/{scalars['Car_3d_moderate']:.4f}/"
        f"{scalars['Car_3d_hard']:.4f} (one epoch of training)")

    want = {"e": _expect(OFFLINE_STEP_LAUNCHES, run_e.it), "f": _expect(OFFLINE_FWD_LAUNCHES,
                                                                        len(enq))}
    for name, n in _expect(OFFLINE_FWD_LAUNCHES, val_batches).items():
        want["e"][name] += n
    want["e_processes"] = want["e"]
    for run in ("e", "e_processes", "f"):
        if counts[run] != want[run]:
            raise AssertionError(f"offline ({run}): launches {counts[run]}, not {want[run]}")
    log(f"offline: (e) {run_e.it} steps and {val_batches} val batches, (f) {len(enq)} batches "
        f"launch K1 and K2 twice a forward and K7 twice a step, no other kernel")
    gt_rois = _with_gt_rois(data_root, dirs["train"][0], os.path.join(work, "gt_rois"))
    _offline_step_against_cpu(cfg, data_root, gt_rois, dirs["train"][1])
    _offline_eval_against_cpu(cfg, data_root, *dirs["smallval"])
    return counts


# ---------------------------------------------------------------- shipped configs

# per-step launches that a step's structure fixes: the RPN in training
# gathers (K4) and scatters back (K8) at SA2-SA4's six radii, the RCNN's SA1
# and SA2 run K2 forward and K7 backward; the joint step does both (its RPN
# SA3 and SA4 train on the generic route, so K2 only in the RCNN)
# the 32 BN layers of the RPN backbone (24 SA, 8 FP), each through the four
# kernels of ops/cuda_bn.py once a step, none falling back
BN_STEP_LAUNCHES = {"bn_train_stats": 32, "bn_train_apply": 32, "bn_train_bwd_sums": 32,
                    "bn_train_bwd_apply": 32, "bn_train_plain": 0}
RPN_STEP_LAUNCHES = {"group_gather": 6, "gather_backward": 6, **BN_STEP_LAUNCHES}
JOINT_STEP_LAUNCHES = {"group_gather": 6, "gather_backward": 6, "fused_group_mlp_max": 2,
                       "fused_group_mlp_backward": 2, **BN_STEP_LAUNCHES}
ALL_KERNELS = tuple(name for name, _, _ in KERNELS)
# car_2x's RPN SA2 groups from an 8192-point table, past the gather kernel's
# 4096 (the TPU kernel's predicate, ``cuda_gather.group_points_supported``):
# its neighbourhoods are gathered by indexing, on the TPU by XLA, so K4 and
# K8 run at SA3 and SA4 alone (4 a step) and not in the eval forward
CAR_2X_EVAL_KERNELS = tuple(k for k in EVAL_KERNELS if k != "group_gather")
CAR_2X_RPN_STEP_LAUNCHES = {"group_gather": 4, "gather_backward": 4, **BN_STEP_LAUNCHES}
CAR_2X_RCNN_STEP_LAUNCHES = {**RCNN_STEP_LAUNCHES, "group_gather": 0}
CAR_2X_RCNN_KERNELS = tuple(k for k in RCNN_TRAIN_KERNELS if k != "group_gather")
CAR_2X_WORK_DIR = os.path.join(REPO, "pointrcnn_tpu_torch", "_build", "smoke_car_2x")
# the car_2x and people steps: warm-up and timed steps (fewer than phase_train's:
# each phase also runs its CPU reference)
SHIPPED_WARMUP, SHIPPED_TIMED = 1, 3


def _timed_steps(what, step, state, batch, per_step, kernels, card):
    """``SHIPPED_TIMED`` steps after ``SHIPPED_WARMUP``: ms/step (host clock
    to a synchronise), frames/s and peak memory, the launches (``per_step``
    exactly a step, every kernel of ``kernels`` at least once), every
    parameter of the trained modules moved (or zero) -> (state, the launches over the
    timed steps)."""
    frames = batch["pts_input"].shape[0]
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SHIPPED_WARMUP):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    kernel_counts.reset()
    t0 = time.perf_counter()
    for _ in range(SHIPPED_TIMED):
        state, tb = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SHIPPED_TIMED
    counts = kernel_counts.read()
    peak = torch.cuda.max_memory_allocated()
    loss, gnorm = tb["loss"].item(), tb["grad_norm"].item()
    log(f"{card}: {what} batch {frames} x {batch['pts_input'].shape[1]} points: "
        f"{1000 * dt:.3f} ms/step, {frames / dt:.3f} frames/s ({SHIPPED_TIMED} steps after "
        f"{SHIPPED_WARMUP} warm-up), peak memory {peak / 2 ** 30:.3f} GiB; loss {loss:.6f}, "
        f"grad norm {gnorm:.6f}; launches {counts}")
    if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{what}: loss {loss}, grad norm {gnorm}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the {what} path")
    for name, n in per_step.items():
        if counts[name] != n * SHIPPED_TIMED:
            raise AssertionError(f"{what}: {name} launched {counts[name]} times in "
                                 f"{SHIPPED_TIMED} steps, not {n} a step")
    # a zero-initialised bias whose gradient is zero (a head without
    # foreground) stays zero under Adam and the weight decay
    fixed = "rpn." if state.model.cfg.RPN.FIXED else None
    still = [k for k, v in state.model.named_parameters()
             if torch.equal(v, before[k]) and bool(v.any())
             and (fixed is None or not k.startswith(fixed))]
    if still:
        raise AssertionError(f"{what}: parameters unchanged: {still[:5]}")
    return state, counts


def phase_car_2x(card):
    """cfgs/car_2x.yaml (32768 points, SA stages twice as wide in sites) at
    full width: the eval forward at batch 4 on two clouds, the rpn stage at
    batch 16 and the rcnn stage at batch 4 from the rpn stage's state, each
    timed with its peak memory and launches, and each against the CPU path
    at batch 1 -> the launches (eval: over the two forwards; steps: over
    the timed steps)."""
    from pointrcnn_tpu_torch.entry import entry, shipped_config, synthetic_cloud, train_entry
    from pointrcnn_tpu_torch.train import checkpoint

    out = {}
    cfg = shipped_config("car_2x")
    fwd, (model, _) = entry(batch=BATCH, device="cuda", seed=0, cfg=cfg)
    clouds = [torch.from_numpy(synthetic_cloud(BATCH, cfg.RPN.NUM_POINTS, s)).cuda()
              for s in CLOUD_SEEDS[:2]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts.reset()
    outs = [fwd(model, {"pts_input": pts}) for pts in clouds]
    torch.cuda.synchronize()
    out["eval"] = kernel_counts.read()
    peak = torch.cuda.max_memory_allocated()
    log(f"car_2x forward x{len(clouds)} launches: {out['eval']}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    for s, o in zip(CLOUD_SEEDS, outs):
        _check_outputs(o, cfg.TEST.RPN_POST_NMS_TOP_N, f"car_2x, cloud {s}")
    for name in CAR_2X_EVAL_KERNELS:
        if out["eval"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the car_2x forward")
    if any(out["eval"][k] for k in ALL_KERNELS if k not in CAR_2X_EVAL_KERNELS):
        raise AssertionError(f"the car_2x forward launched K4 or a backward: {out['eval']}")
    ms = _frames_per_s(fwd, model, clouds[0], f"{card}: car_2x")
    log(f"car_2x forward: {ms:.3f} ms a batch of {BATCH} x {cfg.RPN.NUM_POINTS} points")
    check_against_cpu(model, synthetic_cloud(1, cfg.RPN.NUM_POINTS, 5), "car_2x")
    del fwd, model, outs, clouds
    torch.cuda.empty_cache()

    rpn_cfg = shipped_config("car_2x", "rpn")
    step, (state, batch) = train_entry(batch=TRAIN_BATCH, device="cuda", seed=0, cfg=rpn_cfg)
    state, out["rpn_step"] = _timed_steps("car_2x rpn step", step, state, batch,
                                          CAR_2X_RPN_STEP_LAUNCHES, TRAIN_KERNELS, card)
    ckpt = checkpoint.save_checkpoint(CAR_2X_WORK_DIR, state, epoch=1, it=state.step)
    del step, state, batch
    torch.cuda.empty_cache()
    _train_against_cpu(shipped_config("car_2x", "rpn", ["RPN.DP_RATIO", "0.0"]), 1,
                       "car_2x rpn step")

    rcnn_cfg = shipped_config("car_2x", "rcnn")
    step, (state, batch) = train_entry(batch=RCNN_BATCH, device="cuda", seed=0, cfg=rcnn_cfg,
                                       stage="rcnn", rpn_ckpt=ckpt)
    state, out["rcnn_step"] = _timed_steps("car_2x rcnn step", step, state, batch,
                                           CAR_2X_RCNN_STEP_LAUNCHES, CAR_2X_RCNN_KERNELS, card)
    del step, state, batch
    torch.cuda.empty_cache()
    _rcnn_against_cpu(ckpt, rcnn_cfg, "car_2x rcnn step")
    return out


WIDE_WORK_DIR = os.path.join(REPO, "pointrcnn_tpu_torch", "_build", "smoke_wide")


def _forward_path(what, cfg, kernels, card):
    """The eval forward of ``cfg`` at batch 4 on two clouds: its launches
    (every kernel of ``kernels`` at least once, no other), finite outputs of
    the right shapes, peak memory, frames/s, and a batch-1 forward against
    the CPU path -> the launches over the two forwards."""
    from pointrcnn_tpu_torch.entry import entry, synthetic_cloud

    fwd, (model, _) = entry(batch=BATCH, device="cuda", seed=0, cfg=cfg)
    clouds = [torch.from_numpy(synthetic_cloud(BATCH, cfg.RPN.NUM_POINTS, s)).cuda()
              for s in CLOUD_SEEDS[:2]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts.reset()
    outs = [fwd(model, {"pts_input": pts}) for pts in clouds]
    torch.cuda.synchronize()
    counts = kernel_counts.read()
    peak = torch.cuda.max_memory_allocated()
    log(f"{what} forward x{len(clouds)} launches: {counts}; peak memory {peak / 2 ** 30:.3f} GiB")
    for s, o in zip(CLOUD_SEEDS, outs):
        _check_outputs(o, cfg.TEST.RPN_POST_NMS_TOP_N, f"{what}, cloud {s}")
    for name in ALL_KERNELS:
        if (counts[name] > 0) != (name in kernels):
            raise AssertionError(f"{what} forward: {name} launched {counts[name]} times")
    ms = _frames_per_s(fwd, model, clouds[0], f"{card}: {what}")
    log(f"{what} forward: {ms:.3f} ms a batch of {BATCH} x {cfg.RPN.NUM_POINTS} points")
    check_against_cpu(model, synthetic_cloud(1, cfg.RPN.NUM_POINTS, 5), what)
    del fwd, model, outs, clouds
    torch.cuda.empty_cache()
    return counts


def phase_wide(card):
    """Path W: cfgs/default.yaml + WIDE_OVERRIDES (K 128 at RCNN SA1 and
    SA2, a one-layer SA1, a five-layer SA2 up to 640 wide, RPN SA4's table
    3 + 1024 channels) through the entry points: the eval forward at batch
    4, the rpn step at batch 16 and the rcnn step at batch 4 from the rpn
    step's state, each timed with its peak memory and launches and each
    against the CPU path at batch 1 -> the launches (eval: over the two
    forwards; steps: over the timed steps)."""
    from pointrcnn_tpu_torch.entry import WIDE_OVERRIDES, default_config, shipped_config, \
        train_entry
    from pointrcnn_tpu_torch.train import checkpoint

    out = {"eval": _forward_path("W", default_config(WIDE_OVERRIDES), EVAL_KERNELS, card)}
    try:
        rpn_cfg = shipped_config("default", "rpn", WIDE_OVERRIDES)
        step, (state, batch) = train_entry(batch=TRAIN_BATCH, device="cuda", seed=0,
                                           cfg=rpn_cfg)
        state, out["rpn_step"] = _timed_steps("W rpn step", step, state, batch,
                                              RPN_STEP_LAUNCHES, TRAIN_KERNELS, card)
        ckpt = checkpoint.save_checkpoint(WIDE_WORK_DIR, state, epoch=1, it=state.step)
        del step, state, batch
        torch.cuda.empty_cache()
        _train_against_cpu(shipped_config("default", "rpn",
                                          WIDE_OVERRIDES + ["RPN.DP_RATIO", "0.0"]), 1,
                           "W rpn step")
        rcnn_cfg = shipped_config("default", "rcnn", WIDE_OVERRIDES)
        step, (state, batch) = train_entry(batch=RCNN_BATCH, device="cuda", seed=0,
                                           cfg=rcnn_cfg, stage="rcnn", rpn_ckpt=ckpt)
        state, out["rcnn_step"] = _timed_steps("W rcnn step", step, state, batch,
                                               RCNN_STEP_LAUNCHES, RCNN_TRAIN_KERNELS, card)
        del step, state, batch
        torch.cuda.empty_cache()
        _rcnn_against_cpu(ckpt, rcnn_cfg, "W rcnn step")
    finally:
        shutil.rmtree(WIDE_WORK_DIR, ignore_errors=True)
    return out


def phase_car_2x_exact(card):
    """Path X: cfgs/car_2x.yaml + EXACT_OVERRIDES (exact FPS over rows of
    32768 points at RPN SA1, 8192 picks) through the eval forward at batch
    4, with its launches, peak memory, frames/s and a batch-1 forward
    against the CPU path -> the launches over the two forwards."""
    from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, shipped_config

    # the exact ball query scans the table (no K5/K6); car_2x's RPN SA2
    # table (8192 points) is past K4's predicate, as in phase_car_2x
    kernels = ("fps", "three_nn", "fused_group_mlp_max")
    cfg = shipped_config("car_2x", None, EXACT_OVERRIDES)
    out = {"eval": _forward_path("X", cfg, kernels, card)}
    # two forwards, every ball query on K10
    from pointrcnn_tpu_torch.entry import entry

    want = 2 * exact_query_launches(entry(batch=1, device="cpu", seed=0, cfg=cfg)[1][0])
    if out["eval"]["ball_query_first_k"] != want:
        raise AssertionError(f"X forward: {out['eval']['ball_query_first_k']} "
                             f"ball_query_first_k launches, expected {want}")
    return out


# path K's rcnn step: RCNN SA2 (K 512) trains on the generic route (the TPU
# backward predicate refuses it, on both sides), so K2 five a step (RPN SA3
# and SA4, two radii each, and RCNN SA1) and K7 one (RCNN SA1)
DEEP_K_RCNN_STEP_LAUNCHES = {**RCNN_STEP_LAUNCHES, "fused_group_mlp_max": 5,
                             "fused_group_mlp_backward": 1}


def phase_deep_k(card, rpn_ckpt):
    """Path K: cfgs/default.yaml + DEEP_K_OVERRIDES (K2 at RCNN SA1, K 256,
    and SA2, K 512; K7 at SA1) through the entry points: the eval forward at
    batch 4 (frames/s, peak memory, a batch-1 forward against the CPU path)
    and the rcnn step at batch 4 from the default RPN's checkpoint (ms/step,
    peak memory, a batch-2 step against the CPU path) -> the launches (eval:
    over the two forwards; rcnn_step: over the timed steps)."""
    from pointrcnn_tpu_torch.entry import DEEP_K_OVERRIDES, default_config, shipped_config, \
        train_entry

    out = {"eval": _forward_path("K", default_config(DEEP_K_OVERRIDES), EVAL_KERNELS, card)}
    rcnn_cfg = shipped_config("default", "rcnn", DEEP_K_OVERRIDES)
    step, (state, batch) = train_entry(batch=RCNN_BATCH, device="cuda", seed=0, cfg=rcnn_cfg,
                                       stage="rcnn", rpn_ckpt=rpn_ckpt)
    state, out["rcnn_step"] = _timed_steps("K rcnn step", step, state, batch,
                                           DEEP_K_RCNN_STEP_LAUNCHES, RCNN_TRAIN_KERNELS, card)
    del step, state, batch
    torch.cuda.empty_cache()
    _rcnn_against_cpu(rpn_ckpt, rcnn_cfg, "K rcnn step", batch_size=2)
    return out


# the joint step's second scene: every gt box moved onto a proposal, as the
# rcnn stage's scene, which leaves the RPN few foreground points (11 in
# people.yaml's), and its gradients hang on those points' neighbourhoods.
# There the card is held to the CPU within JOINT_FEW_FG_FACTOR times what the
# CPU's own step moves when its input moves by one ulp (never tighter than
# the bounds above).  Measured on an H100 at 700 W: the CPU one ulp up moves
# the grad norm by 1.1e-2 and its worst leaf by 6.1e-2 of the norm (on the
# joint scene, 1009 fg points, 1.6e-3 and 1.6e-2); the card departs by
# 4.0e-2 and 0.101, bf16 roundings at every layer against one input ulp
JOINT_FEW_FG_FACTOR = 5


def _grad_readings(loss, grads, ref_loss, ref_grads):
    """(loss rel, gradient norm rel, each leaf's departure over the
    reference's global norm) of a step against a reference step."""
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref_grads.values())))
    other = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in grads.values())))
    leaf = {k: float((grads[k].cpu() - g).norm()) / norm for k, g in ref_grads.items()}
    return abs(float(loss) / float(ref_loss) - 1), abs(other / norm - 1), leaf


def _joint_against_cpu(cfg, tag, keep=True):
    """A batch-1 joint step on the card against the port's CPU path: the
    same weights, scene and target draws, dropout off, and the card's
    proposals and RPN features handed to the CPU model's RCNN (the RPN
    trains, so its forward runs on both sides and is compared through the
    loss and its gradients; in bf16 the two RPNs' outputs part by
    roundings, and with random weights the proposal ranking hangs on them):
    the target layer's decisions equal, the loss, gradient norm and every
    gradient leaf within the bounds of the rpn step's comparison.  The CPU
    step is also taken on the input moved by one ulp (every coordinate to
    the next float up, the same hand-off), the witness of how far roundings
    alone move it.  ``keep`` False: the scene of :data:`JOINT_FEW_FG_FACTOR`
    -> the two readings (card against CPU, CPU against itself)."""
    from pointrcnn_tpu_torch.entry import gt_on_proposals, synthetic_scene, train_entry
    from pointrcnn_tpu_torch.models import point_rcnn
    from pointrcnn_tpu_torch.models.target import target_draws
    from pointrcnn_tpu_torch.train.state import dropout_generator, loss_and_grads

    _, (state, batch) = train_entry(batch=1, device="cuda", seed=5, cfg=cfg, stage="joint")
    model = state.model
    if not keep:
        scene = synthetic_scene(1, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, 5)
        batch = gt_on_proposals(model, {k: torch.from_numpy(v).cuda() for k, v in scene.items()},
                                dropout_generator(5, 0, "cuda"))
    cpu_model = copy.deepcopy(model).cpu()
    ulp_model = copy.deepcopy(cpu_model)
    seen = {}
    model.register_forward_hook(lambda m, a, o: seen.update(card=o))
    cpu_model.register_forward_hook(lambda m, a, o: seen.update(cpu=o))
    # the RCNN reads the RPN's features through a detached hand-off: the CPU
    # RCNN gets the card's (the RPN's own loss and gradients are the CPU's)
    model.rpn.register_forward_hook(lambda m, a, o: seen.update(features=o["backbone_features"]))
    for m in (cpu_model.rpn, ulp_model.rpn):
        m.register_forward_hook(
            lambda m, a, o: {**o, "backbone_features": seen["features"].detach().cpu()})
    draws = target_draws(cfg, torch.Generator(device="cuda").manual_seed(11), 1,
                         cfg.TRAIN.RPN_POST_NMS_TOP_N, device="cuda")
    cpu_draws = {k: v.cpu() for k, v in draws.items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    ulp_batch = {**cpu_batch, "pts_input": torch.nextafter(
        cpu_batch["pts_input"], torch.full_like(cpu_batch["pts_input"], float("inf")))}
    orig = point_rcnn.proposal_layer

    def recorded(*a, **k):
        seen["proposals"] = orig(*a, **k)
        return seen["proposals"]

    point_rcnn.proposal_layer = recorded
    try:
        gl, gtb, gg = loss_and_grads(model, cfg, batch, targets=draws)
        point_rcnn.proposal_layer = lambda *a, **k: tuple(v.cpu() for v in seen["proposals"])
        t0 = time.perf_counter()
        cl, _, cg = loss_and_grads(cpu_model, cfg, cpu_batch, targets=cpu_draws)
        log(f"{tag} vs cpu: cpu reference step {time.perf_counter() - t0:.1f} s")
        ul, _, ug = loss_and_grads(ulp_model, cfg, ulp_batch, targets=cpu_draws)
    finally:
        point_rcnn.proposal_layer = orig
    for k in ("cls_label", "reg_valid_mask"):
        if not torch.equal(seen["card"][k].cpu(), seen["cpu"][k]):
            raise AssertionError(f"{tag} vs cpu: the target layer's {k} differs")
    e_loss, e_norm, leaf = _grad_readings(gl.item(), gg, cl.item(), cg)
    u_loss, u_norm, u_leaf = _grad_readings(ul.item(), ug, cl.item(), cg)
    share, u_share = max(leaf.values()), max(u_leaf.values())
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cg.values())))
    part = {p: (max(v for k, v in leaf.items() if k.startswith(p)),
                float(torch.sqrt(sum((g.double() ** 2).sum() for k, g in cg.items()
                                     if k.startswith(p)))))
            for p in ("rpn.", "rcnn_net.")}
    log(f"{tag} vs cpu: worst leaf / CPU gradient norm of the RPN {part['rpn.'][0]:.2e} / "
        f"{part['rpn.'][1]:.6f}, of the RCNN {part['rcnn_net.'][0]:.2e} / "
        f"{part['rcnn_net.'][1]:.6f}; the worst leaf {max(leaf, key=leaf.get)}")
    log(f"{tag}: the CPU against itself with the input one ulp up: loss rel {u_loss:.2e}, grad "
        f"norm rel {u_norm:.2e}, worst gradient leaf {u_share:.2e} of the global norm "
        f"({max(u_leaf, key=u_leaf.get)})")
    tol = (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_SHARE)
    if not keep:
        tol = tuple(max(t, JOINT_FEW_FG_FACTOR * u) for t, u in zip(tol, (u_loss, u_norm, u_share)))
    log(f"{tag} vs cpu (batch 1, dropout off, {int(gtb['rpn_fg_sum'])} fg points, "
        f"{int(gtb['rcnn_cls_fg'])} fg / {int(gtb['rcnn_cls_bg'])} bg rois, the same proposals, "
        f"RCNN inputs and decisions): loss {gl.item():.6f} vs {cl.item():.6f} (rel {e_loss:.2e}, "
        f"tol {tol[0]:.2e}), grad norm {gnorm:.6f} on the CPU (rel {e_norm:.2e}, tol "
        f"{tol[1]:.2e}), worst gradient leaf {share:.2e} of the global norm (tol {tol[2]:.2e})")
    if e_loss > tol[0] or e_norm > tol[1] or share > tol[2]:
        raise AssertionError(f"the card's {tag} differs from the CPU path")
    return (e_loss, e_norm, share), (u_loss, u_norm, u_share)


def phase_people_joint(card):
    """cfgs/people.yaml's joint step (the RPN and the 3-class RCNN trained
    together, as shipped) at batch 4 x 16384 points: timed, its peak memory,
    every kernel launched (K4 and K8 6 a step, K2 and K7 2), every parameter
    updated, and a batch-1 step against the CPU path on two scenes
    (:func:`_joint_against_cpu`) -> the launches over the timed steps."""
    from pointrcnn_tpu_torch.entry import shipped_config, train_entry

    cfg = shipped_config("people", "joint")
    step, (state, batch) = train_entry(batch=RCNN_BATCH, device="cuda", seed=0, cfg=cfg,
                                       stage="joint")
    state, counts = _timed_steps("people joint step", step, state, batch, JOINT_STEP_LAUNCHES,
                                 ALL_KERNELS, card)
    del step, state, batch
    torch.cuda.empty_cache()
    cpu_cfg = shipped_config("people", "joint", ["RPN.DP_RATIO", "0.0"])
    _joint_against_cpu(cpu_cfg, "people joint step")
    _joint_against_cpu(cpu_cfg, "people joint step, boxes on proposals", keep=False)
    return counts


# ---------------------------------------------------------------- data parallel

# world 2 (gloo, both ranks on this card) against world 1 (nccl) on the
# default rpn step at global batch 16, the bounds of the CPU tests' bf16
# world-2 step (tests/test_torch_parallel_step.py, W1_BF16_TOL): every step's
# loss and gradient norm relative; after the first step (the same weights
# before it) parameters in the mean in 2 lr, BN statistics relative to each
# leaf's largest magnitude.  Adam's first update moves every element by lr
# either way, so the mean in 2 lr is the share of elements whose gradient
# sign the two runs disagree on, and the elementwise departure (logged, not
# held) cannot pass 2 lr.  Later states are not held: at full width each
# update moves a parameter whose gradient is near zero by lr either way, and
# the two runs' weights part further each step.  The first step's loss (the
# same weights on both sides: only the order of the global sums, and the
# bf16 roundings it flips, differ) is held tighter, DP_FIRST_LOSS_RTOL
# (measured on an H100 at 700 W: 8.0e-6; 3.1e-4 with the planted fault below)
DP_STEPS = 3
DP_LOSS_RTOL, DP_GNORM_RTOL, DP_MEAN, DP_STAT = 5e-3, 5e-2, 5e-2, 1e-2
DP_FIRST_LOSS_RTOL = 1e-4
# a planted fault the bounds must fail: world 2 with each rank's batch norms
# on its own rows' statistics (``batch_stats`` as at world 1), the per-replica
# BN of DistributedDataParallel.  torchrun runs it as a script in the work dir
DP_FAULT_SCRIPT = """import sys, types
from pointrcnn_tpu_torch.models import layers
from pointrcnn_tpu_torch.tools import dp_step

per_rank = types.ModuleType("per_rank_mesh")
per_rank.__dict__.update(vars(layers.mesh))
per_rank.world = lambda: 1
layers.mesh = per_rank
dp_step.main(sys.argv[1:])
"""
DP_WORK_DIR = os.path.join(REPO, "pointrcnn_tpu_torch", "_build", "smoke_dp")
DP_TIMEOUT_S = 300


def _torchrun(nproc: int, module: str, args: list, what: str) -> str:
    """``torchrun --standalone --nproc_per_node nproc -m module args`` (a
    ``module`` ending in ``.py``: that script) -> its output; a failure
    raises with its end."""
    target = [module] if module.endswith(".py") else ["-m", module]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *target, *args]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "4"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=DP_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: torchrun exited {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    log(f"{what}: torchrun --nproc_per_node {nproc} ran {time.perf_counter() - t0:.3f} s "
        f"(process start, group, build load, run)")
    return proc.stdout


def _dp_step(nproc, device, backend, what, card, module="pointrcnn_tpu_torch.tools.dp_step"):
    out = os.path.join(DP_WORK_DIR, what.replace(" ", "_"))
    args = ["--out", out, "--batch", str(TRAIN_BATCH), "--steps",
            str(DP_STEPS), "--device", device] + (["--dist_backend", backend] if backend else [])
    _torchrun(nproc, module, args, what)
    first = torch.load(os.path.join(out, "state1.pt"), weights_only=True)
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        rec = ranks[-1]
        log(f"{card}: {what} rank {r} ({rec['backend']} on {rec['device']}, {rec['frames']} "
            f"frames): ms/step [{', '.join(f'{x:.3f}' for x in rec['ms'])}], peak memory "
            f"{rec['peak_bytes'] / 2 ** 30:.3f} GiB, losses "
            f"[{', '.join(f'{x:.6f}' for x in rec['loss'])}], launches {rec['launches']}")
        for name in TRAIN_KERNELS:
            if rec["launches"][name] <= 0:
                raise AssertionError(f"{what} rank {r}: kernel {name} never launched")
        for name, n in RPN_STEP_LAUNCHES.items():
            if rec["launches"][name] != n * DP_STEPS:
                raise AssertionError(f"{what} rank {r}: {name} launched "
                                     f"{rec['launches'][name]} times in {DP_STEPS} steps")
        if rec["frames"] != TRAIN_BATCH // nproc or rec["world"] != nproc:
            raise AssertionError(f"{what} rank {r}: {rec['frames']} frames of world "
                                 f"{rec['world']}")
    if any(r["loss"] != ranks[0]["loss"] for r in ranks):
        raise AssertionError(f"{what}: the ranks' losses differ")
    return ranks, first


def _dp_compare(w1, s1, w2, s2, what):
    """World 2 against world 1: each step's loss and gradient norm, the
    parameters and BN statistics after the first step -> whether they are
    within the DP_* bounds."""
    from pointrcnn_tpu_torch.entry import KITTI_TRAIN_FRAMES, TRAIN_EPOCHS, rpn_config
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer, steps_for

    tx = build_optimizer(rpn_config(), *steps_for(KITTI_TRAIN_FRAMES, TRAIN_BATCH, TRAIN_EPOCHS))
    lr_sum = tx.lr(0)
    e_first = abs(w2["loss"][0] / w1["loss"][0] - 1)
    e_loss = max(abs(a / b - 1) for a, b in zip(w2["loss"], w1["loss"]))
    e_norm = max(abs(a / b - 1) for a, b in zip(w2["grad_norm"], w1["grad_norm"]))
    elem, diffs, stat = 0.0, [], 0.0
    for k, v in s1.items():
        if not v.dtype.is_floating_point:
            continue
        d = (s2[k] - v).abs()
        if k.endswith(("mean", "var")):
            stat = max(stat, float(d.max() / v.abs().max().clamp(min=1e-30)))
        else:
            elem = max(elem, float(d.max()) / lr_sum)
            diffs.append(d.reshape(-1))
    mean = float(torch.cat(diffs).mean()) / (2 * lr_sum)
    gaps = ", ".join(f"{abs(a / b - 1):.2e}" for a, b in zip(w2["grad_norm"], w1["grad_norm"]))
    log(f"data parallel: {what} against world 1 (nccl) over {DP_STEPS} steps: the first "
        f"step's loss rel {e_first:.2e} (tol {DP_FIRST_LOSS_RTOL}), loss rel {e_loss:.2e} (tol "
        f"{DP_LOSS_RTOL}), grad norm rel {e_norm:.2e} (tol {DP_GNORM_RTOL}; by step {gaps}); "
        f"after the first step parameters in the mean {mean:.2e} of 2 lr (tol {DP_MEAN}), "
        f"elementwise {elem:.3f} lr (not held), BN statistics {stat:.2e} (tol {DP_STAT})")
    return e_first <= DP_FIRST_LOSS_RTOL and e_loss <= DP_LOSS_RTOL \
        and e_norm <= DP_GNORM_RTOL and mean <= DP_MEAN and stat <= DP_STAT


def phase_data_parallel(data_root, db, card):
    """Data parallel on the one card: (a) ``entry.dryrun_multichip(2)`` (gloo,
    both ranks on this card: three joint steps, a checkpoint round trip, a
    sharded eval step against one rank's); (b) the default rpn step at global
    batch 16 through torchrun, world 1 under nccl and world 2 under gloo with
    both ranks on cuda:0, every rank launching every kernel of the path, world 2
    within the CPU tests' bf16 bounds of world 1; (c) the train CLI under
    torchrun, rpn at batch 16 for one epoch of the KITTI tree, world 1 nccl and
    world 2 gloo on cuda:0 -> the launches of (a) rank 0 and (b) each rank."""
    from pointrcnn_tpu_torch.entry import dryrun_multichip

    shutil.rmtree(DP_WORK_DIR, ignore_errors=True)
    out = {}
    t0 = time.perf_counter()
    rec = dryrun_multichip(2, device="cuda", timeout_s=DP_TIMEOUT_S, threads=4)
    if rec["backend"] != "gloo" or not rec["device"].startswith("cuda"):
        raise AssertionError(f"dryrun_multichip on one card: {rec}")
    # its mid-size config reaches the kernels whose predicates admit 4096
    # points: the run must have launched on the card, whichever they are
    if not sum(rec["launches"].values()):
        raise AssertionError("dryrun_multichip: rank 0 launched no kernel")
    out["dryrun_rank0"] = rec["launches"]
    log(f"{card}: dryrun_multichip(2) in {time.perf_counter() - t0:.3f} s: {rec}")

    w1, s1 = _dp_step(1, "cuda", None, "dp rpn step world 1", card)
    w2, s2 = _dp_step(2, "cuda:0", "gloo", "dp rpn step world 2", card)
    if w1[0]["backend"] != "nccl" or w2[0]["backend"] != "gloo":
        raise AssertionError(f"data parallel backends {w1[0]['backend']}, {w2[0]['backend']}")
    if not _dp_compare(w1[0], s1, w2[0], s2, "world 2 (gloo, one card)"):
        raise AssertionError("data parallel: world 2 differs from world 1")
    fault = os.path.join(DP_WORK_DIR, "per_rank_bn.py")
    with open(fault, "w") as f:
        f.write(DP_FAULT_SCRIPT)
    wf, sf = _dp_step(2, "cuda:0", "gloo", "dp rpn step world 2 per-rank BN", card, fault)
    if _dp_compare(w1[0], s1, wf[0], sf, "world 2 with per-rank BN statistics (a planted fault)"):
        raise AssertionError("data parallel: the bounds pass world 2 with per-rank BN statistics")
    out["world1_nccl"] = w1[0]["launches"]
    for r, rec in enumerate(w2):
        out[f"world2_gloo_rank{r}"] = rec["launches"]

    common = ["--cfg_file", os.path.join(REPO, "cfgs", "default.yaml"), "--data_root", data_root,
              "--gt_database", db, "--train_mode", "rpn", "--batch_size", str(TRAIN_BATCH),
              "--epochs", "1", "--ckpt_save_interval", "1"]
    losses = {}
    for nproc, device, backend in ((1, "cuda", "nccl"), (2, "cuda:0", "gloo")):
        what = f"train CLI world {nproc} {backend}"
        run_dir = os.path.join(DP_WORK_DIR, f"cli_{nproc}")
        _torchrun(nproc, "pointrcnn_tpu_torch.train", common + [
            "--device", device, "--dist_backend", backend, "--output_dir", run_dir], what)
        with open(os.path.join(run_dir, "log_train.txt")) as f:
            text = f.read()
        line = [x for x in text.splitlines() if "epoch 0:" in x and "last loss" in x]
        if f"process group of {nproc} ranks ({backend})" not in text or len(line) != 1 or \
                not os.path.exists(os.path.join(run_dir, "ckpt", "checkpoint_epoch_1")):
            raise AssertionError(f"{what}: log {text[-2000:]}")
        losses[nproc] = float(line[0].rsplit("last loss", 1)[1])
        log(f"{card}: {what}: {line[0].split('INFO', 1)[-1].strip()}")
    if abs(losses[2] / losses[1] - 1) > DP_LOSS_RTOL:
        raise AssertionError(f"train CLI: world 2's last loss {losses[2]}, world 1's {losses[1]}")
    shutil.rmtree(DP_WORK_DIR, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    # the script's own time after each phase, to see where it goes
    mark = lambda what: log(f"chip_smoke: {what} done at {time.perf_counter() - t0:.1f} s")
    card = phase_card()
    phase_build()
    mark("build")
    tallies = {"fps": check_fps(), "three_nn": check_knn(), "group_gather": check_gather(),
               "fused_group_mlp_max": check_mlp(), "gather_backward": check_gather_bwd(),
               "fused_group_mlp_backward": check_mlp_bwd()}
    tallies["ball_query"], tallies["ball_query_banded"] = check_ballquery()
    bn_tallies = check_bn_train()
    ffps_tally = check_ffps()
    first_k_tally = check_ball_query_first_k()
    mark("kernel checks")
    check_shipped_stages()
    mark("shipped stages")
    for name, shape_rows in check_port_limits().items():
        tallies[name].notes["limit_shapes"] = shape_rows
    mark("port limits")
    launches, train_launches, rcnn_launches = {}, {}, {}
    fwd_ms = phase_default(launches)
    phase_exact()
    mark("default and exact forwards")
    eval_cli_launches = phase_kitti_eval(launches, fwd_ms, card)
    mark("eval CLI")
    ckpt = phase_train(train_launches)
    mark("rpn step")
    try:
        phase_rcnn_train(rcnn_launches, ckpt)
        phase_no_rpn_features(launches, ckpt)
        mark("rcnn step, no RPN features")
        deep_k_launches = phase_deep_k(card, ckpt)
        mark("path K")
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    try:
        train_cli_launches, rpn_ckpt, data_root, db = phase_train_cli(
            train_launches, rcnn_launches, card)
        mark("train CLI")
        offline_launches = phase_offline(launches, data_root, rpn_ckpt, card)
        mark("offline")
        torch.cuda.empty_cache()
        dp_launches = phase_data_parallel(data_root, db, card)
        mark("data parallel")
    finally:
        shutil.rmtree(TRAIN_WORK_DIR, ignore_errors=True)
    try:
        car_2x_launches = phase_car_2x(card)
    finally:
        shutil.rmtree(CAR_2X_WORK_DIR, ignore_errors=True)
    people_launches = phase_people_joint(card)
    mark("car_2x, people")
    wide_launches = phase_wide(card)
    car_2x_exact_launches = phase_car_2x_exact(card)
    mark("paths W, X")
    ssd3d = phase_ssd3d(card)
    mark("3DSSD")
    # launches: the count of the eval forward's run, or for a kernel that
    # only a training stage runs, of that stage's run (the rpn stage's for
    # the gather backward, the rcnn stage's for the MLP backward);
    # train_launches and rcnn_train_launches: each training run's;
    # eval_cli_launches: the eval CLI's rcnn run's (64 frames, 16 batches);
    # train_cli_launches: the train CLI's runs' (rpn 4 steps, its resume 4
    # steps and a val epoch, rcnn 16 steps); offline_launches: the offline
    # recipe's runs' (d_train, d_smallval: the rpn dumps; e: rcnn_offline 16
    # steps and a val epoch; e_processes: the same with worker processes; f:
    # the offline eval, 4 batches); car_2x_launches: car_2x's runs' (eval: two
    # forwards at batch 4; rpn_step, rcnn_step: their timed steps);
    # people_joint_launches: people.yaml's joint step's timed steps';
    # data_parallel_launches: dryrun_multichip's rank 0 (three steps, a resumed
    # step and the eval), the rpn step's world 1 and each world-2 rank (its steps);
    # wide_launches: path W's (WIDE_OVERRIDES) runs' (eval: two forwards at
    # batch 4; rpn_step, rcnn_step: their timed steps); car_2x_exact_launches:
    # path X's two forwards at batch 4; deep_k_launches: path K's
    # (DEEP_K_OVERRIDES) runs' (eval: two forwards at batch 4; rcnn_step: its
    # timed steps)
    rows = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name] if name in EVAL_KERNELS else
             (train_launches[name] if name in TRAIN_KERNELS else rcnn_launches[name]),
             "train_launches": train_launches[name], "rcnn_train_launches": rcnn_launches[name],
             "eval_cli_launches": eval_cli_launches[name],
             "train_cli_launches": {run: c[name] for run, c in train_cli_launches.items()},
             "offline_launches": {run: c[name] for run, c in offline_launches.items()},
             "car_2x_launches": {run: c[name] for run, c in car_2x_launches.items()},
             "people_joint_launches": people_launches[name],
             "data_parallel_launches": {run: c[name] for run, c in dp_launches.items()},
             "wide_launches": {run: c[name] for run, c in wide_launches.items()},
             "car_2x_exact_launches": car_2x_exact_launches["eval"][name],
             "deep_k_launches": {run: c[name] for run, c in deep_k_launches.items()},
             **tallies[name].row()}
            for name, source, replaces in KERNELS]
    # the batch-norm kernels of the training stacks, which replace XLA's
    # fusion of the TPU's SharedMLP layers rather than a pallas_call
    rows += [{"name": name, "route": "cuda", "source": "pointrcnn_tpu_torch/csrc/bn_train.cu",
              "replaces": "pointrcnn_tpu/models/layers.py:219-248 (XLA fusion)",
              "train_launches": train_launches[name],
              "car_2x_launches": {run: c[name] for run, c in car_2x_launches.items()},
              "people_joint_launches": people_launches[name],
              "data_parallel_launches": {run: c[name] for run, c in dp_launches.items()},
              **tally.row()}
             for name, tally in bn_tallies.items()]
    # K9, 3DSSD's F-FPS (no TPU twin); its launches: 3DSSD's timed steps'
    rows.append({"name": "ffps", "route": "cuda", "source": "pointrcnn_tpu_torch/csrc/fps.cu",
                 "replaces": "none: 3DSSD's F-FPS (mmdetection3d's FS / F-FPS samplers)",
                 "ssd3d_launches": ssd3d["launches"]["ffps"], "ssd3d_ms": ssd3d["ms"],
                 **ffps_tally.row()})
    # K10, the exact ball query (no TPU twin: XLA's top_k there); its
    # launches: 3DSSD's timed steps' and path X's two forwards'
    rows.append({"name": "ball_query_first_k", "route": "cuda",
                 "source": "pointrcnn_tpu_torch/csrc/ballquery_first_k.cu",
                 "replaces": "none: the exact query's top_k over order keys "
                             "(pointrcnn_tpu/ops/grouping.py:95)",
                 "ssd3d_launches": ssd3d["launches"]["ball_query_first_k"],
                 "car_2x_exact_launches": car_2x_exact_launches["eval"]["ball_query_first_k"],
                 **first_k_tally.row()})
    log(f"{card}; chip_smoke {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
