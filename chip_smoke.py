#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port runs on the card.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero and the final ``ok`` line is not printed):

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build the four hand-written kernels from ``pointrcnn_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card at the
   slice's own shapes and time both;
4. drive the slice (``pointrcnn_tpu_torch.entry``: the two-stage eval
   forward of ``cfgs/default.yaml`` with the exact-method overrides) at
   batch 4 x 16384 points on seeded clouds, check shapes, finiteness and
   that every kernel launched; hold a batch-1 forward against the port's
   plain path on the CPU; time frames/s.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4
CLOUD_SEEDS = (0, 1, 2)
TIMED_ITERS = 10

# bf16-path tolerance of the fused MLP kernel against its plain version on
# the same operands: both multiply bf16 values exactly and accumulate in
# f32, but in another order, so a hidden activation can round to the
# neighbouring bf16 value (2^-8 relative) and carry that into the next
# layer; the bound is relative to the output's largest magnitude
MLP_REL_TOL = 2.0 ** -8


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

    for name, flags in (("fps", _build.NO_FMAD), ("knn", _build.NO_FMAD),
                        ("gather", _build.NO_FMAD), ("mlp", ())):
        t0 = time.perf_counter()
        _build.load(name, flags)
        log(f"build {name}.cu: {time.perf_counter() - t0:.2f} s")


def _rpn_cloud(b, n, seed):
    from pointrcnn_tpu_torch.entry import synthetic_cloud

    return torch.from_numpy(synthetic_cloud(b, n, seed)).cuda()


def _roi_cloud(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, n, 3), generator=g) * torch.tensor([4.0, 2.0, 6.0]) - 2.0).cuda()


def check_fps():
    from pointrcnn_tpu_torch.ops import cuda_fps

    err, ms, plain_ms = 0.0, 0.0, 0.0
    for (b, n, npoint, cloud) in ((4, 16384, 4096, _rpn_cloud), (4, 4096, 1024, _rpn_cloud),
                                  (4, 1024, 256, _rpn_cloud), (4, 256, 64, _rpn_cloud),
                                  (400, 512, 128, _roi_cloud), (400, 128, 32, _roi_cloud)):
        xyz = cloud(b, n, n)
        got = cuda_fps._launch(xyz, npoint)
        ref = cuda_fps.furthest_point_sample_plain(xyz, npoint)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps {b}x{n}->{npoint}: {(got != ref).sum().item()} picks differ")
        k = cuda_ms(lambda: cuda_fps._launch(xyz, npoint), 5)
        p = cuda_ms(lambda: cuda_fps.furthest_point_sample_plain(xyz, npoint), 1)
        ms, plain_ms = ms + k, plain_ms + p
        log(f"fps {b}x{n}->{npoint}: exact match; kernel {k:.4f} ms, plain {p:.4f} ms")
    # a ragged row length (masked threads), off the slice's shapes
    xyz = _roi_cloud(3, 1000, 1)
    if not torch.equal(cuda_fps._launch(xyz, 77), cuda_fps.furthest_point_sample_plain(xyz, 77)):
        raise AssertionError("fps 3x1000->77 differs")
    log("fps 3x1000->77: exact match")
    return err, ms, plain_ms


def check_knn():
    from pointrcnn_tpu_torch.ops import cuda_knn

    err, ms, plain_ms = 0.0, 0.0, 0.0
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
        ms, plain_ms = ms + k, plain_ms + p
        log(f"three_nn B={BATCH} n={n} m={m}: exact match; kernel {k:.4f} ms, plain {p:.4f} ms")
    return err, ms, plain_ms


def check_gather():
    from pointrcnn_tpu_torch.ops import cuda_gather

    err, ms, plain_ms = 0.0, 0.0, 0.0
    g = torch.Generator().manual_seed(7)
    xyz = _rpn_cloud(BATCH, 4096, 11)
    feats = torch.randn((BATCH, 4096, 96), generator=g).cuda()
    cent = xyz[:, :1024] + 0.1
    for K in (16, 32):
        idx = torch.randint(0, 4096, (BATCH, 1024, K), generator=g, dtype=torch.int32).cuda()
        got = cuda_gather._launch(xyz, feats, cent, idx)
        ref = cuda_gather.group_points_plain(xyz, feats, cent, idx)
        if not torch.equal(got, ref):
            raise AssertionError(f"gather K={K}: {(got != ref).sum().item()} values differ")
        k = cuda_ms(lambda: cuda_gather._launch(xyz, feats, cent, idx), 20)
        p = cuda_ms(lambda: cuda_gather.group_points_plain(xyz, feats, cent, idx), 5)
        ms, plain_ms = ms + k, plain_ms + p
        log(f"gather N=4096 C=96 S=1024 K={K}: exact match; kernel {k:.4f} ms, plain {p:.4f} ms")
    return err, ms, plain_ms


# (name, B, N, C, S, K, widths, slice mode, cloud): the four SA shapes
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

    err, ms, plain_ms = 0.0, 0.0, 0.0
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
            p = cuda_ms(lambda: cuda_mlp.fused_group_plain(fold, *ops[:1], xyz, *ops[1:], idx), 3)
            tag = " (slice mode)" if mode == slice_mode else ""
            log(f"fused mlp {name} B={B} N={N} C={C} S={S} K={K} {widths} {mode}{tag}: "
                f"max err {e:.3e} (scale {scale:.3e}, tol {MLP_REL_TOL} x scale); "
                f"kernel {k:.4f} ms, plain {p:.4f} ms")
            err = max(err, e)
            if mode == slice_mode:
                ms, plain_ms = ms + k, plain_ms + p
    # off the slice's shapes: K padded 8 -> 16, a ragged last block of
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
    return err, ms, plain_ms


def phase_slice(results):
    from pointrcnn_tpu_torch.entry import entry, synthetic_cloud
    from pointrcnn_tpu_torch.ops import cuda_fps, cuda_gather, cuda_knn, cuda_mlp

    modules = {"fps": cuda_fps, "three_nn": cuda_knn, "group_gather": cuda_gather,
               "fused_group_mlp_max": cuda_mlp}
    fwd, (model, _) = entry(batch=BATCH, device="cuda", seed=0)
    cfg = model.cfg
    clouds = [torch.from_numpy(synthetic_cloud(BATCH, cfg.RPN.NUM_POINTS, s)).cuda()
              for s in CLOUD_SEEDS]

    for mod in modules.values():
        mod.launches = 0
    outs = [fwd(model, {"pts_input": pts}) for pts in clouds]
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, mod in modules.items()}
    log(f"slice forward x{len(clouds)} launches: {counts}")

    M = cfg.TEST.RPN_POST_NMS_TOP_N
    for s, out in zip(CLOUD_SEEDS, outs):
        shapes = {k: tuple(out[k].shape) for k in ("rois", "rcnn_cls", "rcnn_reg")}
        if shapes["rois"] != (BATCH, M, 7) or shapes["rcnn_cls"] != (BATCH * M, 1) \
                or shapes["rcnn_reg"][0] != BATCH * M:
            raise AssertionError(f"cloud {s}: bad output shapes {shapes}")
        for k in ("rpn_cls", "rpn_reg", "rois", "rcnn_cls", "rcnn_reg"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"cloud {s}: non-finite {k}")
        log(f"cloud {s}: shapes {shapes}, finite, {int(out['roi_valid'].sum())} valid rois")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the slice path")
        results[name]["launches"] = n

    check_against_cpu(model, synthetic_cloud(1, cfg.RPN.NUM_POINTS, 5))

    batch = {"pts_input": clouds[0]}
    fwd(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        out = fwd(model, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"slice forward batch {BATCH}: {BATCH * TIMED_ITERS / dt:.3f} frames/s "
        f"({1000 * dt / TIMED_ITERS:.3f} ms per batch, {TIMED_ITERS} iterations after 1 warm-up)")


def check_against_cpu(model, cloud):
    """Batch-1 forward on the card against the port's plain path on the CPU
    (the path the CPU tests hold against JAX), same weights and cloud."""
    import copy

    from pointrcnn_tpu_torch.entry import forward

    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    ref = forward(cpu_model, {"pts_input": torch.from_numpy(cloud)})
    log(f"cpu reference forward: {time.perf_counter() - t0:.1f} s")
    got = {k: v.cpu() for k, v in forward(model, {"pts_input": torch.from_numpy(cloud).cuda()}).items()}
    if not torch.equal(got["backbone_xyz"], ref["backbone_xyz"]):
        raise AssertionError("backbone_xyz differs from the CPU reference")
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        e = (got[k] - ref[k]).abs().max().item()
        scale = ref[k].abs().max().item()
        log(f"vs cpu {k}: max err {e:.3e} (scale {scale:.3e})")
        if e > 0.05 * scale:
            raise AssertionError(f"{k} differs from the CPU reference by {e} (scale {scale})")
    same = (got["rois"] - ref["rois"]).abs().amax(-1) < 1e-3
    frac = same.float().mean().item()
    log(f"vs cpu rois: {frac:.3f} of rois agree within 1e-3")
    if frac < 0.9:
        raise AssertionError(f"only {frac:.3f} of rois agree with the CPU reference")
    sel = same.reshape(-1)
    for k in ("rcnn_cls", "rcnn_reg"):
        e = (got[k][sel] - ref[k][sel]).abs().max().item()
        scale = ref[k][sel].abs().max().item()
        log(f"vs cpu {k} on agreeing rois: max err {e:.3e} (scale {scale:.3e})")
        if e > 0.05 * scale + 1e-6:
            raise AssertionError(f"{k} differs from the CPU reference by {e} (scale {scale})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    phase_card()
    phase_build()
    results = {}
    for name, fn, source, replaces in (
        ("fps", check_fps, "pointrcnn_tpu_torch/csrc/fps.cu",
         "pointrcnn_tpu/ops/pallas_fps.py:34"),
        ("three_nn", check_knn, "pointrcnn_tpu_torch/csrc/knn.cu",
         "pointrcnn_tpu/ops/pallas_knn.py:25"),
        ("group_gather", check_gather, "pointrcnn_tpu_torch/csrc/gather.cu",
         "pointrcnn_tpu/ops/pallas_gather.py:69"),
        ("fused_group_mlp_max", check_mlp, "pointrcnn_tpu_torch/csrc/mlp.cu",
         "pointrcnn_tpu/ops/pallas_mlp.py:84"),
    ):
        err, ms, plain_ms = fn()
        results[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    phase_slice(results)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
