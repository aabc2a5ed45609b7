"""Where a training step's time goes on the card.

    python3 -m pointrcnn_tpu_torch.profile_train [--stage rpn|rcnn] [--overrides NAME]

Drives the train step of :func:`pointrcnn_tpu_torch.entry.train_entry`:
the ``rpn`` stage (``cfgs/default.yaml`` with ``RCNN.ENABLED`` False) at
batch 16, or the ``rcnn`` stage (a fixed RPN, online proposals and targets)
at batch 4, x 16384 points on a seeded scene (``--overrides``: one of the
entry module's override lists added, e.g. ``DEEP_K_OVERRIDES`` for path
K) and, after two warm-up steps, prints for 3 steps:

- the wall time of an unprofiled step (host clock around synchronised
  steps) and the peak device memory of a step;
- per phase of the step (the ``train.state.phase`` ranges: forward, loss
  with the labels, backward, optimizer; in the rcnn stage also "targets",
  the target layer inside the forward) the device span between CUDA
  events recorded before and after it, and per forward stage (RPN SA/FP
  stages and heads; in the rcnn stage also the proposal layer and the RCNN
  stages) its span likewise, in steps run without the profiler and in the
  profiled ones;
- the kernels by device time, and the device's busy time and idle share
  of the profiled step.

Every time is per step, on the card named in the first line.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pointrcnn_tpu_torch import entry
from pointrcnn_tpu_torch.entry import STAGES, train_entry
from pointrcnn_tpu_torch.models import point_rcnn
from pointrcnn_tpu_torch.profile_forward import _Spans, _self_device, _stages
from pointrcnn_tpu_torch.train import state as train_state

ITERS = 3


def _rpn_stages(model):
    net = model.rpn.Pointnet2MSG_0
    out = [(f"rpn SA{k + 1}", getattr(net, f"SetAbstractionMSG_{k}")) for k in range(net.n_sa)]
    out += [(f"rpn FP{j + 1}", getattr(net, f"FeaturePropagation_{j}")) for j in range(net.n_fp)]
    return out + [("rpn heads", model.rpn.cls_head), ("rpn heads", model.rpn.reg_head)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=sorted(STAGES), default="rpn")
    ap.add_argument("--overrides", default=None,
                    help="an override list of pointrcnn_tpu_torch.entry, e.g. DEEP_K_OVERRIDES")
    args = ap.parse_args()
    stage = args.stage
    make_cfg, BATCH = STAGES[stage]
    cfg = make_cfg(getattr(entry, args.overrides) if args.overrides else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; {stage} train step{' + ' + args.overrides if args.overrides else ''}, "
          f"batch {BATCH}, {ITERS} steps")
    step_fn, (state, batch) = train_entry(batch=BATCH, device="cuda", seed=0, cfg=cfg,
                                          stage=stage)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0) / ITERS
    print(f"unprofiled step: {wall:.3f} ms ({1000 * BATCH / wall:.3f} frames/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    stages = _stages(state.model) if stage == "rcnn" else _rpn_stages(state.model)
    spans = _Spans(state.model, stages)
    train_state.phase = point_rcnn.phase = spans.span
    for _ in range(ITERS):
        state, _ = step_fn(state, batch)
    plain_span_ms = spans.ms()
    spans.events.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        pwall = 1000 * (time.perf_counter() - t0) / ITERS
    span_ms = spans.ms()
    names = set(span_ms)
    kernel_total, kernels = 0.0, []
    for r in prof.key_averages():
        if r.key in names:
            continue
        if r.device_type == torch.autograd.DeviceType.CUDA and _self_device(r) > 0:
            ms = _self_device(r) / 1000 / ITERS
            kernel_total += ms
            kernels.append((ms, r.count // ITERS, r.key))
    print(f"profiled step: {pwall:.3f} ms; kernel time {kernel_total:.3f} ms; "
          f"idle share {1 - kernel_total / pwall:.3f} (profiled), "
          f"{1 - kernel_total / wall:.3f} (against the unprofiled step)")
    print("phase or forward stage: device span ms per step, unprofiled and profiled")
    for name, ms in sorted(span_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {plain_span_ms[name] / ITERS:.3f}, {ms / ITERS:.3f}")
    print("kernels by device time: ms per step, launches per step, name")
    for ms, n, key in sorted(kernels, reverse=True)[:30]:
        print(f"  {ms:.3f}  {n:4d}  {key[:110]}")


if __name__ == "__main__":
    main()
