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
- per span of the program's trace (:mod:`pointrcnn_tpu_torch.trace`: the
  step, its phases forward / loss + labels / backward / optimizer, in the
  rcnn stage also "targets", the target layer inside the forward; the RPN
  and its SA/FP stages; in the rcnn stage the proposal layer and its NMS,
  RoI pooling and the RCNN; each hand-written kernel's launch) its device
  time between the span's CUDA events, in steps run without the profiler
  and in the profiled ones, and its host time and calls;
- the host syncs by site (``ops.counts``);
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

from pointrcnn_tpu_torch import entry, trace
from pointrcnn_tpu_torch.entry import STAGES, train_entry
from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.profile_forward import _self_device, print_syncs, span_table

ITERS = 3


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

    trace.enable()
    for _ in range(ITERS):
        state, _ = step_fn(state, batch)
    plain = span_table(trace.records(), ITERS)
    trace.reset()
    counts.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        pwall = 1000 * (time.perf_counter() - t0) / ITERS
    spans = span_table(trace.records(), ITERS)
    trace.disable()
    kernel_total, kernels = 0.0, []
    for r in prof.key_averages():
        if r.key in spans:
            continue
        if r.device_type == torch.autograd.DeviceType.CUDA and _self_device(r) > 0:
            ms = _self_device(r) / 1000 / ITERS
            kernel_total += ms
            kernels.append((ms, r.count // ITERS, r.key))
    print(f"profiled step: {pwall:.3f} ms; kernel time {kernel_total:.3f} ms; "
          f"idle share {1 - kernel_total / pwall:.3f} (profiled), "
          f"{1 - kernel_total / wall:.3f} (against the unprofiled step)")
    print("span: device ms per step unprofiled and profiled, host ms, calls (profiled)")
    for name, (dev, host, calls) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {plain.get(name, (float('nan'),))[0]:.3f}, {dev:.3f}, {host:.3f}, "
              f"{calls:g}")
    print_syncs(ITERS, "step")
    print("kernels by device time: ms per step, launches per step, name")
    for ms, n, key in sorted(kernels, reverse=True)[:30]:
        print(f"  {ms:.3f}  {n:4d}  {key[:110]}")


if __name__ == "__main__":
    main()
