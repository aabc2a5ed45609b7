"""Where the eval forward's time goes on the card.

    python3 -m pointrcnn_tpu_torch.profile_forward [--exact]

Builds the forward of :func:`pointrcnn_tpu_torch.entry.entry` (the default
config, or with ``--exact`` the exact-method setting) at batch 4 on a
seeded cloud and, after two warm-up forwards, prints for 3 forwards:

- the wall time of an unprofiled forward (host clock around synchronised
  forwards);
- per span of the program's trace (:mod:`pointrcnn_tpu_torch.trace`: the
  RPN and its SA/FP stages, the proposal layer and its NMS, RoI pooling,
  the RCNN, each hand-written kernel's launch), its device time between
  the span's CUDA events, its host time, its calls, and the device time of
  the PyTorch ops' kernels it launched (``torch.profiler`` range totals;
  the port's own kernels, launched through ``ctypes``, belong to no op and
  count only in their launch spans);
- the host syncs by site (``ops.counts``);
- the kernels by device time, and the device's busy time and idle share
  of the profiled forward.

Every time is per forward, on the card named in the first line.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.entry import entry, forward, slice_config
from pointrcnn_tpu_torch.ops import counts

BATCH = 4
ITERS = 3


def span_table(records, iters: int) -> dict:
    """{span name: (device ms, host ms, calls)} per iteration, from the
    trace's records."""
    out = defaultdict(lambda: [0.0, 0.0, 0])
    for r in records:
        row = out[r.name]
        row[0] += r.device_ms() or 0.0
        row[1] += (r.host_end_ns - r.host_start_ns) / 1e6
        row[2] += 1
    return {n: (d / iters, h / iters, c / iters) for n, (d, h, c) in out.items()}


def print_syncs(iters: int, what: str) -> None:
    syncs = counts.read_syncs()
    total = sum(n for n, _ in syncs.values())
    print(f"host syncs: {total / iters:.1f} per {what}, waiting "
          f"{sum(w for _, w in syncs.values()) / 1e6 / iters:.3f} ms")
    for site, (n, wait) in sorted(syncs.items(), key=lambda kv: -kv[1][1]):
        print(f"  {site}: {n / iters:.1f}, {wait / 1e6 / iters:.3f} ms")


def _device_total(row):
    return getattr(row, "device_time_total", None) or getattr(row, "cuda_time_total", 0.0)


def _self_device(row):
    return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exact", action="store_true", help="the exact-method setting")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    setting = "exact" if args.exact else "default"
    print(f"{card}; {setting} forward, batch {BATCH}, {ITERS} forwards")

    fwd, (model, batch) = entry(batch=BATCH, device="cuda", seed=0,
                                cfg=slice_config() if args.exact else None)
    for _ in range(2):
        fwd(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        forward(model, batch)
    torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0) / ITERS
    print(f"unprofiled forward: {wall:.3f} ms")

    trace.enable()
    counts.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            forward(model, batch)
        torch.cuda.synchronize()
        pwall = 1000 * (time.perf_counter() - t0) / ITERS
    spans = span_table(trace.records(), ITERS)
    trace.disable()
    rows = prof.key_averages()
    kernel_total, kernels = 0.0, []
    stage_kernel_ms = {}
    for r in rows:
        if r.key in spans:
            if r.device_type == torch.autograd.DeviceType.CPU:
                stage_kernel_ms[r.key] = _device_total(r) / 1000 / ITERS
            continue
        if r.device_type == torch.autograd.DeviceType.CUDA and _self_device(r) > 0:
            ms = _self_device(r) / 1000 / ITERS
            kernel_total += ms
            kernels.append((ms, r.count // ITERS, r.key))
    print(f"profiled forward: {pwall:.3f} ms; kernel time {kernel_total:.3f} ms; "
          f"idle share {1 - kernel_total / pwall:.3f} (profiled), "
          f"{1 - kernel_total / wall:.3f} (against the unprofiled forward)")
    print("span: device ms, host ms, calls, PyTorch-op kernel ms (per forward)")
    for name, (dev, host, calls) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {dev:.3f}, {host:.3f}, {calls:g}, "
              f"{stage_kernel_ms.get(name, float('nan')):.3f}")
    print_syncs(ITERS, "forward")
    print("kernels by device time: ms per forward, launches per forward, name")
    for ms, n, key in sorted(kernels, reverse=True)[:25]:
        print(f"  {ms:.3f}  {n:4d}  {key[:110]}")


if __name__ == "__main__":
    main()
