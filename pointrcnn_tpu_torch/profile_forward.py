"""Where the eval forward's time goes on the card.

    python3 -m pointrcnn_tpu_torch.profile_forward [--exact]

Builds the forward of :func:`pointrcnn_tpu_torch.entry.entry` (the default
config, or with ``--exact`` the exact-method setting) at batch 4 on a
seeded cloud and, after two warm-up forwards, prints for 3 forwards:

- the wall time of an unprofiled forward (host clock around synchronised
  forwards);
- per stage (RPN SA/FP stages and heads, proposal layer, RoI pooling, RCNN
  SA stages and the rest), the device span between CUDA events recorded
  before and after it, and the device time of the PyTorch ops' kernels it
  launched (``torch.profiler`` range totals; the port's own kernels,
  launched through ``ctypes``, belong to no op and count only in the
  span);
- the kernels by device time, and the device's busy time and idle share
  of the profiled forward.

Every time is per forward, on the card named in the first line.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pointrcnn_tpu_torch.entry import entry, forward, slice_config
from pointrcnn_tpu_torch.models import point_rcnn

BATCH = 4
ITERS = 3


def _stages(model):
    """(name, module) for every stage module of the forward."""
    net = model.rpn.Pointnet2MSG_0
    out = [(f"rpn SA{k + 1}", getattr(net, f"SetAbstractionMSG_{k}")) for k in range(net.n_sa)]
    out += [(f"rpn FP{j + 1}", getattr(net, f"FeaturePropagation_{j}")) for j in range(net.n_fp)]
    out += [("rpn heads", model.rpn.cls_head), ("rpn heads", model.rpn.reg_head)]
    rc = model.rcnn_net
    out += [(f"rcnn SA{k + 1}", getattr(rc, f"SetAbstraction_{k}")) for k in range(3)]
    out += [("rcnn rest", m) for m in (rc.xyz_up_layer, rc.merge_down_layer, rc.cls_head,
                                       rc.reg_head)]
    return out


class _Spans:
    """A record_function range and a pair of CUDA events around each call of
    each stage (default: every stage of the eval forward); ``ms()`` sums the
    event spans per stage name."""

    def __init__(self, model, stages=None):
        self.events = defaultdict(list)
        self._open = []
        for name, mod in stages if stages is not None else _stages(model):
            mod.register_forward_pre_hook(lambda m, a, name=name: self.enter(name))
            mod.register_forward_hook(lambda m, a, o: self.exit())
        for fn in ("proposal_layer", "roipool3d"):
            orig = getattr(point_rcnn, fn)

            def wrapped(*a, _orig=orig, _name=fn.replace("_", " "), **kw):
                with self.span(_name):
                    return _orig(*a, **kw)

            setattr(point_rcnn, fn, wrapped)

    def enter(self, name):
        rf = record_function(name)
        rf.__enter__()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self._open.append((name, rf, start))

    def exit(self):
        name, rf, start = self._open.pop()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rf.__exit__(None, None, None)
        self.events[name].append((start, end))

    @contextlib.contextmanager
    def span(self, name):
        self.enter(name)
        try:
            yield
        finally:
            self.exit()

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in ev) for n, ev in self.events.items()}


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

    spans = _Spans(model)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            forward(model, batch)
        torch.cuda.synchronize()
        pwall = 1000 * (time.perf_counter() - t0) / ITERS
    span_ms = spans.ms()
    rows = prof.key_averages()
    names = set(span_ms)
    kernel_total, kernels = 0.0, []
    stage_kernel_ms = {}
    for r in rows:
        if r.key in names:
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
    print("stage: device span ms, PyTorch-op kernel ms (per forward)")
    for name, ms in sorted(span_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms / ITERS:.3f},{stage_kernel_ms.get(name, float('nan')):.3f}")
    print("kernels by device time: ms per forward, launches per forward, name")
    for ms, n, key in sorted(kernels, reverse=True)[:25]:
        print(f"  {ms:.3f}  {n:4d}  {key[:110]}")


if __name__ == "__main__":
    main()
