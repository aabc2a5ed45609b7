"""The device trace of a traced run: busy time, idle share and breakdown.

``torch.profiler`` (CUPTI) records every kernel, memcpy and memset on the
card, the port's ctypes-launched kernels among them under their CUDA names,
and the host's ranges (the benchmark's spans and PyTorch ops).  The trace
is exported as Chrome JSON under ``TMPDIR``, read, and deleted.

- ``busy_s``: the union of the device intervals in the profiled window;
- ``window_s``: the profiled window's wall time (host clock, first step
  handed in to last step synchronised);
- ``device_ops``: the ten device operations with the most total time;
- ``idle_gaps``: the ten longest gaps between device intervals, each named
  by the innermost host range that spans its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def profiled(run_steps, steps: int) -> dict:
    """Profile ``run_steps(steps)`` (which ends synchronised) -> the trace's
    summary (see the module docstring)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, window_s)


def summarize(events: list, window_s: float) -> dict:
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    by_name = defaultdict(float)
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, name in dev:
        by_name[name] += e - s
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
        idle.append([min(inner)[1] if inner else "(no host range)", length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "device_ops": [[name, us * 1e-6] for name, us in ops], "idle_gaps": idle}
