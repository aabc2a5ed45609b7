"""Audit of the program's own tracing on one benchmark cell, on the card.

    python benchmark/trace_audit.py --workload <cell> --seed <n> [--steps 3]

Builds the cell's driver as ``run.py`` does (set-up included), then:

- **syncs**: runs ``--steps`` steps under
  ``torch.cuda.set_sync_debug_mode("warn")`` and takes every synchronising
  call's warning with its Python stack.  A warning whose stack holds a
  frame of ``pointrcnn_tpu_torch`` is the program's, named by its innermost
  such frame and by the ``ops.counts.sync`` site open around it (the audit
  wraps ``counts.sync`` to know it); the others are the driver's (upload,
  fetch, loss read).  Beside them, the program's own counters over the same
  steps (``counts.read_syncs``);
- **clock**: with the trace on, profiles ``--steps`` steps and holds each
  span's record against the profiler's range of the same name: its host
  start inside the range, and its device interval, converted through the
  trace's anchors, against the device work launched inside the range
  (within ``TOL_US``); and each step's least gap between a span's device
  and host starts;
- **witness**: single FPS launches (K1) on an idle card, each between two
  synchronises, the profiler off: the launch span's device interval has to
  lie between the host's clock read before the call and after the
  synchronise, and to match the call's own CUDA events;
- **gaps**: the ten longest idle gaps of the profiled steps
  (``harness/trace.py::summarize``), each with the innermost program span
  and the innermost host range around its middle;
- **cost**: steps with the trace off and on, alternating, one span's host
  cost off and on, and the host syncs a step by site with the host's wait
  there (outside the warning mode, which slows every sync).

Prints one JSON line last; ``--out`` also writes it to a file.  On a
program without ``pointrcnn_tpu_torch.trace`` (or without
``counts.read_syncs``) the parts that need them are left out.
"""

import argparse
import collections
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time
import traceback
import warnings

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
PKG = f"{os.sep}pointrcnn_tpu_torch{os.sep}"
TOL_US = 50.0
SYNC_MESSAGE = "synchronizing CUDA operation"


def _where(fr) -> str:
    path = fr.filename.split(PKG, 1)[1] if PKG in fr.filename else fr.filename
    return f"{path}:{fr.lineno} {fr.name}"


def audit_syncs(d, steps: int, counts) -> dict:
    """Every synchronising call of ``steps`` steps, by where it was made and
    by the counted site open around it."""
    import torch

    has_counter = hasattr(counts, "read_syncs")
    seen, open_sites = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            stack = traceback.extract_stack()[:-1]
            prog = [f for f in stack if PKG in f.filename]
            seen.append((prog[-1] if prog else None, open_sites[-1] if open_sites else None,
                         stack))

    if has_counter:
        counts.reset()
        enter, leave = counts.sync.__enter__, counts.sync.__exit__

        def sync_enter(self):
            open_sites.append(self.site)
            return enter(self)

        def sync_exit(self, *exc):
            open_sites.pop()
            return leave(self, *exc)

        counts.sync.__enter__, counts.sync.__exit__ = sync_enter, sync_exit
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i in range(steps):
                    d.one(i)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        if has_counter:
            counts.sync.__enter__, counts.sync.__exit__ = enter, leave
    program, by_site, uncounted, driver = (collections.Counter() for _ in range(4))
    for fr, site, stack in seen:
        if fr is None:
            outer = [f for f in stack
                     if str(BENCH) in f.filename and "trace_audit" not in f.filename]
            driver[_where(outer[-1] if outer else stack[-1])] += 1
        elif site is None:
            program[_where(fr)] += 1
            uncounted[_where(fr)] += 1
        else:
            program[_where(fr)] += 1
            by_site[site] += 1
    out = {"steps": steps, "program_warnings": sum(program.values()),
           "driver_warnings": sum(driver.values()),
           "program_by_frame": dict(program.most_common()),
           "driver_by_frame": dict(driver.most_common()),
           "warnings_by_site": dict(by_site), "uncounted": dict(uncounted.most_common())}
    if has_counter:
        syncs = counts.read_syncs()
        out["counter_by_site"] = {k: c for k, (c, _) in syncs.items()}
        out["counter_total"] = sum(c for c, _ in syncs.values())
        out["counter_wait_ms"] = {k: w / 1e6 for k, (_, w) in syncs.items()}
        out["complete"] = (not uncounted and out["counter_total"] == out["program_warnings"]
                           and out["counter_by_site"] == dict(by_site))
    return out


def _profile(d, steps: int):
    """The profiler's events of ``steps`` steps, and the host clock read
    beside a range opened after them (the calibration)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            d.one(None)
        torch.cuda.synchronize()
        t_host = time.perf_counter_ns()
        with torch.profiler.record_function("trace_audit.clock"):
            pass
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], t_host
    finally:
        os.unlink(path)


def _device_of_ranges(events, device_cats):
    """(host launch ts, thread, device start, device end) of every device
    operation, by the correlation of its launch (cuda_runtime / cuda_driver
    events)."""
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = (e["ts"], e.get("tid"))
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in device_cats:
            c = (e.get("args") or {}).get("correlation")
            if c in launches:
                dev.append((*launches[c], e["ts"], e["ts"] + e["dur"]))
    return dev


def clock_check(d, steps: int, trace, device_cats) -> tuple:
    """Each span's record against the profiler's range of the same name,
    the profiler's host clock mapped onto ``perf_counter_ns`` by one range
    opened after the steps.

    - host: the span's host start lies inside its range;
    - device: its device interval, converted through the trace's anchors,
      holds the device work launched inside the range (the profiler's
      device timestamps as CUPTI maps them onto its host clock), and starts
      no earlier than the range;
    - idle starts: each step's least ``device start - host start``, which
      on an idle card is a few us."""
    trace.reset()
    trace.enable()
    events, t_host = _profile(d, steps)
    recs = trace.records()
    trace.disable()
    ranges = collections.defaultdict(list)
    calib = None
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            if e["name"] == "trace_audit.clock":
                calib = e["ts"]
            else:
                ranges[e["name"]].append(e)
    offset = calib - t_host / 1e3  # profiler us = host ns / 1e3 + offset
    dev = _device_of_ranges(events, device_cats)
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append(r)
    worst_host = worst_dev = 0.0
    checked = 0
    bad = []
    for name, rs in by_name.items():
        rg = sorted(ranges.get(name, []), key=lambda e: e["ts"])
        if len(rg) != len(rs):
            bad.append(f"{name}: {len(rs)} records, {len(rg)} ranges")
            continue
        for r, e in zip(sorted(rs, key=lambda r: r.host_start_ns), rg):
            checked += 1
            hs = r.host_start_ns / 1e3 + offset
            out = max(0.0, e["ts"] - hs, hs - (e["ts"] + e["dur"]))
            worst_host = max(worst_host, out)
            inside = [(s, t) for lt, tid, s, t in dev
                      if e["ts"] <= lt <= e["ts"] + e["dur"] and tid == e.get("tid")]
            if r.device_start_ns is None or not inside:
                continue
            d0 = r.device_start_ns / 1e3 + offset
            d1 = r.device_end_ns / 1e3 + offset
            err = max(0.0, d0 - min(s for s, _ in inside), max(t for _, t in inside) - d1,
                      e["ts"] - d0)
            worst_dev = max(worst_dev, err)
            if err > TOL_US or out > TOL_US:
                bad.append(f"{name}: host {out:.1f} us, device {err:.1f} us")
    idle = collections.defaultdict(list)
    for r in recs:
        if r.device_start_ns is not None:
            idle[r.root].append((r.device_start_ns - r.host_start_ns) / 1e3)
    idle_starts = [min(v) for _, v in sorted(idle.items())]
    return {"spans_checked": checked, "worst_host_us": worst_host,
            "worst_device_us": worst_dev, "within_tol": not bad and checked > 0,
            "faults": bad[:20], "idle_start_us": idle_starts}, events, recs


def witness(trace, reps: int = 20) -> dict:
    """Single FPS launches (K1, 4 x 16384 points -> 4096) on an idle card,
    the profiler off.  Around each call: the host clock, then an event; after
    it an event, a synchronise, the host clock.  The wrapper launches nothing
    but the kernel, inside its ``fps`` span, so the span's device interval
    (through the trace's anchors) has to start after the first clock read
    (``start_after_host_us`` >= 0: the host's work in the call before the
    launch comes in between), end before the second and within ``TOL_US`` of
    it (``end_before_sync_us``: the synchronise's wake-up), and lie inside
    the call's own events (``own_minus_span_us`` >= 0, on the card's clock
    alone)."""
    import torch

    from pointrcnn_tpu_torch.ops.cuda_fps import furthest_point_sample

    g = torch.Generator(device="cuda").manual_seed(0)
    xyz = 40.0 * torch.rand((4, 16384, 3), generator=g, device="cuda")
    furthest_point_sample(xyz, 4096)
    brackets = []
    trace.reset()
    trace.enable()
    for _ in range(reps):
        torch.cuda.synchronize()
        own = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter_ns()
        own[0].record()
        furthest_point_sample(xyz, 4096)
        own[1].record()
        torch.cuda.synchronize()
        brackets.append((t0, time.perf_counter_ns(), own[0].elapsed_time(own[1])))
    recs = [r for r in trace.records() if r.name == "fps"]
    trace.disable()
    trace.reset()
    after = [(r.device_start_ns - t0) / 1e3 for r, (t0, _, _) in zip(recs, brackets)]
    before = [(t1 - r.device_end_ns) / 1e3 for r, (_, t1, _) in zip(recs, brackets)]
    own_minus = [1e3 * own_ms - r.device_ms() * 1e3 for r, (_, _, own_ms) in zip(recs, brackets)]
    return {"launches": len(recs), "kernel_ms_median": statistics.median(
                r.device_ms() for r in recs),
            "start_after_host_us": [min(after), max(after)],
            "end_before_sync_us": [min(before), max(before)],
            "own_minus_span_us": [min(own_minus), max(own_minus)],
            "within": len(recs) == reps and min(after) >= 0 and min(before) >= 0
                      and max(before) <= TOL_US and min(own_minus) >= 0}


def gaps(events, names, summarize, device_cats) -> list:
    """The ten longest idle gaps, each named by the innermost host range and
    by the innermost program span (``names``) around its middle."""
    ends = [e for e in events if e.get("ph") == "X"]
    prog = [e for e in ends if e.get("cat") in device_cats
            or (e.get("cat") == "user_annotation" and e["name"] in names)]
    host = summarize(ends, 0.0)["idle_gaps"]
    mine = summarize(prog, 0.0)["idle_gaps"]
    return [{"us": 1e6 * s, "host_range": h, "program_span": p}
            for (h, s), (p, _) in zip(host, mine)]


def cost(d, steps: int, trace, counts) -> dict:
    """Step time with the trace off and on (alternating), and one span's
    host cost off and on."""
    import torch

    off, on = [], []
    counts.reset()
    for k in range(2 * steps):
        enabled = k % 2 == 1
        if enabled:
            trace.reset()
            trace.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.one(None)
        torch.cuda.synchronize()
        (on if enabled else off).append(1e3 * (time.perf_counter() - t0))
        if enabled:
            n_spans = len(trace.records())
            trace.disable()
    syncs = {site: (n / (2 * steps), wait / 1e6 / (2 * steps))
             for site, (n, wait) in counts.read_syncs().items()}
    reps = 2000

    def per_span_us():
        t0 = time.perf_counter()
        for _ in range(reps):
            with trace.span("trace_audit.cost"):
                pass
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / reps

    trace.reset()
    span_off = per_span_us()
    trace.enable()
    span_on = per_span_us()
    trace.disable()
    trace.reset()
    return {"step_ms_off": statistics.median(off), "step_ms_on": statistics.median(on),
            "steps_each": steps, "spans_a_step": n_spans,
            "span_us_off": span_off, "span_us_on": span_on, "syncs_a_step": syncs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cost_steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import drivers, spec
    from benchmark.harness.trace import DEVICE_CATS, summarize
    from pointrcnn_tpu_torch.config import load_config
    from pointrcnn_tpu_torch.ops import counts

    try:
        from pointrcnn_tpu_torch import trace
    except ImportError:
        trace = None
    if not torch.cuda.is_available():
        print("trace_audit: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    cfg = load_config(str(cell.config_path), list(cell.traffic.get("overrides", [])))
    d = drivers.DRIVERS[cell.traffic["step"]](cell, cfg, args.seed, "cuda")
    d.setup()
    torch.cuda.synchronize()
    result = {"workload": args.workload, "seed": args.seed,
              "syncs": audit_syncs(d, args.steps, counts)}
    if trace is not None:
        result["clock"], events, recs = clock_check(d, args.steps, trace, DEVICE_CATS)
        result["witness"] = witness(trace)
        names = {r.name for r in recs}
        result["records_a_step"] = statistics.median(
            collections.Counter(r.root for r in recs).values())
        result["cost"] = cost(d, args.cost_steps, trace, counts)
    else:
        events, _ = _profile(d, args.steps)
        names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    result["gaps"] = gaps(events, names, summarize, DEVICE_CATS)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
