"""The program's own spans and host-sync counts, as the readers of the
per-layer metrics that read them see them (``pointrcnn_tpu_torch/trace.py``).

The program's trace stays off through the window and the profiled steps,
so every other metric of a traced run times the program as an untraced run
runs it (with the trace on, each span records two CUDA events and a record,
which the host-paced layers' spans would count).  The first reader's
``install`` runs :data:`STEPS` steps with the trace on instead, after
set-up and before the window (on the pools' cycle: a whole number of
passes over each cell's pool of batches, so the window starts at the
batch it would start at), and drops what the benchmark's own spans
recorded in them; every reader reads those steps: the roots of the step's
name and the records under them.  On a program without the trace module
every function gives None, runs no step and raises nothing.
"""

from __future__ import annotations

try:
    from pointrcnn_tpu_torch import trace
except ImportError:  # a program without its own tracing
    trace = None

# steps traced before the window: about 1.6 s of eval batches and 3 s of
# rcnn-stage steps at batch 4 on the H100; two passes over the eval pool
# (16 batches), four over the train pools (8)
STEPS = 32


def trace_steps(d) -> None:
    """Run the traced steps once (a reader's ``install``)."""
    if trace is None or hasattr(d, "program_records"):
        return
    trace.reset()
    trace.enable()
    try:
        d.extra(STEPS)
    finally:
        trace.disable()
    d.program_records = trace.records()
    trace.reset()
    spans = getattr(d, "spans", None)
    if spans is not None:  # the benchmark's spans time the window only
        spans.clear()


def traced(d, root: str):
    """(the roots named ``root`` of the traced steps, every record under
    them), or None when none was recorded."""
    recs = getattr(d, "program_records", None)
    if trace is None or recs is None:
        return None
    roots = [r for r in recs if r.parent is None and r.name == root]
    if not roots:
        return None
    ids = {r.id for r in roots}
    return roots, [r for r in recs if r.root in ids]


def per_step(d, root: str, value) -> float | None:
    """The mean of ``value(root record)`` over the traced steps."""
    t = traced(d, root)
    if t is None:
        return None
    return sum(value(r) for r in t[0]) / len(t[0])


def device_ms_per_step(d, root: str, name: str, parent: str | None = None) -> float | None:
    """ms a step of the device intervals of the records ``name`` (under a
    span ``parent`` where given) in the traced steps; None without device
    times or without such a span."""
    t = traced(d, root)
    if t is None:
        return None
    spans = [r for r in t[1] if r.name == name and (parent is None or r.parent == parent)]
    if not spans or any(r.device_start_ns is None for r in spans):
        return None
    return sum(r.device_end_ns - r.device_start_ns for r in spans) / 1e6 / len(t[0])
