"""ms a step the host waits at the program's host syncs inside its
``train.step`` span of the rcnn-stage train step (``time.perf_counter_ns``
around each counted read, ``ops.counts.sync``), over the steps traced before
the window (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.per_step(d, "train.step", lambda r: r.sync_wait_ns / 1e6)
