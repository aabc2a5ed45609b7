"""ms a batch the host waits at the program's host syncs inside its
``ssd3d.step`` span (``time.perf_counter_ns`` around each counted read,
``ops.counts.sync``), over the batches traced before the window
(``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.per_step(d, "ssd3d.step", lambda r: r.sync_wait_ns / 1e6)
