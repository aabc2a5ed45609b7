"""ms a batch of 3DSSD's vote layers: the vote module (``ssd3d.vote``) and
the vote aggregation (``ssd3d.vote_aggregation``, its ball query and
grouped stacks to width 1024), CUDA events of the program's spans in the
batches traced before the window (``harness/program_trace.py``), over
their count."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    parts = [program_trace.device_ms_per_step(d, "ssd3d.step", s)
             for s in ("ssd3d.vote", "ssd3d.vote_aggregation")]
    return None if any(p is None for p in parts) else sum(parts)
