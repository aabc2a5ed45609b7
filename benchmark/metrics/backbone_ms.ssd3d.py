"""ms a batch of 3DSSD's backbone (models.ssd3d / models.pointnet2: SA1-SA3,
their sampling, exact ball query, grouped stacks and aggregation convs):
CUDA events of the program's ``ssd3d.SA1``-``SA3`` spans, summed over the
batches traced before the window (``harness/program_trace.py``), over
their count."""

from benchmark.harness import program_trace

SPANS = ("ssd3d.SA1", "ssd3d.SA2", "ssd3d.SA3")


def install(d):
    program_trace.trace_steps(d)


def read(d):
    parts = [program_trace.device_ms_per_step(d, "ssd3d.step", s) for s in SPANS]
    return None if any(p is None for p in parts) else sum(parts)
