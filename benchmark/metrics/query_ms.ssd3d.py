"""ms a batch of the exact ball query (``ops/grouping.py``'s first-in-order
route: every scale of SA1-SA3 and of the vote aggregation): CUDA events of
the program's ``ops.ball_query_exact`` spans in the batches traced before
the window (``harness/program_trace.py``), over their count."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.device_ms_per_step(d, "ssd3d.step", "ops.ball_query_exact")
