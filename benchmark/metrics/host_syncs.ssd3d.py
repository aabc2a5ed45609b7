"""Host syncs a batch of 3DSSD's eval step: the blocking reads of the card
the program makes inside its ``ssd3d.step`` span (``ops.counts.sync``: the
NMS's Jacobi stop tests, K2's index checks), over the batches traced
before the window (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.per_step(d, "ssd3d.step", lambda r: r.syncs)
