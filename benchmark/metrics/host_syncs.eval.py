"""Host syncs a batch of the eval step: the blocking reads of the card the
program makes inside its ``eval.step`` span (``ops.counts.sync``: each NMS
Jacobi step's stop test, the proposal layer's zone-2 test, K2's index
checks, and every other counted site), over the batches traced before the
window (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.per_step(d, "eval.step", lambda r: r.syncs)
