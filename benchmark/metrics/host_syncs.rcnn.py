"""Host syncs a step of the rcnn-stage train step: the blocking reads of
the card the program makes inside its ``train.step`` span
(``ops.counts.sync``: the TRAIN proposal layer's NMS Jacobi steps and zone-2
test, K2's index checks, and every other counted site), over the steps
traced before the window (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.per_step(d, "train.step", lambda r: r.syncs)
