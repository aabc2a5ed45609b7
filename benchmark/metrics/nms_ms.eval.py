"""ms a batch of the proposal layer's NMS (ops.nms inside models.proposal:
eight calls a batch at batch 4, two zones a frame; the post-process's final
NMS is not counted): CUDA events of the program's ``ops.nms`` spans whose
parent is ``models.proposal``, summed over the batches traced before the
window (``harness/program_trace.py``), over their count."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.device_ms_per_step(d, "eval.step", "ops.nms", "models.proposal")
