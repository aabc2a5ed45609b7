"""ms a step of the rcnn stage's TRAIN proposal layer (models.proposal +
ops.nms: decode, 9000 -> 512 over two distance zones, eight NMS calls at
batch 4): CUDA events of the program's ``models.proposal`` spans inside
``train.step``, summed over the steps traced before the window
(``harness/program_trace.py``), over their count."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.device_ms_per_step(d, "train.step", "models.proposal")
