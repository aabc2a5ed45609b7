"""ms a step of the target layer (``models.target``: roi sampling, jitter,
pooling and labels inside the rcnn stage's forward): CUDA events around
the program's ``point_rcnn.phase("targets")`` range, which the benchmark
hands a timed context, summed over the window, over its steps."""

from pointrcnn_tpu_torch.models import point_rcnn


def install(d):
    d.spans.set_phase(point_rcnn)


def read(d):
    ms = d.span_ms.get("targets")
    return None if ms is None else ms / d.attempted
