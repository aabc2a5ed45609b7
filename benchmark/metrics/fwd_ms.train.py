"""ms a step of the train step's forward phase (``train.state``): CUDA events
around the program's ``phase("forward")`` range, which the benchmark hands a
timed context, summed over the window, over its steps."""

from pointrcnn_tpu_torch.train import state


def install(d):
    d.spans.set_phase(state)


def read(d):
    ms = d.span_ms.get("forward")
    return None if ms is None else ms / d.attempted
