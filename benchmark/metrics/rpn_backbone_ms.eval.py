"""ms a batch of the RPN (models.rpn / models.pointnet2: SA1-4, FP1-4,
the heads): CUDA events around ``model.rpn``'s forward, summed over the
window, over its batches."""


def install(d):
    d.spans.hook_module("rpn", d.model.rpn)


def read(d):
    ms = d.span_ms.get("rpn")
    return None if ms is None else ms / d.attempted
