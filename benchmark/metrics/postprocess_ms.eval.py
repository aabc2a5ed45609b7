"""ms a batch of the eval step's post-process (eval.evaluator:
``joint_postprocess``: refine, rotated final NMS, gt IoU): CUDA events
around it, summed over the window, over its batches."""

from pointrcnn_tpu_torch.eval import evaluator


def install(d):
    d.spans.wrap(evaluator, "joint_postprocess", "postprocess")


def read(d):
    ms = d.span_ms.get("postprocess")
    return None if ms is None else ms / d.attempted
