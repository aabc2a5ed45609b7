"""ms a batch of the second stage (ops.roipool3d + models.rcnn): CUDA
events around ``point_rcnn.roipool3d`` and around ``model.rcnn_net``'s
forward, summed over the window, over its batches."""

from pointrcnn_tpu_torch.models import point_rcnn


def install(d):
    d.spans.wrap(point_rcnn, "roipool3d", "roipool")
    d.spans.hook_module("rcnn_net", d.model.rcnn_net)


def read(d):
    parts = [d.span_ms.get(n) for n in ("roipool", "rcnn_net")]
    return None if None in parts else sum(parts) / d.attempted
