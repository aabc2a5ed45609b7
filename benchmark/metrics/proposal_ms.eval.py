"""ms a batch of the proposal layer (models.proposal + ops.nms: decode,
distance-zone NMS): CUDA events around ``point_rcnn.proposal_layer``,
summed over the window, over its batches."""

from pointrcnn_tpu_torch.models import point_rcnn


def install(d):
    d.spans.wrap(point_rcnn, "proposal_layer", "proposal")


def read(d):
    ms = d.span_ms.get("proposal")
    return None if ms is None else ms / d.attempted
