"""paddle.vision.ops of the port (paddle_tpu/vision/ops.py): the two conv
ops, ``deform_conv2d`` and ``psroi_pool`` (``ops/conv.py``), and
``sigmoid_focal_loss`` (``ops/loss.py``). The detection names are here
and raise NotImplementedError: ``ops/detection.py`` waits for ROADMAP
Queue 1 item 9."""
from __future__ import annotations

from ..ops.conv import deform_conv2d, psroi_pool  # noqa: F401
from ..ops.loss import sigmoid_focal_loss  # noqa: F401

__all__ = ["roi_align", "roi_pool", "nms", "multiclass_nms", "yolo_box",
           "prior_box", "box_coder", "box_clip", "iou_similarity",
           "bipartite_match", "anchor_generator", "density_prior_box",
           "matrix_nms", "target_assign", "polygon_box_transform",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "box_decoder_and_assign", "mine_hard_examples", "yolov3_loss",
           "deform_conv2d", "psroi_pool", "sigmoid_focal_loss"]

_DETECTION = __all__[:20]


def _unported(name):
    def op(*args, **kwargs):
        raise NotImplementedError(
            f"paddle.vision.ops.{name} needs ops/detection.py, which "
            "paddle_tpu_torch does not have yet (ROADMAP Queue 1 item 9)")
    op.__name__ = op.__qualname__ = name
    return op


for _name in _DETECTION:
    globals()[_name] = _unported(_name)
del _name
