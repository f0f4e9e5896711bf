"""paddle.vision.ops of the port (paddle_tpu/vision/ops.py): the 20
detection ops of ``ops/detection.py``, the two conv ops,
``deform_conv2d`` and ``psroi_pool`` (``ops/conv.py``), and
``sigmoid_focal_loss`` (``ops/loss.py``)."""
from __future__ import annotations

from ..ops.detection import (  # noqa: F401
    anchor_generator, bipartite_match, box_clip, box_coder,
    box_decoder_and_assign, collect_fpn_proposals, density_prior_box,
    distribute_fpn_proposals, iou_similarity, matrix_nms, mine_hard_examples,
    multiclass_nms, nms, polygon_box_transform, prior_box, roi_align,
    roi_pool, target_assign, yolo_box, yolov3_loss)
from ..ops.conv import deform_conv2d, psroi_pool  # noqa: F401
from ..ops.loss import sigmoid_focal_loss  # noqa: F401

__all__ = ["roi_align", "roi_pool", "nms", "multiclass_nms", "yolo_box",
           "prior_box", "box_coder", "box_clip", "iou_similarity",
           "bipartite_match", "anchor_generator", "density_prior_box",
           "matrix_nms", "target_assign", "polygon_box_transform",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "box_decoder_and_assign", "mine_hard_examples", "yolov3_loss",
           "deform_conv2d", "psroi_pool", "sigmoid_focal_loss"]
