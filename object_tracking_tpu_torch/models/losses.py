"""Loss functions on tensors.

Port of `object_tracking_tpu/models/losses.py`. `yolo_loss` is the YOLOv2
loss as a function of (y_pred, y_true, true_boxes, step):

- predictions decode to cell units: sigmoid(xy) + cell offsets,
  exp(wh) · anchor;
- the confidence target is the IoU between each predicted box and the GT
  box owned by its cell/anchor, gated by objectness;
- coord mask = objectness · coord_scale;
- conf mask = [best IoU against the whole true-box buffer < threshold]
  · (1 − obj) · no_object_scale + obj · object_scale;
- class mask = objectness · class_weights[class] · class_scale;
- warm-up (step < warm_up_batches) regresses every anchor toward its prior;
- totals: normalised SSE for xy/wh/conf (each /2) + masked softmax CE.

The loss is float32 whatever the compute type of the predictions. `step`
is a host int (the train state's step read before its increment), so the
warm-up is a Python branch and costs no sync.

With a data `group` (each rank a share of the global batch) the box
counts that normalise the terms are summed over the group, so that each
rank's terms are its share of the global loss (the shares sum to it) and
the recall is the global one: a mean of per-rank losses is another loss.
`binary_crossentropy` and `heatmap_accuracy` take the group alike: each
rank's BCE is its local sum over the global element count, and the
accuracy is the global one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from object_tracking_tpu_torch.parallel.collectives import (
    all_reduce_sum_, group_size)

EPS = 1e-6


def _iou(xy_a, wh_a, xy_b, wh_b):
    mins_a, maxes_a = xy_a - wh_a / 2.0, xy_a + wh_a / 2.0
    mins_b, maxes_b = xy_b - wh_b / 2.0, xy_b + wh_b / 2.0
    iw = torch.clamp_min(torch.minimum(maxes_a[..., 0], maxes_b[..., 0])
                         - torch.maximum(mins_a[..., 0], mins_b[..., 0]), 0.0)
    ih = torch.clamp_min(torch.minimum(maxes_a[..., 1], maxes_b[..., 1])
                         - torch.maximum(mins_a[..., 1], mins_b[..., 1]), 0.0)
    inter = iw * ih
    union = wh_a[..., 0] * wh_a[..., 1] + wh_b[..., 0] * wh_b[..., 1] - inter
    # a 1e-10 floor avoids 0/0 when exp(wh) underflows against an empty
    # buffer slot
    return inter / (union + 1e-10)


def yolo_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
              true_boxes: torch.Tensor, anchors,
              step: int = 1_000_000, *,
              warm_up_batches: int = 0,
              object_scale: float = 5.0,
              no_object_scale: float = 1.0,
              coord_scale: float = 1.0,
              class_scale: float = 1.0,
              best_iou_threshold: float = 0.6,
              class_weights: Optional[torch.Tensor] = None,
              group=None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """YOLOv2 loss.

    Args:
      y_pred: (B, GH, GW, A, 5+C) raw head output.
      y_true: (B, GH, GW, A, 5+C) targets from ops.targets.
      true_boxes: (B, 1, 1, 1, TB, 4) cell-unit true-box buffer.
      anchors: (2A,) or (A, 2) anchor priors in cell units (a host copy
        moves to y_pred's device without a sync).
      step: global step (host int), drives the warm-up branch.
      group: the data group whose ranks share the global batch (None:
        this batch is the whole one).

    Returns:
      (scalar loss, aux dict with per-component losses and recall), all
      0-d float32 tensors on the device.
    """
    y_pred = y_pred.float()
    y_true = y_true.float()
    true_boxes = true_boxes.float()
    grid_h, grid_w, num_anchors = y_pred.shape[1:4]
    device = y_pred.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32).to(
        device, non_blocking=True).reshape(1, 1, 1, -1, 2)

    # cell offsets (x = column, y = row), (1, GH, GW, A, 2)
    shape = (1, grid_h, grid_w, num_anchors)
    cell_x = torch.arange(grid_w, dtype=torch.float32, device=device)
    cell_y = torch.arange(grid_h, dtype=torch.float32, device=device)
    cell_grid = torch.stack([cell_x[None, None, :, None].expand(shape),
                             cell_y[None, :, None, None].expand(shape)],
                            dim=-1)

    pred_box_xy = torch.sigmoid(y_pred[..., :2]) + cell_grid
    pred_box_wh = torch.exp(y_pred[..., 2:4]) * anchors
    pred_box_conf = torch.sigmoid(y_pred[..., 4])
    pred_box_class = y_pred[..., 5:]

    true_box_xy = y_true[..., 0:2]
    true_box_wh = y_true[..., 2:4]
    objectness = y_true[..., 4]

    iou_scores = _iou(pred_box_xy, pred_box_wh, true_box_xy, true_box_wh)
    true_box_conf = iou_scores * objectness
    # an all-zero row gives class 0, the first maximum, as jnp.argmax
    true_box_class = torch.argmax(y_true[..., 5:], dim=-1)

    coord_mask = objectness[..., None] * coord_scale

    best_ious = _iou(pred_box_xy[..., None, :], pred_box_wh[..., None, :],
                     true_boxes[..., 0:2], true_boxes[..., 2:4]).amax(dim=4)
    conf_mask = ((best_ious < best_iou_threshold).float()
                 * (1.0 - objectness) * no_object_scale
                 + objectness * object_scale)

    if class_weights is None:
        class_w = torch.ones((), device=device)
    else:
        class_w = torch.as_tensor(class_weights, dtype=torch.float32).to(
            device, non_blocking=True)[true_box_class]
    class_mask = objectness * class_w * class_scale

    if step < warm_up_batches:
        no_boxes_mask = (coord_mask < coord_scale / 2.0).float()
        true_box_xy = true_box_xy + (0.5 + cell_grid) * no_boxes_mask
        true_box_wh = true_box_wh + torch.ones_like(true_box_wh) * anchors \
            * no_boxes_mask
        coord_mask = torch.ones_like(coord_mask)

    nb_true_box = objectness.sum()
    nb_pred_box = torch.sum((true_box_conf > 0.5).float()
                            * (pred_box_conf > 0.3).float())
    counts = torch.stack([(coord_mask > 0.0).float().sum(),
                          (conf_mask > 0.0).float().sum(),
                          (class_mask > 0.0).float().sum(),
                          nb_true_box, nb_pred_box]).detach()
    nb_coord_box, nb_conf_box, nb_class_box, nb_true_box, nb_pred_box = \
        all_reduce_sum_(counts, group)

    loss_xy = (torch.sum(torch.square(true_box_xy - pred_box_xy) * coord_mask)
               / (nb_coord_box + EPS) / 2.0)
    loss_wh = (torch.sum(torch.square(true_box_wh - pred_box_wh) * coord_mask)
               / (nb_coord_box + EPS) / 2.0)
    loss_conf = (torch.sum(torch.square(true_box_conf - pred_box_conf)
                           * conf_mask) / (nb_conf_box + EPS) / 2.0)
    ce = -torch.log_softmax(pred_box_class, dim=-1)
    loss_class = torch.gather(ce, -1, true_box_class[..., None])[..., 0]
    loss_class = torch.sum(loss_class * class_mask) / (nb_class_box + EPS)

    loss = loss_xy + loss_wh + loss_conf + loss_class
    aux = {'loss_xy': loss_xy, 'loss_wh': loss_wh, 'loss_conf': loss_conf,
           'loss_class': loss_class, 'loss': loss,
           'recall': nb_pred_box / (nb_true_box + EPS)}
    return loss, aux


def global_mean(x: torch.Tensor, group) -> torch.Tensor:
    """mean(x) over the global batch, as this rank's share: the local sum
    over the global element count (every rank holds as many elements)."""
    if group is None:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * group_size(group))


def binary_crossentropy(y_pred: torch.Tensor, y_true: torch.Tensor,
                        eps: float = 1e-7, group=None) -> torch.Tensor:
    """Keras-style BCE on probabilities, mean over all elements. With a
    data `group`, this rank's share of the global mean."""
    p = torch.clamp(y_pred.float(), eps, 1.0 - eps)
    t = y_true.float()
    return -global_mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p),
                         group)


def heatmap_accuracy(y_pred: torch.Tensor, y_true: torch.Tensor,
                     eps: float = 1e-7, group=None) -> torch.Tensor:
    """Mean fraction of GT-on cells predicted on. With a data `group`, the
    global batch's value on every rank (a metric: no gradient)."""
    positive = torch.sum(y_true * y_pred, dim=-1)
    total = torch.sum(y_true, dim=-1)
    share = global_mean(positive / (total + eps), group)
    return share if group is None else all_reduce_sum_(share.detach(),
                                                       group)
