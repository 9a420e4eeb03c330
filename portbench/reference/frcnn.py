"""Plain float32 reference of Faster R-CNN with VGG16 at test time (Ren,
He, Girshick and Sun, arXiv:1506.01497), as py-faster-rcnn's
`models/pascal_voc/VGG16/faster_rcnn_end2end/test.prototxt` runs it with
the test settings of `lib/fast_rcnn/config.py` and `tools/test_net.py`.

Written from those files as functions over a weight dict named by the
program's state-dict keys (`conv1_1.weight` ... `bbox_pred.bias`). It
imports nothing of the program and nothing of JAX, and sets TF32 off in
matmuls and convolutions while it computes (`allow_tf32=True` computes
the forward and the head one precision below, for the check's control):

- `prepare`: frames (N, H, W, 3) RGB in [0, 1] → ×255, BGR, minus
  `PIXEL_MEANS`, NCHW;
- `trunk`: VGG16's 13 3x3 convolutions (pad 1, ReLU) with the four 2x2
  stride-2 max pools in Caffe's ceil mode → conv5_3;
- `rpn`: rpn_conv/3x3 with ReLU, rpn_cls_score (18) and rpn_bbox_pred
  (36); the softmax pairs channel a with a + 9 (Caffe's reshape to
  (2, 9H, W)); scores and deltas in (h, w, a) order;
- `proposals`: `lib/rpn/proposal_layer.py` per image: decode
  (`bbox_transform_inv`), clip, the minimum-size filter at
  RPN_MIN_SIZE × scale, the top RPN_PRE_NMS_TOP_N by foreground score,
  greedy NMS at RPN_NMS_THRESH, the first RPN_POST_NMS_TOP_N kept;
- `roi_pool`: Caffe's `ROIPoolingLayer` forward;
- `head`: fc6 → ReLU → fc7 → ReLU (dropout is the identity at test),
  cls_score → softmax over the classes, bbox_pred;
- `detections`: `im_detect` and `test_net`: each class's deltas decoded
  against its RoI and clipped, score > thresh, per-class greedy NMS, then
  the best `max_per_image` of the image over the classes.

Departures, which the configuration lists under `departures`:
- the batch: the program serves 8 images a call and each keeps its own
  proposals (py-faster-rcnn runs one image a forward); here each image is
  taken alone;
- ties in a score sort break by the lower index (numpy's
  `argsort()[::-1]` gives no stable order), in the proposal sort, each
  NMS and the image's final cap, which keeps exactly `max_per_image`
  (test_net keeps every detection tied with the last);
- IoU: boxes go to centre form with py-faster-rcnn's +1 widths (w = x2 −
  x1 + 1, cx = x1 + 0.5·w, covering [x1, x2 + 1]) and the IoU is the
  program's NMS kernel's, inter / max(union, 1e-12) on those; a pair
  whose IoU is at least the threshold is suppressed (py-faster-rcnn's
  `nms` suppresses above it). Up to rounding that is py-faster-rcnn's +1
  IoU;
- the detections are decoded in the frame as served (py-faster-rcnn
  divides the RoIs by the image's scale and decodes in the camera
  frame's pixels), and leave image-relative in centre form:
  (cx, cy, w, h) = (x1 + 0.5·w', y1 + 0.5·h', w', h') over (W, H) with
  w' = x2 − x1 + 1.

RoI pooling keeps Caffe's float arithmetic: start = round(x1·s) with C's
round (half away from zero, never torch.round's half to even), a width of
max(end − start + 1, 1), and bin p over [floor(p·bw), ceil((p + 1)·bw))
with bw = width / 7 in float32, offset by the start and clipped to the
map; the max over the bin, 0 for an empty bin. In float32 the last bin of
a RoI 57 cells wide ends one cell past it (7·fl(57/7) rounds above 57),
as it does in Caffe.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_MEANS_BGR = (102.9801, 115.9465, 122.7717)
VGG = (('conv1_1', 64), ('conv1_2', 64), ('conv2_1', 128), ('conv2_2', 128),
       ('conv3_1', 256), ('conv3_2', 256), ('conv3_3', 256),
       ('conv4_1', 512), ('conv4_2', 512), ('conv4_3', 512),
       ('conv5_1', 512), ('conv5_2', 512), ('conv5_3', 512))
POOL_AFTER = ('conv1_2', 'conv2_2', 'conv3_3', 'conv4_3')
STRIDE = 16
POOLED = 7
HIDDEN = 4096

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def tf32(allow: bool = False):
    """TF32 off (or, with `allow`, on) in matmuls and cuDNN convolutions
    for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------------ sizes
def ceil_half(n: int) -> int:
    return -(-n // 2)


def feature_hw(h: int, w: int) -> Tuple[int, int]:
    """conv5_3's size: four ceil-mode halvings."""
    for _ in POOL_AFTER:
        h, w = ceil_half(h), ceil_half(w)
    return h, w


def spec(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, fan_in) of every tensor, for `weights.make`:
    a 'normal' draw is scaled by 1 / sqrt(fan_in), so the fan_in given
    here sets each layer's standard deviation (`cfg['init']`)."""
    init = cfg['init']
    out = []

    def layer(name, shape, std):
        out.append((f'{name}.weight', shape, 'normal', 1.0 / std ** 2))
        out.append((f'{name}.bias', (shape[0],), 'zeros', 1))

    cin = 3
    for name, feats in VGG:
        fan = 9 * cin
        layer(name, (feats, cin, 3, 3), (init['trunk_gain'] / fan) ** 0.5)
        cin = feats
    layer('rpn_conv', (512, 512, 3, 3), init['rpn_std'])
    a = len(cfg['anchors'])
    layer('rpn_cls_score', (2 * a, 512, 1, 1), init['rpn_std'])
    layer('rpn_bbox_pred', (4 * a, 512, 1, 1), init['rpn_std'])
    fc6_in = 512 * POOLED * POOLED
    layer('fc6', (HIDDEN, fc6_in), (init['fc_gain'] / fc6_in) ** 0.5)
    layer('fc7', (HIDDEN, HIDDEN), (init['fc_gain'] / HIDDEN) ** 0.5)
    c = len(cfg['labels'])
    layer('cls_score', (c, HIDDEN), init['cls_std'])
    layer('bbox_pred', (4 * c, HIDDEN), init['bbox_std'])
    return out


def flops(cfg: dict) -> List[Tuple[str, float]]:
    """(name, FLOPs a frame) of every convolution and of the RoI head's
    GEMMs over `rois_per_frame` RoIs (2 a multiply-add)."""
    h, w = cfg['image_hw']
    rows, cin = [], 3
    for name, feats in VGG:
        rows.append((name, 2.0 * h * w * 9 * cin * feats))
        cin = feats
        if name in POOL_AFTER:
            h, w = ceil_half(h), ceil_half(w)
    a, c, r = len(cfg['anchors']), len(cfg['labels']), cfg['post_nms_top_n']
    rows += [('rpn_conv', 2.0 * h * w * 9 * 512 * 512),
             ('rpn_cls_score', 2.0 * h * w * 512 * 2 * a),
             ('rpn_bbox_pred', 2.0 * h * w * 512 * 4 * a),
             ('fc6', 2.0 * r * 512 * POOLED * POOLED * HIDDEN),
             ('fc7', 2.0 * r * HIDDEN * HIDDEN),
             ('cls_score', 2.0 * r * HIDDEN * c),
             ('bbox_pred', 2.0 * r * HIDDEN * 4 * c)]
    return rows


# ---------------------------------------------------------------- forward
def prepare(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) RGB in [0, 1] → (N, 3, H, W) BGR pixels less the
    means."""
    x = frames * 255.0
    means = torch.tensor(PIXEL_MEANS_BGR, dtype=frames.dtype,
                         device=frames.device)
    return (x.flip(-1) - means).permute(0, 3, 1, 2).contiguous()


def _conv(w: Weights, name: str, x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.conv2d(x, w[f'{name}.weight'], w[f'{name}.bias'], padding=pad)


def trunk(w: Weights, x: torch.Tensor) -> torch.Tensor:
    for name, _ in VGG:
        x = F.relu(_conv(w, name, x, 1))
        if name in POOL_AFTER:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    return x


def rpn(w: Weights, conv5: torch.Tensor, anchors: int):
    """conv5_3 → (foreground probabilities (N, H·W·A), deltas
    (N, H·W·A, 4)), both in (h, w, a) order."""
    h = F.relu(_conv(w, 'rpn_conv', conv5, 1))
    score = _conv(w, 'rpn_cls_score', h, 0)
    n, _, gh, gw = score.shape
    # Caffe's reshape to (2, A·H, W) and softmax over the 2
    prob = torch.softmax(score.reshape(n, 2, anchors * gh, gw), dim=1)
    fg = prob[:, 1].reshape(n, anchors, gh, gw)
    deltas = _conv(w, 'rpn_bbox_pred', h, 0)
    return (fg.permute(0, 2, 3, 1).reshape(n, -1),
            deltas.permute(0, 2, 3, 1).reshape(n, -1, 4))


def forward(w: Weights, frames: torch.Tensor, cfg: dict,
            allow_tf32: bool = False) -> dict:
    """The trunk and the RPN: {'conv5_3', 'rpn_fg', 'rpn_deltas'}."""
    with tf32(allow_tf32):
        conv5 = trunk(w, prepare(frames))
        fg, deltas = rpn(w, conv5, len(cfg['anchors']))
    return {'conv5_3': conv5, 'rpn_fg': fg, 'rpn_deltas': deltas}


# -------------------------------------------------------------- proposals
def all_anchors(cfg: dict, gh: int, gw: int, device) -> torch.Tensor:
    """The configured anchors shifted by 16·(x, y), shifts outer and
    anchors inner: (gh·gw·A, 4) corners."""
    base = torch.tensor(cfg['anchors'], dtype=torch.float32, device=device)
    sx = torch.arange(gw, dtype=torch.float32, device=device) * STRIDE
    sy = torch.arange(gh, dtype=torch.float32, device=device) * STRIDE
    yy, xx = torch.meshgrid(sy, sx, indexing='ij')
    shifts = torch.stack([xx, yy, xx, yy], dim=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """`bbox_transform_inv`: corners (..., 4) and deltas (..., 4)."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx, dy, dw, dh = deltas.unbind(-1)
    px = dx * widths + ctr_x
    py = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph,
                        px + 0.5 * pw, py + 0.5 * ph], dim=-1)


def clip(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w - 1), y1.clamp(0, h - 1),
                        x2.clamp(0, w - 1), y2.clamp(0, h - 1)], dim=-1)


def centre_form(boxes: torch.Tensor) -> torch.Tensor:
    """Corners → (cx, cy, w, h) with the +1 widths."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return torch.stack([boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h,
                        w, h], dim=-1)


def iou_ge(centre: torch.Tensor, thr: float) -> np.ndarray:
    """(K, K) bool: IoU(i, j) ≥ thr, the IoU as the program's NMS kernel
    computes it: inter / max(union, 1e-12) on centre-form boxes."""
    cx, cy, w, h = centre.unbind(-1)

    def overlap(c, s):
        lo, hi = c - s * 0.5, c + s * 0.5
        return torch.clamp_min(torch.minimum(hi[:, None], hi[None, :])
                               - torch.maximum(lo[:, None], lo[None, :]),
                               0.0)

    inter = overlap(cx, w) * overlap(cy, h)
    area = w * h
    union = area[:, None] + area[None, :] - inter
    return (inter / torch.clamp_min(union, 1e-12) >= thr).cpu().numpy()


def greedy_nms(centre: torch.Tensor, order: np.ndarray, thr: float,
               limit: int) -> List[int]:
    """Greedy NMS over the candidates in `order` (best first): each one
    not suppressed by an earlier kept one is kept; the first `limit`."""
    if len(order) == 0:
        return []
    ge = iou_ge(centre[torch.as_tensor(order, device=centre.device)], thr)
    removed = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if removed[i]:
            continue
        keep.append(int(order[i]))
        if len(keep) == limit:
            break
        removed |= ge[i]
    return keep


def score_order(scores: torch.Tensor) -> np.ndarray:
    """Indices by score descending, ties by the lower index."""
    return np.argsort(-scores.cpu().numpy(), kind='stable')


def proposals(fg: torch.Tensor, deltas: torch.Tensor, cfg: dict,
              image_hw: Tuple[int, int]) -> List[torch.Tensor]:
    """The proposal layer on each image: a list of (n ≤ post_nms_top_n, 4)
    corner boxes, in the order NMS kept them."""
    h, w = image_hw
    gh, gw = feature_hw(h, w)
    anchors = all_anchors(cfg, gh, gw, fg.device)
    min_size = cfg['rpn_min_size'] * cfg['scale']
    out = []
    for i in range(fg.shape[0]):
        boxes = clip(decode(anchors, deltas[i]), h, w)
        bw = boxes[:, 2] - boxes[:, 0] + 1.0
        bh = boxes[:, 3] - boxes[:, 1] + 1.0
        kept = torch.nonzero((bw >= min_size) & (bh >= min_size))[:, 0]
        order = score_order(fg[i, kept])[:cfg['pre_nms_top_n']]
        cand = kept[torch.as_tensor(order, device=kept.device)]
        keep = greedy_nms(centre_form(boxes[cand]), np.arange(len(cand)),
                          cfg['rpn_nms_thresh'], cfg['post_nms_top_n'])
        out.append(boxes[cand[torch.as_tensor(keep, dtype=torch.long,
                                              device=kept.device)]])
    return out


# ------------------------------------------------------------ RoI pooling
def c_round(v: torch.Tensor) -> torch.Tensor:
    """C's round: half away from zero, exactly."""
    t = torch.trunc(v)
    return t + torch.where((v - t).abs() >= 0.5, torch.sign(v),
                           torch.zeros_like(v))


def _bins(start: torch.Tensor, end: torch.Tensor, size: int):
    """Per RoI: the [lo, hi) of each of the POOLED bins along one axis,
    clipped to [0, size)."""
    length = torch.clamp_min(end - start + 1, 1).float()
    # a tensor divisor: CUDA divides by a host scalar as a product by its
    # inverse, which is not Caffe's float division
    step = length / torch.full_like(length, float(POOLED))
    p = torch.arange(POOLED, dtype=torch.float32, device=start.device)
    lo = torch.floor(p[None] * step[:, None]).long() + start[:, None]
    hi = torch.ceil((p[None] + 1) * step[:, None]).long() + start[:, None]
    return lo.clamp(0, size), hi.clamp(0, size)


def roi_pool(conv5: torch.Tensor, rois: torch.Tensor, image: torch.Tensor,
             scale: float) -> torch.Tensor:
    """Caffe's ROIPoolingLayer: RoIs (R, 4) corners of images `image`
    (R,) over conv5 (N, C, H, W) → (R, C, 7, 7), a masked max over each
    bin, computed a few RoIs at a time (~2**27 elements a step)."""
    _, c, h, w = conv5.shape
    chunk = max(1, 2 ** 27 // (c * h * w * POOLED))
    s = torch.tensor(scale, dtype=torch.float32, device=rois.device)
    edges = c_round(rois * s).long()
    xs, xe = _bins(edges[:, 0], edges[:, 2], w)
    ys, ye = _bins(edges[:, 1], edges[:, 3], h)
    cols = torch.arange(w, device=rois.device)
    rows = torch.arange(h, device=rois.device)
    out = []
    for r0 in range(0, rois.shape[0], chunk):
        sl = slice(r0, r0 + chunk)
        x = conv5[image[sl]]                                # (r, C, H, W)
        col = (cols >= xs[sl, :, None]) & (cols < xe[sl, :, None])
        row = (rows >= ys[sl, :, None]) & (rows < ye[sl, :, None])
        neg = torch.tensor(float('-inf'), device=x.device)
        # max over each column bin, then over each row bin
        by_col = torch.where(col[:, None, None], x[:, :, :, None, :],
                             neg).amax(-1)                  # (r, C, H, 7)
        pooled = torch.where(row[:, None, :, :, None],
                             by_col[:, :, None], neg).amax(3)  # (r,C,7,7)
        empty = ~(row.any(-1)[:, :, None] & col.any(-1)[:, None, :])
        out.append(torch.where(empty[:, None], torch.zeros_like(pooled),
                               pooled))
    return torch.cat(out) if out else conv5.new_zeros((0, c, POOLED, POOLED))


def head(w: Weights, pooled: torch.Tensor, allow_tf32: bool = False):
    """(R, C, 7, 7) → (cls_prob (R, classes), bbox_pred (R, 4·classes))."""
    with tf32(allow_tf32):
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(F.linear(x, w['fc6.weight'], w['fc6.bias']))
        x = F.relu(F.linear(x, w['fc7.weight'], w['fc7.bias']))
        cls = torch.softmax(F.linear(x, w['cls_score.weight'],
                                     w['cls_score.bias']), dim=-1)
        box = F.linear(x, w['bbox_pred.weight'], w['bbox_pred.bias'])
    return cls, box


def pool_and_head(w: Weights, conv5: torch.Tensor, rois: torch.Tensor,
                  scale: float, allow_tf32: bool = False):
    """The RoI pool and the head on the program's conv5_3 and its RoIs
    (N, R, 4), every row pooled as the program pools it:
    (cls_prob (N, R, classes), bbox_pred (N, R, 4·classes))."""
    n, r, _ = rois.shape
    image = torch.arange(n, device=rois.device).repeat_interleave(r)
    pooled = roi_pool(conv5, rois.reshape(-1, 4), image, scale)
    cls, box = head(w, pooled, allow_tf32)
    return cls.reshape(n, r, -1), box.reshape(n, r, -1)


# ------------------------------------------------------------- detections
def detections(cls_prob: torch.Tensor, bbox_pred: torch.Tensor,
               rois: torch.Tensor, valid: torch.Tensor, cfg: dict,
               image_hw: Tuple[int, int]) -> List[List[tuple]]:
    """Each image's detections from its valid RoIs: [(class, score,
    (cx, cy, w, h) image-relative)], best first."""
    h, w = image_hw
    classes = cls_prob.shape[-1]
    out = []
    for i in range(cls_prob.shape[0]):
        rows = torch.nonzero(valid[i])[:, 0]
        prob, box, roi = cls_prob[i, rows], bbox_pred[i, rows], rois[i, rows]
        boxes = clip(decode(roi[:, None, :].expand(-1, classes, 4),
                            box.reshape(-1, classes, 4)), h, w)
        found = []      # (score, class, roi row, box), class-major
        for j in range(1, classes):
            score = prob[:, j]
            inds = torch.nonzero(score > cfg['score_thresh'])[:, 0]
            if len(inds) == 0:
                continue
            order = score_order(score[inds])
            keep = greedy_nms(centre_form(boxes[inds, j]), order,
                              cfg['nms_thresh'], len(inds))
            for k in sorted(keep):
                found.append((float(score[inds[k]]), j, boxes[inds[k], j]))
        order = np.argsort(-np.array([f[0] for f in found], np.float32),
                           kind='stable')[:cfg['max_per_image']]
        frame = []
        for k in order:
            score, j, corners = found[k]
            c = centre_form(corners)
            rel = (c / torch.tensor([w, h, w, h], dtype=torch.float32,
                                    device=c.device)).tolist()
            frame.append((j, score, tuple(rel)))
        out.append(frame)
    return out


def anchors_of(base_size: int, ratios: Sequence[float],
               scales: Sequence[float]) -> np.ndarray:
    """py-faster-rcnn's `generate_anchors`, in numpy (its own rounding:
    np.round, half to even)."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float64)
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in scales:
            a, b = ws * s, hs * s
            out.append([cx - 0.5 * (a - 1), cy - 0.5 * (b - 1),
                        cx + 0.5 * (a - 1), cy + 0.5 * (b - 1)])
    return np.array(out)
