"""Plain float32 reference of YOLOv4 (Bochkovskiy, Wang and Liao 2020,
arXiv:2004.10934) at inference: the forward pass, the [yolo] decode with
its grid sensitivity `scale_x_y`, and the detections after the cap and
NMS.

Written from the paper's blocks as functions, not from a `.cfg`: the
CSPDarknet53 backbone (`csp_stage`, five stages of 1, 2, 8, 8 and 4
residual blocks, Mish), the SPP block (`spp`: max pools of 5, 9 and 13 at
stride 1), the PANet neck (`forward`: top-down with upsampling to the
stage outputs of stride 16 and 8, then bottom-up with stride-2
convolutions, leaky 0.1, five-convolution blocks `five`) and three heads
of 3·(5 + C) channels at strides 8, 16 and 32. It imports nothing of the
program. Each tensor of the weight dict is named by the layer index that
darknet's `cfg/yolov4.cfg` gives it (`conv_<i>.weight`, `norm_<i>.*`,
`conv_<i>.bias` on the three head convolutions), reckoned here by
counting layers as the blocks add them: routes, shortcuts, pools,
upsamples and the [yolo] layers take an index and hold no weight. The
same walk on the meta device lists the weights (`spec`).

The port's conventions, kept here as the configuration lists them under
`departures`:
- a 3x3 stride-2 convolution on an even map pads (0, 1) (flax's 'SAME');
  darknet pads (1, 1);
- BatchNorm from its running statistics with epsilon 1e-3:
  (x - mean) / sqrt(var + 1e-3) · scale + shift;
- the candidates of the three heads are merged in head order, capped to
  the top K by best class score and put through per-class greedy NMS
  (`reference/serve.py`'s `cap` and `nms`); darknet sorts them all.

Activations are NCHW inside; images come in as (N, H, W, 3) in [0, 1] and
each head leaves as (N, GH, GW, 3, 5 + C), the program's layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import serve as ref_serve

BN_EPS = 1e-3
LEAKY = 0.1
ANCHORS_PER_HEAD = 3
STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))  # out, blocks
POOLS = (5, 9, 13)
LAYERS = 162                     # after [net], as darknet counts them

Weights = Dict[str, torch.Tensor]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY)


class Net:
    """Walks the layers in darknet's order: `at` is the next layer's
    index, `out[i]` layer i's output. With weights `w` it computes; with
    none it lists each weight (`spec`: name, shape, init, fan_in) and
    hands back an empty meta tensor in its place. With `calibrate` it
    first writes into each BatchNorm's running statistics the mean and
    biased variance of its input over the batch."""

    def __init__(self, w: Optional[Weights] = None, calibrate=False):
        self.w = w
        self.calibrate = calibrate
        self.spec: List[Tuple[str, tuple, str, int]] = []
        self.convs: List[Tuple[str, float]] = []   # name, FLOPs a frame
        self.at = 0
        self.out: List[torch.Tensor] = []

    def add(self, x: torch.Tensor) -> torch.Tensor:
        self.out.append(x)
        self.at += 1
        return x

    def _weight(self, name: str, shape: tuple, init: str,
                fan_in: int = 0) -> torch.Tensor:
        if self.w is None:
            self.spec.append((name, shape, init, fan_in))
            return torch.empty(shape, device='meta')
        return self.w[name]

    def _conv(self, x, filters: int, k: int, stride: int) -> torch.Tensor:
        c_in = x.shape[1]
        weight = self._weight(f'conv_{self.at}.weight',
                              (filters, c_in, k, k), 'normal', c_in * k * k)
        if stride == 2:
            x = F.conv2d(F.pad(x, (0, 1, 0, 1)), weight, stride=2)
        else:
            x = F.conv2d(x, weight, padding=k // 2)
        self.convs.append((f'conv_{self.at}',
                           2.0 * x[0].numel() * c_in * k * k))
        return x

    def conv(self, x, filters: int, k: int, stride: int = 1,
             act=mish) -> torch.Tensor:
        """Convolution, BatchNorm from running statistics, activation."""
        x = self._conv(x, filters, k, stride)
        n = f'norm_{self.at}.'
        scale = self._weight(n + 'weight', (filters,), 'ones')
        shift = self._weight(n + 'bias', (filters,), 'zeros')
        mean = self._weight(n + 'running_mean', (filters,), 'zeros')
        var = self._weight(n + 'running_var', (filters,), 'ones')
        if self.calibrate:
            mean.copy_(x.mean(dim=(0, 2, 3)))
            var.copy_(torch.square(x - mean[:, None, None]).mean(
                dim=(0, 2, 3)))
        x = ((x - mean[:, None, None]) / torch.sqrt(var[:, None, None]
                                                    + BN_EPS)
             * scale[:, None, None] + shift[:, None, None])
        return self.add(act(x))

    def head(self, x, filters: int) -> torch.Tensor:
        """The linear 1x1 head convolution, with a bias."""
        bias = f'conv_{self.at}.bias'
        x = self._conv(x, filters, 1, 1)
        return self.add(x + self._weight(bias, (filters,), 'zeros')
                        [:, None, None])

    def route(self, *layers: int) -> torch.Tensor:
        return self.add(torch.cat([self.out[i] for i in layers], dim=1))


def csp_stage(net: Net, x, channels: int, blocks: int,
              first: bool) -> torch.Tensor:
    """A cross-stage-partial stage: a 3x3 stride-2 convolution to
    `channels`, split into two 1x1 branches; residual blocks (a 1x1 to
    half the channels, a 3x3 back, added to the block's input) on the
    second; a 1x1 transition; the transition and the first branch
    concatenated in that order and fused by a 1x1 to `channels`. The
    first stage keeps `channels` in each branch; later ones halve them."""
    branch = channels if first else channels // 2
    down = net.conv(x, channels, 3, stride=2)
    net.conv(down, branch, 1)                  # the cross-stage branch
    split = net.at - 1
    net.route(split - 1)                       # back to `down`
    x = net.conv(down, branch, 1)
    for _ in range(blocks):
        y = net.conv(x, channels // 2, 1)
        x = net.add(x + net.conv(y, branch, 3))     # shortcut, linear
    net.conv(x, branch, 1)
    x = net.route(net.at - 1, split)
    return net.conv(x, channels, 1)


def spp(net: Net, x) -> torch.Tensor:
    """Max pools of 5, 9 and 13 at stride 1 (padded with -inf) of one map,
    concatenated with it in darknet's route order: 13, 9, 5, the map."""
    base = net.at - 1
    for n, k in enumerate(POOLS):
        if n:
            net.route(base)
        net.add(F.max_pool2d(x, k, stride=1, padding=k // 2))
    return net.route(net.at - 1, net.at - 3, net.at - 5, base)


def five(net: Net, x, channels: int) -> torch.Tensor:
    """1x1 to `channels`, 3x3 to twice that, 1x1, 3x3, 1x1; leaky."""
    for k in (1, 3, 1, 3, 1):
        x = net.conv(x, channels * (2 if k == 3 else 1), k, act=leaky)
    return x


def _walk(net: Net, images: torch.Tensor, classes: int) -> List:
    x = net.conv(images.permute(0, 3, 1, 2), 32, 3)
    taps = []
    for n, (channels, blocks) in enumerate(STAGES):
        x = csp_stage(net, x, channels, blocks, first=n == 0)
        taps.append(net.at - 1)                 # 10, 23, 54, 85, 104
    for k in (1, 3, 1):
        x = net.conv(x, 512 * (2 if k == 3 else 1), k, act=leaky)
    x = spp(net, x)
    for k in (1, 3, 1):
        x = net.conv(x, 512 * (2 if k == 3 else 1), k, act=leaky)
    joins = [net.at - 1]                        # 116: stride 32
    # top-down, to the stage outputs of stride 16 (85) and 8 (54)
    for tap, channels in ((taps[3], 256), (taps[2], 128)):
        x = net.conv(x, channels, 1, act=leaky)
        net.add(F.interpolate(x, scale_factor=2, mode='nearest'))
        net.route(tap)
        net.conv(net.out[tap], channels, 1, act=leaky)
        x = five(net, net.route(net.at - 1, net.at - 3), channels)
        joins.append(net.at - 1)                # 126, 136
    # bottom-up from stride 8, a head at each of strides 8, 16, 32
    heads = []
    for n, channels in enumerate((128, 256, 512)):
        raw = net.head(net.conv(x, 2 * channels, 3, act=leaky),
                       ANCHORS_PER_HEAD * (5 + classes))
        b, c, gh, gw = raw.shape
        heads.append(raw.permute(0, 2, 3, 1).reshape(
            b, gh, gw, ANCHORS_PER_HEAD, c // ANCHORS_PER_HEAD))
        net.add(raw)                            # the [yolo] layer
        if n == 2:
            break
        net.route(net.at - 4)
        net.conv(x, 2 * channels, 3, stride=2, act=leaky)
        x = five(net, net.route(net.at - 1, joins[1 - n]), 2 * channels)
    if net.at != LAYERS:
        raise AssertionError(f'{net.at} layers, darknet counts {LAYERS}')
    return heads


def forward(w: Weights, images: torch.Tensor,
            classes: int) -> List[torch.Tensor]:
    """images (N, H, W, 3) → the three heads' raw outputs, each
    (N, H/s, W/s, 3, 5 + classes) for s = 8, 16, 32, in darknet's order."""
    return _walk(Net(w), images, classes)


def calibrate(w: Weights, images: torch.Tensor,
              classes: int) -> List[torch.Tensor]:
    """Set every BatchNorm's running statistics, in place in `w`, to
    those of its input on `images`, layer by layer, as a trained
    network's statistics follow its activations; returns the heads of
    that pass (equal to `forward`'s with the statistics set)."""
    return _walk(Net(w, calibrate=True), images, classes)


def layout(cfg: dict) -> Net:
    """The walk at the configured size on the meta device, with no
    weights: its `spec` lists (name, shape, init, fan_in) of every weight
    and its `convs` (name, FLOPs a frame at 2 a multiply-add) of every
    convolution, in layer order."""
    net = Net()
    size = cfg['image']
    _walk(net, torch.empty((1, size, size, 3), device='meta'),
          cfg['num_classes'])
    return net


def head_anchors(cfg: dict) -> List[np.ndarray]:
    """Each head's (3, 2) anchors in input pixels (the cfg's masks)."""
    pairs = np.asarray(cfg['anchors'], np.float32).reshape(-1, 2)
    return [pairs[list(mask)] for mask in cfg['masks']]


def decode(head: torch.Tensor, anchors: np.ndarray, scale_x_y: float,
           image: int, obj_threshold: float):
    """One [yolo] head (N, GH, GW, A, 5 + C) → boxes (N, GH·GW·A, 4)
    centre format relative to the image, scores (N, GH·GW·A, C): conf =
    σ(t_o), class score conf·σ(t_c) kept where > obj_threshold;
    x = (col + s·σ(t_x) − (s − 1)/2) / GW, y likewise over GH,
    w = anchor_w·exp(t_w) / image, h = anchor_h·exp(t_h) / image."""
    n, gh, gw, a = head.shape[:4]
    dev = head.device
    anchors = torch.as_tensor(anchors, device=dev).reshape(a, 2)
    conf = torch.sigmoid(head[..., 4:5])
    scores = conf * torch.sigmoid(head[..., 5:])
    scores = torch.where(scores > obj_threshold, scores,
                         torch.zeros_like(scores))
    col = torch.arange(gw, dtype=torch.float32, device=dev).reshape(1, gw, 1)
    row = torch.arange(gh, dtype=torch.float32, device=dev).reshape(gh, 1, 1)
    half = (scale_x_y - 1.0) / 2.0
    x = (col + scale_x_y * torch.sigmoid(head[..., 0]) - half) / gw
    y = (row + scale_x_y * torch.sigmoid(head[..., 1]) - half) / gh
    w = anchors[:, 0] * torch.exp(head[..., 2]) / image
    h = anchors[:, 1] * torch.exp(head[..., 3]) / image
    boxes = torch.stack([x, y, w, h], dim=-1)
    return boxes.reshape(n, -1, 4), scores.reshape(n, -1, scores.shape[-1])


def merged(heads: List[torch.Tensor], cfg: dict, obj_threshold: float):
    """Every head decoded and concatenated in head order: numpy boxes
    (N, M, 4), scores (N, M, C), M = the candidates of all heads."""
    parts = [decode(h, a, s, cfg['image'], obj_threshold)
             for h, a, s in zip(heads, head_anchors(cfg), cfg['scale_x_y'])]
    return (torch.cat([b for b, _ in parts], 1).cpu().numpy(),
            torch.cat([s for _, s in parts], 1).cpu().numpy())


def detections(heads: List[torch.Tensor], cfg: dict,
               obj_threshold: float) -> List[list]:
    """The heads' detections per image, as `CfgDetector.detect_images`
    gives them: [(class index, score, (cx, cy, w, h))] by descending
    score (ties by rank in the cap), after the merge, the top-K cap,
    per-class greedy NMS and the valid test (best class score after NMS
    above obj_threshold)."""
    boxes, scores = merged(heads, cfg, obj_threshold)
    k = cfg['top_k']
    if k and k < boxes.shape[1]:
        boxes, scores = ref_serve.cap(boxes, scores, k)
    kept = ref_serve.nms(boxes, scores, cfg['nms_threshold'])
    labels, best = kept.argmax(-1), kept.max(-1)
    out = []
    for i in range(boxes.shape[0]):
        valid = np.nonzero(best[i] > np.float32(obj_threshold))[0]
        order = valid[np.argsort(-best[i][valid], kind='stable')]
        out.append([(int(labels[i, j]), float(best[i, j]),
                     tuple(float(v) for v in boxes[i, j])) for j in order])
    return out
