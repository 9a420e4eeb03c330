"""Constants and config fields of the serving, detector and training paths.

The port keeps its own copy of what it reads from the JAX package's
`object_tracking_tpu/config.py` (anchors, the track gate, the COCO and
MOT17 label sets, the `DetectorConfig`, `LossConfig`, `TrackerConfig`,
`JointConfig`, `TrainConfig` and `MeshConfig` fields, and config loading),
so that importing it never imports the JAX package. `Config` holds the
six sections and reads and writes both JSON layouts: the new one
(`Config.to_json` / `from_dict`) and the reference's legacy config.json
(`from_legacy_json`); `load_config` tells them apart. The parallel
options (the mesh, `time_shards`, `moe_experts`, `pp_layers`) are read
and written here, and the joint flow runs them (`parallel/`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# Anchor priors (grid-cell units) — YOLOv2 COCO anchors.
YOLOV2_ANCHORS: Tuple[float, ...] = (
    0.57273, 0.677385, 1.87446, 2.06253, 3.33843,
    5.47434, 7.88282, 3.52778, 9.77052, 9.16828,
)

# Track-association IoU gate shared by every identity-assignment layer
# (ops/matching.assign_tracks, TrackManager, inference.JointPredictor).
# NOT the NMS threshold and NOT the eval match threshold.
TRACK_GATE_IOU: float = 0.3

LABELS_COCO: Tuple[str, ...] = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
    'train', 'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse',
    'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
    'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
    'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
    'baseball glove', 'skateboard', 'surfboard', 'tennis racket', 'bottle',
    'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl', 'banana',
    'apple', 'sandwich', 'orange', 'broccoli', 'carrot', 'hot dog',
    'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant', 'bed',
    'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush',
)

LABELS_MOT17: Tuple[str, ...] = tuple(str(i) for i in range(1, 13))


@dataclass
class DetectorConfig:
    """YOLOv2 detector fields (the joint path's label set is
    JointConfig.labels)."""
    labels: Tuple[str, ...] = LABELS_COCO
    image_h: int = 416
    image_w: int = 416
    grid_h: int = 13
    grid_w: int = 13
    num_anchors: int = 5
    anchors: Tuple[float, ...] = YOLOV2_ANCHORS
    obj_threshold: float = 0.5
    nms_threshold: float = 0.45
    # darknet yolov2.weights to load at construction
    weights_path: Optional[str] = None
    # Frozen prior source of the single-object pipeline: 'yolo' (YOLOv2),
    # 'vgg16' (VGG16 with its dense detection head) or 'fake'.
    backend: str = 'yolo'
    # VGG16 backend: an .npz of named arrays, the fc6/fc7 width and the
    # channel divisor (4096 and 1 = the standard VGG16).
    vgg_weights_path: Optional[str] = None
    vgg_fc_features: int = 4096
    vgg_width_div: int = 1
    # Optional darknet .cfg of the detector graph (else Darknet-19).
    cfg_path: Optional[str] = None
    # Feature layer the single-object trackers consume.
    feature_layer: str = 'conv_feat'
    # Detector-training batch size.
    batch_size: int = 32
    # Backbone channel-width divisor (floor 4 channels); 1 = full width.
    width_div: int = 1

    @property
    def num_classes(self) -> int:
        return len(self.labels)


@dataclass
class LossConfig:
    """YOLOv2 loss scales."""
    no_object_scale: float = 1.0
    object_scale: float = 5.0
    coord_scale: float = 1.0
    class_scale: float = 1.0
    warm_up_batches: int = 0
    true_box_buffer: int = 50
    best_iou_threshold: float = 0.6


@dataclass
class TrackerConfig:
    """Single-object tracker fields."""
    name: str = 'TinyTracker'     # or 'TinyHeatmapTracker'
    lstm_units: int = 512
    sequence_length: int = 4
    heatmap_size: int = 32
    pool: str = 'Global'          # 'Global' or 'Max'
    # 'bce' (binary cross-entropy on the sigmoid outputs) or 'huber'.
    loss: str = 'bce'
    # The bbox head predicts a presence-gated correction of its detection
    # input (models/tiny_tracker.py); needs loss 'huber'.
    residual: bool = False
    # Per-frame probability of zeroing the detection input (a missed
    # detection) in the batches.
    det_dropout: float = 0.0


@dataclass
class JointConfig:
    """Joint detect+track model and training fields."""
    labels: Tuple[str, ...] = LABELS_MOT17
    batch_size: int = 1
    sequence_length: int = 4
    convlstm_features: int = 512
    loss_weight_track: float = 0.7
    loss_weight_detect: float = 0.3
    # 'bfloat16' activations (parameters stay float32) or 'float32'.
    compute_dtype: str = 'float32'
    # Recompute the per-frame detector in backward (activation memory for
    # FLOPs, so that sequence_length can grow).
    remat: bool = False
    # > 0: the mixture-of-experts tracking head (models/moe_head.py) with
    # moe_hidden units per expert, its Switch auxiliary loss weighted by
    # moe_aux_weight; time_shards > 1 shards the clip's time axis over the
    # mesh's data axis (sequence parallelism); pp_layers pipelines the
    # stacked ConvLSTM layers over the model axis, one layer per rank.
    moe_experts: int = 0
    moe_hidden: int = 256
    moe_aux_weight: float = 0.01
    time_shards: int = 1
    # Total ConvLSTM depth of the tracking head (layer 0 projects the
    # detector features; layers 1..L-1 are homogeneous F→F).
    convlstm_layers: int = 1
    pp_layers: bool = False


@dataclass
class TrainConfig:
    """Training hyperparameters and the callback stack."""
    train_image_folder: str = 'data/VisualTB/'
    train_annot_folder: str = 'data/VisualTBAnn/train/'
    val_image_folder: str = 'data/VisualTB/'
    val_annot_folder: str = 'data/VisualTBAnn/val/'
    batch_size: int = 4
    max_epochs: int = 100
    learning_rate: float = 1e-3
    joint_learning_rate: float = 1e-4
    # Global-norm gradient clipping (optax's clip_by_global_norm rule);
    # None disables.
    grad_clip_norm: Optional[float] = None
    early_stop_patience: int = 10
    reduce_lr_factor: float = 0.5
    reduce_lr_patience: int = 5
    # Plateau patience of the joint flow.
    joint_reduce_lr_patience: int = 2
    min_lr: float = 1e-5
    tensorboard_dir: str = 'logs/'
    saved_model_dir: str = 'models/'
    classes: Tuple[str, ...] = ('Person', 'Car')
    # Keeps the legacy host pipeline (augmented pixels on the host).
    debug: bool = False
    seed: int = 0
    max_boxes_per_image: int = 50
    resume: bool = False
    # Learning rate to set after a resume (the restored one otherwise).
    resume_lr: Optional[float] = None
    checkpoint_dir: str = 'checkpoints/'
    # Save every N epochs; the final epoch always saves.
    checkpoint_every_epochs: int = 1
    augment: bool = True
    log_every_steps: int = 1
    # Non-empty enables the parsed-annotation pickle cache.
    annotation_cache_dir: str = ''
    # True: raw uint8 batches and the fused steps (normalise, augment,
    # encode targets, forward, backward and Adam on the device); False:
    # the legacy host pipeline.
    device_data: bool = True


@dataclass
class MeshConfig:
    """The (data, model) mesh over the world's ranks, one process per
    device (`parallel/mesh.py`). `distributed` joins a process group:
    `coordinator_address` is its rendezvous ('host:port' or an init-method
    URL), `num_processes` the world size and `process_id` this rank; -1
    reads them from the environment (torchrun)."""
    data_axis: str = 'data'
    model_axis: str = 'model'
    # -1 means "all remaining devices"
    data_parallel: int = -1
    model_parallel: int = 1
    distributed: bool = False
    coordinator_address: Optional[str] = None
    num_processes: int = -1
    process_id: int = -1


@dataclass
class Config:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> 'Config':
        """The new layout: one dict per section, keyed by field name
        (unknown keys are ignored, lists become tuples)."""
        def build(dc_cls, sub):
            kwargs = {}
            for f in dataclasses.fields(dc_cls):
                if f.name in sub:
                    v = sub[f.name]
                    kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            return dc_cls(**kwargs)

        return cls(**{f.name: build(f.default_factory, d.get(f.name, {}))
                      for f in dataclasses.fields(cls)})

    @classmethod
    def from_legacy_json(cls, d: Dict[str, Any]) -> 'Config':
        """The reference's config.json layout ('model_detector',
        'model_tracker', 'train' and 'val' blocks)."""
        cfg = cls()
        md = d.get('model_detector', {})
        if 'name' in md:
            # the reference dispatches on this name: 'YOLO' → darknet,
            # 'FasterRCNN' → VGG16
            cfg.detector.backend = (
                'vgg16' if md['name'] == 'FasterRCNN' else 'yolo')
        if 'nms' in md:
            cfg.detector.nms_threshold = float(md['nms'])
        if 'thresh' in md:
            cfg.detector.obj_threshold = float(md['thresh'])
        if 'weights_file' in md:
            cfg.detector.weights_path = md['weights_file']
        if 'config_file' in md:
            cfg.detector.cfg_path = md['config_file']
        mt = d.get('model_tracker', {})
        for key in ('name', 'lstm_units', 'sequence_length', 'heatmap_size'):
            if key in mt:
                setattr(cfg.tracker, key, mt[key])
        tr = d.get('train', {})
        for key in ('train_image_folder', 'train_annot_folder', 'batch_size',
                    'max_epochs', 'tensorboard_dir', 'saved_model_dir'):
            if key in tr:
                setattr(cfg.train, key, tr[key])
        if 'pool' in tr:
            cfg.tracker.pool = tr['pool']
        if 'classes' in tr:
            cfg.train.classes = tuple(tr['classes'])
        if 'debug' in tr:
            cfg.train.debug = bool(tr['debug'])
        va = d.get('val', {})
        for key in ('val_image_folder', 'val_annot_folder'):
            if key in va:
                setattr(cfg.train, key, va[key])
        return cfg


def load_config(path: str) -> Config:
    """A config JSON file in either layout."""
    with open(path) as f:
        d = json.load(f)
    if 'model_detector' in d or 'model_tracker' in d:
        return Config.from_legacy_json(d)
    return Config.from_dict(d)
