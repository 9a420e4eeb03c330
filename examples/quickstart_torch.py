"""Quickstart of the PyTorch port: every flow, end to end, on synthetic data.

The counterpart of `examples/quickstart.py` for `object_tracking_tpu_torch`.
It runs the eight flows on fabricated VOC-style video data at tiny model
sizes:

    python examples/quickstart_torch.py                 # on the CUDA card
    python examples/quickstart_torch.py --device cpu    # without a card

Flows:
  1. single_object_tracking      — TinyTracker over frozen detector priors
  2. single (heatmap)            — the heatmap head
  3. simult_multi_obj_detection_tracking — joint Darknet-19 + ConvLSTM
                                   training (a deep, 2-layer ConvLSTM head)
  4. keras_yolo_obj_detection    — standalone detector training
  5. evaluate_tracking           — CLEAR-MOT metrics over the val split
  6. track_video                 — tracked frames with drawn ids
  7. golden detect               — the committed darknet .weights fixture
                                   through `CfgDetector`
  8. export_serving              — one torch.export artifact, served by
                                   ServedJointPredictor without model code

Frames are read and drawn with cv2, so flows 1–7 need it (the golden
scenes are jpgs); the serving flow takes arrays.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from object_tracking_tpu_torch.config import Config  # noqa: E402
from object_tracking_tpu_torch.trainer import (  # noqa: E402
    evaluate_tracking, export_serving, keras_yolo_obj_detection,
    simult_multi_obj_detection_tracking, single_object_tracking,
    track_video)


def tiny_config() -> Config:
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = 64
    cfg.detector.grid_h = cfg.detector.grid_w = 2
    cfg.detector.width_div = 8
    cfg.joint.convlstm_features = 16
    cfg.joint.sequence_length = 3
    cfg.tracker.sequence_length = 3
    cfg.tracker.lstm_units = 32
    cfg.train.batch_size = 2
    cfg.train.augment = False
    return cfg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda')
    device = parser.parse_args(argv).device
    work = tempfile.mkdtemp(prefix='ott_quickstart_')
    print(f'== workdir {work}, device {device}')

    print('== 1/8 single-object tracking (TinyTracker)')
    single_object_tracking(tiny_config(), synthetic=True, epochs=1,
                           workdir=work, device=device)

    print('== 2/8 single-object tracking (heatmap head)')
    cfg = tiny_config()
    cfg.tracker.name = 'TinyHeatmapTracker'
    cfg.tracker.heatmap_size = 8
    single_object_tracking(cfg, synthetic=True, epochs=1, workdir=work,
                           device=device)

    print('== 3/8 joint multi-object detection + tracking (deep head)')
    cfg = tiny_config()
    cfg.joint.convlstm_layers = 2
    simult_multi_obj_detection_tracking(cfg, synthetic=True, epochs=1,
                                        workdir=work, image_size=64,
                                        device=device)

    print('== 4/8 standalone detector training')
    keras_yolo_obj_detection(tiny_config(), synthetic=True, epochs=1,
                             workdir=work, train=True, device=device)

    print('== 5/8 tracking evaluation (CLEAR-MOT)')
    evaluate_tracking(tiny_config(), synthetic=True, window=3,
                      workdir=work, device=device)

    print('== 6/8 tracked-video inference (drawn boxes + persistent ids)')
    from object_tracking_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    cfg = tiny_config()
    cfg.joint.labels = ('1',)
    img_dir, _ = make_synthetic_dataset(
        os.path.join(work, 'clip'), num_videos=1, frames_per_video=6,
        image_size=(64, 64), labels=('1',))
    track_video(cfg, frames_dir=os.path.join(img_dir, 'video_00'),
                out_dir=os.path.join(work, 'tracked'), device=device)

    print('== 7/8 golden fixture: darknet binary -> real detections')
    fixtures = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tests', 'fixtures')
    from object_tracking_tpu_torch.models import CfgDetector
    det = CfgDetector(os.path.join(fixtures, 'yolov2-micro.cfg'),
                      weights_path=os.path.join(fixtures,
                                                'yolov2-micro.weights'),
                      labels=('1', '2'), device=device)
    for scene in ('scene_0.jpg', 'scene_1.jpg'):
        print(' ', scene, det.detect(os.path.join(fixtures, scene)))

    print('== 8/8 serving: export one artifact, serve without model code')
    from object_tracking_tpu_torch.serving import ServedJointPredictor
    cfg = tiny_config()
    cfg.joint.labels = ('1', '2')
    art_path = export_serving(cfg, out_path=os.path.join(
        work, 'joint.ottserve'), device=device)
    served = ServedJointPredictor.load(art_path, device=device)
    frames = np.random.RandomState(0).randint(
        0, 256, (1, cfg.joint.sequence_length, 64, 64, 3), np.uint8)
    out = served.predict_window(frames)
    print('  served', len(out[0]), 'frames from the artifact')

    print('== all flows complete')


if __name__ == '__main__':
    main()
