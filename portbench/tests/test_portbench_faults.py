"""Each fault a cell can have, planted in the program underneath a run
that skips only the look for a card, makes `correct` come out false.

The faults: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; an answer altered where it is
produced. The exchange between chips does not exist in these one-card
cells."""

import pytest
import torch

from portbench.tests import tiny


def _serve_state_unchanged(monkeypatch):
    from object_tracking_tpu_torch.inference import JointPredictor
    run = JointPredictor._run

    def stale(self, images, state, track_state):
        dets, ids, _, tracks = run(self, images, state, track_state)
        if state is None:
            state = self._zero_state(images.shape[0])
        return dets, ids, state, tracks
    monkeypatch.setattr(JointPredictor, '_run', stale)


def _serve_half_batch(monkeypatch):
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    forward = MultiObjDetTracker.forward

    def half(self, images, train=False, initial_state=None,
             return_state=False):
        # BatchNorm's statistics over the first half of the clips only
        b = images.shape[0]
        keep = max(b // 2, 1)
        t = images.shape[1]
        if keep == b:                       # one clip: half its frames
            images = torch.cat([images[:, :t // 2]] * 2, dim=1)
            return forward(self, images, train, initial_state, return_state)
        out = forward(self, images[:keep].repeat(2, 1, 1, 1, 1), train,
                      initial_state, return_state)
        return out
    monkeypatch.setattr(MultiObjDetTracker, 'forward', half)


def _serve_answer_altered(monkeypatch):
    from object_tracking_tpu_torch.inference import JointPredictor
    frames = JointPredictor._frames

    def altered(self, *args):
        out = frames(self, *args)
        for frame in out:
            if frame:
                frame[0]['track_id'] += 1
                break
        return out
    monkeypatch.setattr(JointPredictor, '_frames', altered)


def _train_state_unchanged(monkeypatch):
    from object_tracking_tpu_torch.training.state import TrainState

    def skip(self):
        self.step += 1
        return self
    monkeypatch.setattr(TrainState, 'apply_gradients', skip)


def _train_half_batch(monkeypatch):
    from object_tracking_tpu_torch.training import steps
    yolo = steps._yolo

    def half(netout, y_true, true_boxes, *args, **kwargs):
        keep = max(netout.shape[0] // 2, 1)
        return yolo(netout[:keep], y_true[:keep], true_boxes[:keep], *args,
                    **kwargs)
    monkeypatch.setattr(steps, '_yolo', half)


def _train_answer_altered(monkeypatch):
    from object_tracking_tpu_torch.training import steps
    yolo = steps.yolo_loss

    def altered(*args, **kwargs):
        loss, aux = yolo(*args, **kwargs)
        return loss * 1.01, dict(aux, loss=aux['loss'] * 1.01)
    monkeypatch.setattr(steps, 'yolo_loss', altered)


SERVE = {'state_unchanged': _serve_state_unchanged,
         'half_batch': _serve_half_batch,
         'answer_altered': _serve_answer_altered}
TRAIN = {'state_unchanged': _train_state_unchanged,
         'half_batch': _train_half_batch,
         'answer_altered': _train_answer_altered}


@pytest.mark.parametrize('workload,fault', [
    (w, f) for w in ('joint_serve_b8', 'joint_live_b1') for f in SERVE] + [
    (w, f) for w in ('joint_train_b4', 'yolov2_train_b32') for f in TRAIN])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    plant = (SERVE if 'train' not in workload else TRAIN)[fault]
    plant(monkeypatch)
    result = tiny.run(workload)
    assert not result['correct'], result['checks']
