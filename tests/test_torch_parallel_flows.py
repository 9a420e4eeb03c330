"""The port's joint flow with the parallel options, end to end on the CPU,
mirroring tests/test_trainer_e2e.py (a slow-tier JAX test) on the port:

- `joint.moe_experts`: the expert parameters exist, `train/moe_aux` is
  logged non-zero, `evaluate_tracking` rebuilds the MoE model from the
  same config and restores its checkpoint, and `export_serving` exports
  it, serving what `JointPredictor` serves;
- pipeline + sequence parallelism over a world of 2 gloo ranks that the
  flow joins itself (`mesh.distributed` with a file:// rendezvous,
  `torch_ranks.flow_world`): trained with `pp_layers` and
  `time_shards=2`, its checkpoint restores into the dense eval model;
- plain data parallelism over 2 ranks: every rank ends on the same
  weights, and only rank 0 writes the logs and the checkpoint.

Small: 64x64 synthetic frames, width_div=8, ConvLSTM-8, batch 2, one
epoch, one intra-op thread.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch import trainer
from torch_ranks import flow_world, run_world, tiny_joint_config


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logged(workdir):
    recs = []
    for path in glob.glob(os.path.join(workdir, '**', 'metrics.jsonl'),
                          recursive=True):
        with open(path) as f:
            recs += [json.loads(line) for line in f if line.strip()]
    return recs


def _eval(cfg, workdir):
    results = trainer.evaluate_tracking(
        cfg, synthetic=True, workdir=workdir, device='cpu',
        checkpoint_dir=os.path.join(workdir, cfg.train.saved_model_dir,
                                    'multi_obj'))
    assert 'overall' in results
    assert all(v == v for v in results['overall'].values())   # no NaN
    return results


def _moe_config():
    cfg = tiny_joint_config()
    cfg.joint.moe_experts = 2
    cfg.joint.moe_hidden = 8
    return cfg


@pytest.fixture(scope='module')
def moe_run(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp('moe'))
    state = trainer.simult_multi_obj_detection_tracking(
        _moe_config(), synthetic=True, workdir=wd, device='cpu')
    return wd, state


def test_joint_moe_flow_end_to_end(moe_run):
    wd, state = moe_run
    cfg = _moe_config()
    names = [n for n, _ in state.model.named_parameters()]
    assert {'tconv_moe.gate', 'tconv_moe.w1'} <= set(names)
    assert not any(n.startswith('tconv_2') for n in names)
    aux = [r['train/moe_aux'] for r in _logged(wd) if 'train/moe_aux' in r]
    assert aux and all(a > 0 for a in aux), aux[:5]
    _eval(cfg, wd)


def test_moe_export_serving_matches_joint_predictor(moe_run, tmp_path):
    """`export_serving` rebuilds the MoE model from the config, restores
    the checkpoint and exports it; the artifact serves what
    JointPredictor serves on the same weights (labels and ids equal,
    boxes and scores within 1e-5; NMS by the same custom op)."""
    from object_tracking_tpu_torch.inference import JointPredictor
    from object_tracking_tpu_torch.serving import ServedJointPredictor
    wd, state = moe_run
    cfg = _moe_config()
    cfg.joint.sequence_length = 2
    path = trainer.export_serving(
        cfg, out_path=str(tmp_path / 'moe.ottserve'), device='cpu',
        checkpoint_dir=os.path.join(wd, 'models', 'multi_obj'))
    served = ServedJointPredictor.load(path, device='cpu')
    model = trainer._joint_model(cfg, cfg.joint.labels)
    trainer._restore_variables(model, os.path.join(wd, 'models',
                                                   'multi_obj'))
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[name])
    pred = JointPredictor(model, cfg.detector.anchors, cfg.joint.labels,
                          obj_threshold=cfg.detector.obj_threshold,
                          nms_threshold=cfg.detector.nms_threshold,
                          net_size=(64, 64), device='cpu', nms_impl='op')
    frames = (np.random.RandomState(0).rand(1, 2, 64, 64, 3) * 255).astype(
        np.uint8)
    got = served.predict_window(frames)[0]
    want = pred.predict_window(frames[0].astype(np.float32) / 255.0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert [d['label'] for d in g] == [d['label'] for d in w]
        assert [d['track_id'] for d in g] == [d['track_id'] for d in w]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a['box'], b['box'], atol=1e-5)
            np.testing.assert_allclose(a['score'], b['score'], atol=1e-5)


def test_joint_pp_sp_train_then_dense_eval_restore(tmp_path):
    """2 ranks: the first ConvLSTM layer's recurrence time-sharded over
    the data axis (T=4, two frames a rank) and a 1-layer stack pipelined
    over the model axis (one stage); then the dense eval rebuild (no
    pp_layers, no time_shards) restores the checkpoint rank 0 wrote."""
    wd = str(tmp_path / 'ppsp')
    os.makedirs(wd)
    joint = dict(convlstm_layers=2, pp_layers=True, time_shards=2,
                 sequence_length=4)
    ranks = run_world(flow_world, 2, tmp_path, wd, joint, init=False,
                      timeout=240)
    assert [r['world'] for r in ranks] == [2, 2]
    assert ranks[0]['step'] == ranks[1]['step'] > 0
    for k, v in ranks[0]['params'].items():
        np.testing.assert_array_equal(ranks[1]['params'][k], v, err_msg=k)
    dense = tiny_joint_config()
    dense.joint.convlstm_layers = 2
    _eval(dense, wd)


def test_joint_data_parallel_flow_writes_once(tmp_path):
    wd = str(tmp_path / 'dp')
    os.makedirs(wd)
    ranks = run_world(flow_world, 2, tmp_path, wd, {}, init=False,
                      timeout=240)
    for k, v in ranks[0]['params'].items():
        np.testing.assert_array_equal(ranks[1]['params'][k], v, err_msg=k)
    assert os.listdir(os.path.join(wd, 'logs')) == ['run_1']
    assert sorted(os.listdir(os.path.join(wd, 'models', 'multi_obj'))) == [
        'ckpt_1.json', 'ckpt_1.pt']
    assert any('train/loss' in r for r in _logged(wd))
