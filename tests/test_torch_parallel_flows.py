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
  weights, and only rank 0 writes the logs and the checkpoint;
- the single-object and detector training flows over the same 2 ranks
  (`torch_ranks.spied_flow`): each rank's step sees half of each global
  batch (the detector's ragged last batch of 3 whole, replicated), every
  rank ends on the same weights, within the two-step bars of
  tests/test_torch_data_parallel.py (cosine > 0.999, norm ratio within
  5 %) of the one-rank flow's update, and only rank 0 writes.

One spawned world runs every 2-rank flow in turn. Small: 64x64 synthetic
frames, width_div=8, ConvLSTM-8 and batch 2 (joint), LSTM-16, T=3 and
batch 4 (single-object, detector), one epoch, one intra-op thread.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu_torch import trainer
from torch_ranks import (flow_world, run_world, spied_flow,
                         tiny_flow_config, tiny_joint_config)


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


FLOWS = {'pp_sp': ('joint', dict(convlstm_layers=2, pp_layers=True,
                                  time_shards=2, sequence_length=4)),
         'dp': ('joint', {}), 'single': ('single', {}),
         'detect': ('detect', {})}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """Every flow of FLOWS in one world of 2 ranks, each in its own
    workdir: {name: (workdir, [result per rank])}."""
    root = tmp_path_factory.mktemp('flows')
    flows = {}
    for name, (kind, options) in FLOWS.items():
        os.makedirs(root / name)
        flows[name] = (kind, str(root / name), options)
    ranks = run_world(flow_world, 2, root, flows, init=False, timeout=400)
    return {name: (flows[name][1], [r[name] for r in ranks])
            for name in flows}


def _same_weights(ranks):
    for k, v in ranks[0]['params'].items():
        for r in ranks[1:]:
            np.testing.assert_array_equal(r['params'][k], v, err_msg=k)


def test_joint_pp_sp_train_then_dense_eval_restore(world):
    """2 ranks: the first ConvLSTM layer's recurrence time-sharded over
    the data axis (T=4, two frames a rank) and a 1-layer stack pipelined
    over the model axis (one stage); then the dense eval rebuild (no
    pp_layers, no time_shards) restores the checkpoint rank 0 wrote."""
    wd, ranks = world['pp_sp']
    assert [r['world'] for r in ranks] == [2, 2]
    assert ranks[0]['step'] == ranks[1]['step'] > 0
    _same_weights(ranks)
    dense = tiny_joint_config()
    dense.joint.convlstm_layers = 2
    _eval(dense, wd)


def test_joint_data_parallel_flow_writes_once(world):
    wd, ranks = world['dp']
    _same_weights(ranks)
    assert os.listdir(os.path.join(wd, 'logs')) == ['run_1']
    assert sorted(os.listdir(os.path.join(wd, 'models', 'multi_obj'))) == [
        'ckpt_1.json', 'ckpt_1.pt']
    assert any('train/loss' in r for r in _logged(wd))


def _update(seen):
    return np.concatenate([(seen['params'][k] - seen['initial'][k]).ravel()
                           for k in sorted(seen['params'])])


# each step's global batch, its share on a rank, and whether shard_batch
# replicated it
SLICES = {'single': ([4, 4], [2, 2], [False, False]),
          'detect': ([4, 3], [2, 3], [False, True])}
CHECKPOINTS = {'single': 'tiny_tracker', 'detect': 'yolov2'}


@pytest.mark.parametrize('flow', ['single', 'detect'])
def test_flow_trains_data_parallel(world, tmp_path, flow):
    """The single-object or detector flow over 2 ranks: each rank's step
    sees half of each global batch of 4 (the detector's ragged last batch
    of 3 replicated whole), every rank ends on the same weights, the
    update lies within cosine > 0.999 and norm ratio 1 ± 5 % of the
    one-rank flow's, and only rank 0 writes the logs and the
    checkpoint."""
    wd, ranks = world[flow]
    ref = spied_flow(flow, tiny_flow_config(), str(tmp_path))
    whole, local, replicated = SLICES[flow]
    assert ref['local_batch'] == whole
    for r in ranks:
        assert r['local_batch'] == local and r['replicated'] == replicated
        assert r['step'] == ref['step'] == 2
        for k, v in ref['initial'].items():
            np.testing.assert_array_equal(r['initial'][k], v, err_msg=k)
    _same_weights(ranks)
    d, d_ref = _update(ranks[0]), _update(ref)
    cos = d @ d_ref / (np.linalg.norm(d) * np.linalg.norm(d_ref))
    ratio = np.linalg.norm(d) / np.linalg.norm(d_ref)
    assert cos > 0.999 and abs(ratio - 1.0) < 0.05, (flow, cos, ratio)
    assert os.listdir(os.path.join(wd, 'logs')) == ['run_1']
    assert sorted(os.listdir(os.path.join(wd, 'models',
                                          CHECKPOINTS[flow]))) == [
        'ckpt_1.json', 'ckpt_1.pt']
