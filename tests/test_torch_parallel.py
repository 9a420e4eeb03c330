"""Port parity of the mesh, the batch's slice, the context-parallel scan
and the pipeline against the JAX package on the CPU.

JAX runs on the virtual CPU devices of tests/conftest.py; the port's
multi-rank side runs in spawned gloo worlds of 2 and 4 ranks
(`torch_ranks.scan_world`, one world per size running every check),
which hand numpy arrays back. Tolerance 1e-5 for scans and pipelines
(JAX's own), and for the time-sharded and pipelined ConvLSTM layers
against the port's dense layers (outputs and gradients; the pipelined
stack projects each step's input inside its stage, the dense stack all
steps at once, which differs by rounding only).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_tracking_tpu.config import MeshConfig as JMeshConfig
from object_tracking_tpu.parallel import context_parallel_scan as jcps
from object_tracking_tpu.parallel import gpipe as jgpipe
from object_tracking_tpu.parallel import make_mesh as jmake_mesh
from object_tracking_tpu.parallel import pipeline_scan as jpipeline
from object_tracking_tpu_torch.config import MeshConfig
from object_tracking_tpu_torch.parallel import (Mesh, ShardedBatch,
                                                data_sharding,
                                                distributed_init,
                                                is_replicated,
                                                local_batch_size, make_mesh,
                                                replicated_sharding,
                                                shard_batch, whole_batch)
from object_tracking_tpu_torch.parallel import mesh as mesh_mod
from torch_ranks import scan_world, run_world

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------- one process, no group
def test_mesh_shape_default():
    mesh = make_mesh()
    assert mesh.shape == {'data': 1, 'model': 1}
    assert mesh.axis_names == ('data', 'model')
    assert mesh.group('data') is None and mesh.index('model') == 0


def test_mesh_model_parallel_split():
    """Without a process group the world is one rank: a mesh that needs
    two raises, as JAX's does with too few devices."""
    with pytest.raises(ValueError, match='needs 2 devices, have 1'):
        make_mesh(MeshConfig(model_parallel=2))


def test_local_batch_size():
    mesh = Mesh({'data': 4, 'model': 1})
    assert local_batch_size(mesh, 16) == 4
    with pytest.raises(ValueError):
        local_batch_size(mesh, 5)


def test_shard_batch_layout(caplog):
    """Rank 0 of a data axis of 2 keeps the first half of each leaf along
    `axis`; a ragged axis replicates, warning once per shape."""
    mesh = Mesh({'data': 2, 'model': 1})
    batch = {'x': np.arange(12).reshape(4, 3), 'y': (np.zeros((4, 6, 2)),)}
    out = shard_batch(mesh, batch)
    np.testing.assert_array_equal(out['x'], batch['x'][:2])
    assert out['y'][0].shape == (2, 6, 2)
    assert shard_batch(mesh, batch['y'][0], axis=1).shape == (4, 3, 2)
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            ragged = shard_batch(mesh, {'x': np.zeros((3, 3))})
    assert ragged['x'].shape == (3, 3)
    assert sum('replicating' in r.message for r in caplog.records) == 1
    assert [type(p).__name__ for p in data_sharding(mesh)] == [
        'Shard', 'Replicate']
    assert len(replicated_sharding(mesh)) == 2


def test_shard_batch_reports_replication():
    """A dict comes back as a ShardedBatch that says whether it was
    sliced or replicated; one ragged leaf replicates every leaf (the step
    then runs on the whole batch). Inside whole_batch(replicas), and only
    there, the replicas' group is at hand for the gradients' mean."""
    mesh = Mesh({'data': 2, 'model': 1})
    sliced = shard_batch(mesh, {'x': np.zeros((4, 3)), 'n': np.int32(5)})
    assert isinstance(sliced, ShardedBatch) and not sliced.replicated
    assert sliced['x'].shape == (2, 3) and sliced['n'] == 5
    ragged = shard_batch(mesh, {'x': np.zeros((4, 3)),
                                'y': (np.zeros((3, 2)),)})
    assert ragged.replicated and is_replicated(ragged)
    assert ragged['x'].shape == (4, 3) and ragged['y'][0].shape == (3, 2)
    assert not is_replicated({'x': np.zeros(3)})
    replicas = object()
    assert not mesh_mod.in_whole_batch()
    assert mesh_mod.replica_group() is None
    with whole_batch(replicas):
        assert mesh_mod.in_whole_batch()
        assert mesh_mod.replica_group() is replicas
    assert not mesh_mod.in_whole_batch()
    assert mesh_mod.replica_group() is None


def test_distributed_init_flag_plumbing(monkeypatch):
    """A no-op unless cfg.distributed; passes only what is set (the
    address as an init method, the count as the world size, the id as
    the rank); the backend follows the flow's device; idempotent."""
    calls, up = [], [False]

    def init(**kw):
        calls.append(kw)
        up[0] = True
    monkeypatch.setattr(mesh_mod.dist, 'init_process_group', init)
    monkeypatch.setattr(mesh_mod.dist, 'is_initialized', lambda: up[0])
    monkeypatch.setattr(mesh_mod.torch.cuda, 'set_device', lambda i: None)

    assert distributed_init(MeshConfig()) is False
    assert calls == []

    cfg = MeshConfig(distributed=True, coordinator_address='10.0.0.1:1234',
                     num_processes=4, process_id=2)
    assert distributed_init(cfg, 'cpu') is True
    assert calls == [{'backend': 'gloo', 'init_method': 'tcp://10.0.0.1:1234',
                      'world_size': 4, 'rank': 2}]
    assert distributed_init(cfg) is True              # idempotent
    assert len(calls) == 1

    up[0] = False
    assert distributed_init(MeshConfig(distributed=True), 'cuda') is True
    assert calls[-1] == {'backend': 'nccl'}       # torchrun's environment
    up[0] = False
    distributed_init(MeshConfig(distributed=True,
                                coordinator_address='file:///tmp/s'))
    assert calls[-1] == {'backend': 'gloo', 'init_method': 'file:///tmp/s'}


# ------------------------------------------------- gloo worlds (2, 4 ranks)
def _jcell(c, x):
    c = jnp.tanh(c * 0.9 + x)
    return c, 2.0 * c


def _jtree_cell(carry, x):
    h = jnp.tanh(carry['h'] + x)
    c = carry['c'] * 0.5 + h
    return {'h': h, 'c': c}, h + c


def _jstage(params, carry, x):
    carry = jnp.tanh(carry @ params['u'] + x @ params['w'])
    return carry, carry + x * 0.1


@pytest.fixture(scope='module', params=[2, 4], ids=lambda n: f'{n}ranks')
def world(request, tmp_path_factory):
    n = request.param
    rng = np.random.RandomState(n)
    f32 = np.float32
    inputs = {
        'exact': rng.randn(3 * n, 4).astype(f32),
        'exact_w': rng.randn(3 * n, 4).astype(f32),
        'tree': rng.randn(2 * n, 2).astype(f32),
        'halo': rng.randn(4 * n, 4).astype(f32),
        'lstm_x': rng.randn(2, 2 * n, 3, 4, 4).astype(f32),
        'lstm_w': rng.randn(2, 2 * n, 4, 4, 4).astype(f32),
        'stack': {'w': (rng.randn(n, 4, 4) * 0.4).astype(f32),
                  'u': (rng.randn(n, 4, 4) * 0.4).astype(f32)},
        'stack_x': rng.randn(5, 4).astype(f32),
        'gpipe': {'w': (rng.randn(n, 8, 8) * 0.3).astype(f32),
                  'b': (rng.randn(n, 8) * 0.1).astype(f32)},
        'gpipe_x': rng.randn(6, 4, 8).astype(f32),
        'stacked_x': rng.randn(1, 3, 4, 3, 3).astype(f32),
        'stacked_w': rng.randn(1, 3, 4, 3, 3).astype(f32),
    }
    results = run_world(scan_world, n, tmp_path_factory.mktemp('scan'),
                        inputs, timeout=150)
    return n, inputs, results


def _jmesh(n, dp, mp):
    return jmake_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp),
                      jax.devices()[:n])


def test_context_parallel_scan_exact_matches_lax_scan(world):
    """The exact ring over n ranks: every rank's block of ys, and the
    gradient of Σ w·ys with respect to its block of xs."""
    n, inputs, results = world
    xs, w = jnp.asarray(inputs['exact']), jnp.asarray(inputs['exact_w'])
    ref = np.asarray(jax.lax.scan(_jcell, jnp.zeros(4), xs)[1])
    grad = np.asarray(jax.grad(lambda x: jnp.sum(
        jax.lax.scan(_jcell, jnp.zeros(4), x)[1] * w))(xs))
    for rank, out in enumerate(results):
        rows = slice(rank * 3, (rank + 1) * 3)
        np.testing.assert_allclose(out['exact'], ref[rows], **TOL)
        np.testing.assert_allclose(out['exact_grad'], grad[rows], **TOL)


def test_context_parallel_scan_pytree_carry(world):
    n, inputs, results = world
    c0 = {'h': jnp.zeros(2), 'c': jnp.zeros(2)}
    ref = np.asarray(jax.lax.scan(_jtree_cell, c0,
                                  jnp.asarray(inputs['tree']))[1])
    for rank, out in enumerate(results):
        np.testing.assert_allclose(out['tree'],
                                   ref[rank * 2:(rank + 1) * 2], **TOL)


def test_context_parallel_scan_halo_matches_jax(world):
    """halo=2: each rank warm-starts on its predecessor's last 2 steps,
    JAX's halo scan over an n-device mesh; the first block is exact."""
    n, inputs, results = world
    xs = jnp.asarray(inputs['halo'])
    ref = np.asarray(jcps(_jcell, jnp.zeros(4), xs, _jmesh(n, n, 1), 'data',
                          halo=2))
    exact = np.asarray(jax.lax.scan(_jcell, jnp.zeros(4), xs)[1])
    for rank, out in enumerate(results):
        assert out['halo'].shape == (4, 4)
        np.testing.assert_allclose(out['halo'],
                                   ref[rank * 4:(rank + 1) * 4], **TOL)
    np.testing.assert_allclose(results[0]['halo'], exact[:4], **TOL)


def test_context_parallel_scan_rejects_ragged_time(world):
    n, _, results = world
    for out in results:
        assert f'time axis {3 + 2 * (n - 1)} not divisible by axis size ' \
               f'{n}' in out['err_ragged']


def test_time_sharded_convlstm_matches_dense(world):
    """FusedConvLSTM(time_shards=n) on each rank's T/n frames: its block
    of the dense layer's hidden states and input gradients, and the
    parameter gradients summed over the data group."""
    n, _, results = world
    for out in results:
        rows = slice(*out['lstm_slice'])
        np.testing.assert_allclose(out['lstm_sp'],
                                   out['lstm_dense'][:, rows], **TOL)
        np.testing.assert_allclose(out['lstm_sp_xgrad'],
                                   out['lstm_dense_xgrad'][:, rows], **TOL)
        for k, g in out['lstm_sp_grads'].items():
            np.testing.assert_allclose(g, out['lstm_dense_grads'][k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_pipeline_scan_stacked_recurrence_matches_jax(world):
    n, inputs, results = world
    params = {k: jnp.asarray(v) for k, v in inputs['stack'].items()}
    ref = np.asarray(jpipeline(_jstage, params,
                               jnp.asarray(inputs['stack_x']),
                               _jmesh(n, 1, n), 'model',
                               carry_init=jnp.zeros((n, 4))))
    for out in results:                     # shared with every rank
        np.testing.assert_allclose(out['stack'], ref, **TOL)


def test_gpipe_matches_jax(world):
    n, inputs, results = world
    params = {k: jnp.asarray(v) for k, v in inputs['gpipe'].items()}
    ref = np.asarray(jgpipe(lambda p, x: jnp.tanh(x @ p['w'] + p['b']),
                            params, jnp.asarray(inputs['gpipe_x']),
                            _jmesh(n, 1, n), 'model'))
    for out in results:
        np.testing.assert_allclose(out['gpipe'], ref, **TOL)


def test_pipeline_scan_rejects_bad_stages(world):
    n, _, results = world
    for out in results:
        assert 'must match' in out['err_shape']
        assert f'leading axis {n + 1} != axis size {n}' in out['err_stages']


def test_pipelined_convlstm_stack_matches_dense(world):
    """StackedConvLSTM(pipeline=True) over n ranks: each rank holds one
    layer's slice; from the same seed the gathered weights are the dense
    stack's, and the outputs and every gradient agree."""
    n, _, results = world
    for out in results:
        assert all(shape[0] == 1 for shape in out['stacked_pp_held'])
        assert all(shape[0] == n for shape in out['stacked_dense_held'])
        for k, v in out['stacked_dense_weights'].items():
            np.testing.assert_array_equal(out['stacked_pp_weights'][k], v)
        np.testing.assert_allclose(out['stacked_pp'], out['stacked_dense'],
                                   **TOL)
        np.testing.assert_allclose(out['stacked_pp_xgrad'],
                                   out['stacked_dense_xgrad'], **TOL)
        for k, g in out['stacked_pp_grads'].items():
            np.testing.assert_allclose(g, out['stacked_dense_grads'][k],
                                       **TOL, err_msg=k)


def test_pipelined_stack_gradient_clip_uses_the_dense_norm(world):
    """clip_model_gradients_ on the pipelined stack: each stage's squared
    norm is summed over the stage group, so the global norm and the
    clipped gradients are the dense stack's (optax's rule: scaled by
    max/norm when norm >= max)."""
    n, _, results = world
    for out in results:
        dense = out['stacked_dense_unclipped']
        norm = np.sqrt(sum(np.sum(g ** 2) for g in dense.values()))
        np.testing.assert_allclose(out['stacked_pp_norm'], norm, rtol=1e-5)
        np.testing.assert_allclose(out['stacked_dense_norm'], norm,
                                   rtol=1e-5)
        assert norm > 0.5                          # the clip engaged
        for k, g in out['stacked_pp_grads'].items():
            np.testing.assert_allclose(g, dense[k] * 0.5 / norm, **TOL,
                                       err_msg=k)


def test_mesh_layout_and_shard_batch_in_a_world(world):
    """make_mesh over the world: data = all ranks, or (n/2, 2) row-major
    (rank = data index · 2 + model index, JAX's reshape(dp, mp)); each
    rank keeps its block of the global batch along B or T; ragged leaves
    replicate; a mesh larger than the world raises; whole_batch() drops
    the data axis's group and average_gradients_ takes the ranks' mean."""
    n, _, results = world
    for rank, out in enumerate(results):
        shape, d, m = out['layout']
        if n % 2 == 0:
            assert shape == {'data': n // 2, 'model': 2}
            assert (d, m) == divmod(rank, 2)
        np.testing.assert_array_equal(
            out['shard']['x'], np.arange(2 * n * 3).reshape(2 * n, 3)[
                2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out['shard']['y'], [rank])
        assert out['shard_t'] == (2, 2, 5)
        assert out['ragged'] == (n + 1, 3)
        assert f'needs {2 * n} devices, have {n}' in out['err_mesh']
        # whole_batch() drops the data axis's group, not the model axis's
        assert out['groups'] == out['whole_groups'] == (True, True)
        # the replicas' gradients averaged: rank r held r everywhere
        np.testing.assert_array_equal(out['average'], [(n - 1) / 2] * 2)
