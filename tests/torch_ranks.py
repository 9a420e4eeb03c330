"""Multi-rank worlds of the port on the CPU, for the tests.

`run_world(fn, n, tmp_path, *args)` spawns n processes, each a gloo rank
of one world (a `file://` store under `tmp_path`, so that parallel test
workers never race for a port), runs `fn(rank, n, *args)` in each and
returns the n results, in rank order. Each rank sets one intra-op thread.
A rank that raises, or exits with a nonzero code, fails the test with its
traceback: the ranks still running `GRACE_S` seconds later (most often
waiting on a collective the failed rank never joins) are killed. A world
whose ranks all run past its `timeout` is killed too, and fails with each
rank's Python stacks at that moment.

This module imports neither JAX nor the JAX package: the ranks import
only the port, and hand numpy arrays back to the parent, which holds them
against JAX. `one_rank_world` is a world of one in this process.
"""

from __future__ import annotations

import contextlib
import faulthandler
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import signal
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def init_rank(rank: int, n: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            world_size=n, rank=rank)


def _entry(rank, n, store, out, fn, args):
    stacks = open(f'{out}.{rank}.stacks', 'w')
    faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
    try:
        if store:
            init_rank(rank, n, store)
        else:
            torch.set_num_threads(1)
        result = fn(rank, n, *args)
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(f'{out}.{rank}', 'wb') as f:
            pickle.dump(('ok', result), f)
    except BaseException:
        with open(f'{out}.{rank}', 'wb') as f:
            pickle.dump(('error', traceback.format_exc()), f)
        raise


def _outcome(out: str, rank: int, exitcode: int):
    """('ok', result) or ('error', text) of a rank that has exited."""
    if not os.path.exists(f'{out}.{rank}'):
        return 'error', f'exited with code {exitcode} and no result'
    with open(f'{out}.{rank}', 'rb') as f:
        return pickle.load(f)


def _stacks(procs, out: str) -> str:
    """The Python stacks of every live rank, each dumped by its own
    faulthandler on SIGUSR1."""
    live = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in live:
        with contextlib.suppress(OSError):
            os.kill(procs[r].pid, signal.SIGUSR1)
    time.sleep(2.0)
    text = []
    for r in live:
        path = f'{out}.{r}.stacks'
        dump = open(path).read() if os.path.exists(path) else 'not started'
        text.append(f'rank {r}:\n{dump}')
    return '\n'.join(text)


GRACE_S = 30.0          # how long the others may outlive a failed rank


def run_world(fn, n: int, tmp_path, *args, timeout: float = 120.0,
              init: bool = True):
    """[fn(rank, n, *args) for every rank] of an n-rank gloo world.
    `init=False` leaves joining the world to `fn` (the flows' own
    `distributed_init`), which gets the store's path as `args[0]`."""
    ctx = mp.get_context('spawn')
    base = os.path.join(str(tmp_path), f'world_{fn.__name__}_{n}')
    store, out = base + '.store', base + '.out'
    if not init:
        args = (store,) + args
    procs = [ctx.Process(target=_entry,
                         args=(r, n, store if init else None, out, fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    failed = []                         # ranks that failed, in exit order
    while True:
        live = [p for p in procs if p.is_alive()]
        left = end - time.monotonic()
        if not live or left <= 0:
            break
        multiprocessing.connection.wait([p.sentinel for p in live], left)
        for r, p in enumerate(procs):
            if p.exitcode not in (None, 0) and r not in failed:
                failed.append(r)
                end = min(end, time.monotonic() + GRACE_S)
    stacks = _stacks(procs, out) if not failed and live else ''
    for p in live:
        p.kill()
        p.join()
    if failed:
        errors = [f'rank {r} failed: '
                  f'{_outcome(out, r, procs[r].exitcode)[1]}' for r in failed]
        killed = (f'\n{len(live)} of {n} ranks still running {GRACE_S} s '
                  'after the first failure: killed') if live else ''
        raise RuntimeError(f'{fn.__name__}: ' + '\n'.join(errors) + killed)
    if live:
        raise TimeoutError(f'{fn.__name__}: {len(live)} of {n} ranks still '
                           f'running after {timeout} s: killed. Their '
                           f'stacks:\n{stacks}')
    results = [_outcome(out, r, p.exitcode) for r, p in enumerate(procs)]
    for r, (kind, value) in enumerate(results):
        if kind == 'error':
            raise RuntimeError(f'{fn.__name__}: rank {r} failed: {value}')
    return [value for _, value in results]


@contextlib.contextmanager
def one_rank_world(cfg, tmp_path):
    """`cfg.mesh` set to a distributed world of this process alone (gloo,
    a `file://` store); the process group is destroyed afterwards."""
    cfg.mesh.distributed = True
    cfg.mesh.coordinator_address = f'file://{tmp_path}/one_rank.store'
    cfg.mesh.num_processes = 1
    cfg.mesh.process_id = 0
    try:
        yield cfg
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------- workers
# Each runs in every rank of a world and returns numpy arrays.

def raising_world(rank, n, wait: str):
    """Rank 1 raises at once; every other rank waits for it, in an
    all-reduce it never joins (`wait='all_reduce'`: gloo sees the peer
    go) or on a store key it never sets (`'store'`: nothing does)."""
    if rank == 1:
        raise ValueError(f'rank 1 gives up at {time.time()!r}')
    if wait == 'all_reduce':
        dist.all_reduce(torch.ones(1))
    else:
        stuck_world(rank, n)


def stuck_world(rank, n):
    """Waits on a store key that nothing sets."""
    dist.distributed_c10d._get_default_store().wait(['rank 1 is here'])


def late_save_world(rank, n, directory):
    """Every rank saves step 1 of one small state into one directory, and
    rank 1 comes to it 3 s late, when rank 0 may long have written it.
    (What `save` returned, the steps on disk after a barrier.)"""
    from object_tracking_tpu_torch.training import (
        CheckpointManager, TrainState, make_optimizer)
    torch.manual_seed(0)
    state = TrainState.create(torch.nn.Linear(3, 1), make_optimizer(1e-2))
    if rank == 1:
        time.sleep(3.0)
    manager = CheckpointManager(directory)
    saved = manager.save(1, state)
    dist.barrier()
    return saved, manager.all_steps()


def _np(x):
    return x.detach().double().numpy()


def _mesh(dp: int, mp: int):
    from object_tracking_tpu_torch.config import MeshConfig
    from object_tracking_tpu_torch.parallel import make_mesh
    return make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ''


def moe_world(rank, n, params, tokens, per):
    """Expert parallelism over a model axis of n ranks (one expert each),
    and data-group routing of one global token order over a data axis of
    n ranks (contiguous shares, and two runs per rank)."""
    from object_tracking_tpu_torch.parallel import (
        expert_parallel_moe, moe_apply)
    out = {}
    ep_mesh = _mesh(1, n)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in
         params['ep'].items()}
    mine = torch.from_numpy(tokens['ep'][rank * per:(rank + 1) * per])
    mine.requires_grad_()
    y = expert_parallel_moe(p, mine, ep_mesh, 'model', capacity_factor=1.25)
    (y ** 2).sum().backward()
    out['ep'] = _np(y)
    out['ep_token_grad'] = _np(mine.grad)
    out['ep_expert_grad'] = _np(p['w1'].grad[rank])
    local = {k: (v if k == 'gate' else v[rank:rank + 1].detach())
             for k, v in p.items()}
    out['ep_local'] = _np(expert_parallel_moe(
        local, mine.detach(), ep_mesh, 'model'))
    wrong = {k: torch.from_numpy(v) for k, v in params['ep_wrong'].items()}
    out['err_experts'] = _error(lambda: expert_parallel_moe(
        wrong, mine.detach(), ep_mesh, 'model'))
    ragged = mine.detach() if rank else torch.cat([mine.detach()] * 2)
    out['err_ragged'] = _error(lambda: expert_parallel_moe(
        {k: v.detach() for k, v in p.items()}, ragged, ep_mesh, 'model'))

    data = _mesh(n, 1).data_group
    for name, runs in (('share', 1), ('runs', 2)):
        q = {k: torch.from_numpy(v).requires_grad_() for k, v in
             params['dense'].items()}
        glob = tokens['dense']
        size = glob.shape[0] // (n * runs)
        rows = [r * n * size + rank * size for r in range(runs)]
        mine = torch.from_numpy(np.concatenate(
            [glob[i:i + size] for i in rows]))
        y, aux = moe_apply(q, mine, return_aux=True, group=data,
                           segments=runs, capacity_factor=0.9)
        ((y ** 2).sum() + aux).backward()
        from object_tracking_tpu_torch.parallel.collectives import (
            all_reduce_sum_, sum_gradients_)
        sum_gradients_(list(q.values()), data)
        out[name] = _np(y)
        out[name + '_rows'] = np.concatenate(
            [np.arange(i, i + size) for i in rows])
        out[name + '_aux'] = float(all_reduce_sum_(aux.detach(), data))
        out[name + '_grads'] = {k: _np(v.grad) for k, v in q.items()}
    return out


def _cell(c, x):
    c = torch.tanh(c * 0.9 + x)
    return c, 2.0 * c


def _tree_cell(carry, x):
    h = torch.tanh(carry['h'] + x)
    c = carry['c'] * 0.5 + h
    return {'h': h, 'c': c}, h + c


def scan_world(rank, n, inputs):
    """Context-parallel scans over a data axis of n ranks (exact ring, a
    pytree carry, halo, the time-sharded ConvLSTM), pipelines over a model
    axis of n ranks (stacked recurrence, GPipe, the pipelined ConvLSTM
    stack), the mesh's layout and shard_batch."""
    from object_tracking_tpu_torch.config import MeshConfig
    from object_tracking_tpu_torch.models.convlstm import (
        FusedConvLSTM, StackedConvLSTM)
    from object_tracking_tpu_torch.parallel import (
        context_parallel_scan, gpipe, make_mesh, pipeline_scan, shard_batch)
    from object_tracking_tpu_torch.parallel.collectives import (
        sum_gradients_)
    from object_tracking_tpu_torch.parallel.pipeline import (
        gather_stages, stage_sharded_parameters)
    from object_tracking_tpu_torch.training.state import (
        clip_model_gradients_)
    out = {}
    data = _mesh(n, 1)

    def block(a, per):
        return torch.from_numpy(a[rank * per:(rank + 1) * per])

    xs = block(inputs['exact'], 3).requires_grad_()
    ys = context_parallel_scan(_cell, torch.zeros(4), xs, data, 'data')
    (ys * block(inputs['exact_w'], 3)).sum().backward()
    out['exact'], out['exact_grad'] = _np(ys), _np(xs.grad)
    tree = {'h': torch.zeros(2), 'c': torch.zeros(2)}
    out['tree'] = _np(context_parallel_scan(
        _tree_cell, tree, block(inputs['tree'], 2), data, 'data'))
    out['halo'] = _np(context_parallel_scan(
        _cell, torch.zeros(4), block(inputs['halo'], 4), data, 'data',
        halo=2))
    ragged = block(inputs['exact'], 3)[:2 if rank else 3]
    out['err_ragged'] = _error(lambda: context_parallel_scan(
        _cell, torch.zeros(4), ragged, data, 'data'))

    # the time-sharded ConvLSTM against the dense layer (same weights)
    x = torch.from_numpy(inputs['lstm_x'])
    w = torch.from_numpy(inputs['lstm_w'])
    per = x.shape[1] // n
    mine = slice(rank * per, (rank + 1) * per)
    for name, shards, mesh in (('dense', 1, None), ('sp', n, data)):
        torch.manual_seed(0)
        layer = FusedConvLSTM(x.shape[2], 4, time_shards=shards, mesh=mesh)
        xin = (x if shards == 1 else x[:, mine]).clone().requires_grad_()
        h = layer(xin)
        target = w if shards == 1 else w[:, mine]
        (h * target).sum().backward()
        if shards > 1:
            sum_gradients_(list(layer.parameters()), data.data_group)
        out[f'lstm_{name}'] = _np(h)
        out[f'lstm_{name}_xgrad'] = _np(xin.grad)
        out[f'lstm_{name}_grads'] = {k: _np(p.grad)
                                     for k, p in layer.named_parameters()}
    out['lstm_slice'] = (rank * per, (rank + 1) * per)

    pipe = _mesh(1, n)
    p = {k: torch.from_numpy(v) for k, v in inputs['stack'].items()}

    def stage(params, carry, x):
        carry = torch.tanh(carry @ params['u'] + x @ params['w'])
        return carry, carry + x * 0.1
    out['stack'] = _np(pipeline_scan(
        stage, p, torch.from_numpy(inputs['stack_x']), pipe, 'model',
        carry_init=torch.zeros(n, 4)))
    g = {k: torch.from_numpy(v) for k, v in inputs['gpipe'].items()}
    out['gpipe'] = _np(gpipe(lambda q, x: torch.tanh(x @ q['w'] + q['b']),
                             g, torch.from_numpy(inputs['gpipe_x']), pipe,
                             'model'))
    out['err_shape'] = _error(lambda: gpipe(
        lambda q, x: x @ q['w'], {'w': torch.zeros(n, 4, 5)},
        torch.zeros(3, 4), pipe, 'model'))
    out['err_stages'] = _error(lambda: gpipe(
        lambda q, x: x @ q['w'], {'w': torch.zeros(n + 1, 4, 4)},
        torch.zeros(3, 4), pipe, 'model'))

    # the pipelined ConvLSTM stack against the dense stack (same seed)
    x = torch.from_numpy(inputs['stacked_x'])
    w = torch.from_numpy(inputs['stacked_w'])
    for name, kw in (('dense', {}), ('pp', dict(pipeline=True, mesh=pipe))):
        torch.manual_seed(1)
        layer = StackedConvLSTM(4, n, **kw)
        xin = x.clone().requires_grad_()
        h = layer(xin)
        (h * w).sum().backward()
        staged = stage_sharded_parameters(layer)
        out[f'stacked_{name}'] = _np(h)
        out[f'stacked_{name}_xgrad'] = _np(xin.grad)
        out[f'stacked_{name}_unclipped'] = {
            k: _np(v) for k, v in gather_stages(
                {k: p.grad.clone() for k, p in layer.named_parameters()},
                staged).items()}
        out[f'stacked_{name}_norm'] = float(clip_model_gradients_(layer,
                                                                  0.5))
        out[f'stacked_{name}_weights'] = {
            k: _np(v) for k, v in gather_stages(
                {k: p.detach() for k, p in layer.named_parameters()},
                staged).items()}
        out[f'stacked_{name}_grads'] = {
            k: _np(v) for k, v in gather_stages(
                {k: p.grad for k, p in layer.named_parameters()},
                staged).items()}
        out[f'stacked_{name}_held'] = [tuple(q.shape)
                                       for q in layer.parameters()]

    # the mesh's layout and this rank's slice of a global batch
    grid = make_mesh(MeshConfig(model_parallel=2 if n % 2 == 0 else 1))
    out['layout'] = (dict(grid.shape), grid.index('data'),
                     grid.index('model'))
    batch = {'x': np.arange(2 * n * 3).reshape(2 * n, 3), 'y': np.arange(n)}
    out['shard'] = shard_batch(data, batch)
    out['shard_t'] = shard_batch(data, {'x': np.zeros((2, 2 * n, 5))},
                                 axis=1)['x'].shape
    out['ragged'] = shard_batch(data, {'x': np.zeros((n + 1, 3))})['x'].shape
    from object_tracking_tpu_torch.parallel import whole_batch
    from object_tracking_tpu_torch.parallel.collectives import (
        average_gradients_)
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(rank))
    average_gradients_([p], data.data_group)
    out['average'] = _np(p.grad)
    with whole_batch():
        out['whole_groups'] = (grid.group('data') is None,
                               grid.group('model') is not None)
    out['groups'] = (grid.group('data') is not None,
                     grid.group('model') is not None)
    out['err_mesh'] = _error(lambda: make_mesh(
        MeshConfig(data_parallel=n, model_parallel=2)))
    return out


SMALL = dict(num_classes=2, num_anchors=2, convlstm_features=8, width_div=8)
ENC = dict(net_h=64, net_w=64, grid_h=2, grid_w=2, num_classes=2,
           true_box_buffer=5)
ANCHORS = np.array([1.0, 1.0, 2.5, 2.0], np.float32)


def joint_state(weights, mesh=None, lr=1e-3, **kw):
    """The small joint model with `weights` (a numpy state dict) and Adam;
    built from the seed first, as the flows build it."""
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    from object_tracking_tpu_torch.training import TrainState, make_optimizer
    model = MultiObjDetTracker(**SMALL, mesh=mesh, **kw)
    staged = {}
    if mesh is not None:
        from object_tracking_tpu_torch.parallel.pipeline import (
            local_stage, stage_sharded_parameters)
        staged = stage_sharded_parameters(model)
    model.load_state_dict(local_stage(
        {k: torch.from_numpy(v) for k, v in weights.items()}, staged)
        if staged else {k: torch.from_numpy(v) for k, v in weights.items()})
    return TrainState.create(model, make_optimizer(lr))


def two_steps(state, raw, mesh=None, axis=0, ckpt=None):
    """Two fused train steps (no augmentation) on this rank's slice of the
    raw global batch: the metrics of each, the gradients of the first and
    the dense parameters after both (stage slices gathered)."""
    from object_tracking_tpu_torch.parallel import shard_batch
    from object_tracking_tpu_torch.parallel.pipeline import (
        gather_stages, stage_sharded_parameters)
    from object_tracking_tpu_torch.training import (
        CheckpointManager, make_joint_train_step_fused)
    step = make_joint_train_step_fused(ANCHORS, augment=False, mesh=mesh,
                                       **ENC)
    mine = raw if mesh is None else shard_batch(mesh, raw, axis=axis)
    staged = stage_sharded_parameters(state.model)
    out = {'metrics': []}
    for i in range(2):
        state, metrics = step(state, mine)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out['grads'] = {k: _np(v) for k, v in gather_stages(
                {k: p.grad for k, p in state.model.named_parameters()},
                staged).items()}
    out['params'] = {k: _np(v) for k, v in gather_stages(
        {k: p.detach() for k, p in state.model.named_parameters()},
        staged).items()}
    if ckpt is not None:
        CheckpointManager(ckpt).save(state.step, state)
    return out


@contextlib.contextmanager
def recorded_routes(log: list):
    """Within the block, every MoE routing (`parallel.expert._route`)
    appends its tokens, gate, capacity, dispatch and whether it ran over a
    group to `log`."""
    from object_tracking_tpu_torch.parallel import expert
    route = expert._route

    def spy(tokens, gate_w, num_experts, capacity, group=None, segments=1):
        dispatch, combine, aux = route(tokens, gate_w, num_experts,
                                       capacity, group, segments)
        log.append({'tokens': _np(tokens), 'gate': _np(gate_w),
                    'capacity': capacity, 'dispatch': _np(dispatch),
                    'group': group is not None})
        return dispatch, combine, aux

    expert._route = spy
    try:
        yield
    finally:
        expert._route = route


def train_world(rank, n, inputs, ckpt):
    """The joint train step over 2 ranks: data parallel (dense and MoE
    heads, and the MoE head on a ragged batch, which shard_batch
    replicates, with its first routing and head output recorded), the two
    naive per-rank semantics, sequence parallel (dense and MoE), and the
    pipelined stack (with a checkpoint)."""
    from object_tracking_tpu_torch.config import JointConfig, LossConfig
    from object_tracking_tpu_torch.parallel import shard_batch
    from object_tracking_tpu_torch.training.steps import (
        _joint_loss, _prepare_raw_joint_batch, _encoder, _Anchors,
        to_device)
    out = {}
    dp = _mesh(n, 1)
    raw, raw_t = inputs['raw'], inputs['raw_t']
    out['dp'] = two_steps(joint_state(inputs['dense'], dp), raw, dp)
    out['moe'] = two_steps(joint_state(inputs['moe'], dp, moe_experts=2,
                                       moe_hidden=8), raw, dp)
    state = joint_state(inputs['moe'], dp, moe_experts=2, moe_hidden=8)
    routes, heads = [], []
    hook = state.model.tconv_moe.register_forward_hook(
        lambda module, args, result: heads.append(
            (_np(result[0]), float(result[1].detach()))))
    with recorded_routes(routes):
        out['moe_ragged'] = two_steps(state, inputs['raw_ragged'], dp)
    hook.remove()
    out['moe_ragged']['route'] = routes[0]
    out['moe_ragged']['head'] = heads[0]
    out['sp'] = two_steps(joint_state(inputs['dense'], dp, time_shards=n),
                          raw_t, dp, axis=1)
    out['sp_moe'] = two_steps(joint_state(inputs['moe'], dp, time_shards=n,
                                          moe_experts=2, moe_hidden=8),
                              raw_t, dp, axis=1)
    pp = _mesh(1, n)
    out['pp'] = two_steps(joint_state(inputs['deep'], pp,
                                      convlstm_layers=n + 1,
                                      pp_layers=True), raw, pp, ckpt=ckpt)

    # the naive semantics: per-rank BatchNorm statistics (a model without
    # the mesh) with the global loss; or global statistics with a loss
    # normalised on this rank's boxes alone, averaged over the ranks
    encode = _encoder(_Anchors(ANCHORS), 64, 64, 2, 2, 2, 5)
    mine = _prepare_raw_joint_batch(
        to_device(shard_batch(dp, raw), 'cpu'), None, encode, False)
    anchors = torch.from_numpy(ANCHORS)
    for name, mesh, group in (('bn_local', None, dp.data_group),
                              ('loss_mean', dp, None)):
        state = joint_state(inputs['dense'], mesh)
        state.model.train()
        _, metrics = _joint_loss(state.model, mine, anchors, LossConfig(),
                                 JointConfig(), 0, True, group=group)
        out[name] = float(metrics['loss'].detach())
    return out


def tiny_joint_config(size: int = 64):
    """The joint flow's small config (tests/test_trainer_e2e.py's)."""
    from object_tracking_tpu_torch.config import Config
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = size
    cfg.detector.grid_h = cfg.detector.grid_w = size // 32
    cfg.detector.width_div = 8
    cfg.joint.labels = ('1', '2')
    cfg.joint.convlstm_features = 8
    cfg.joint.batch_size = 2
    cfg.train.max_epochs = 1
    cfg.train.log_every_steps = 1
    return cfg


def tiny_flow_config():
    """The single-object and detector flows' small config
    (tests/test_torch_single_object_flow.py's, at B=4 for both)."""
    from object_tracking_tpu_torch.config import Config
    cfg = Config()
    cfg.detector.image_h = cfg.detector.image_w = 64
    cfg.detector.grid_h = cfg.detector.grid_w = 2
    cfg.detector.batch_size = 4
    cfg.detector.width_div = 8
    cfg.tracker.sequence_length = 3
    cfg.tracker.lstm_units = 16
    cfg.tracker.heatmap_size = 8
    cfg.train.batch_size = 4
    cfg.train.max_epochs = 1
    cfg.train.augment = False
    return cfg


# frames of the one synthetic video of each flow: 8 windows of 3 (two
# batches of 4) for the single-object flow; a batch of 4 and a ragged
# one of 3 for the detector flow (a last batch of one 64² image leaves
# BatchNorm 4 values a channel at the 2x2 grid, which turns the float32
# rounding of the first step's sums into a 0.14 % turn of the update)
FLOW_FRAMES = {'single': 10, 'detect': 7}
_STEP_FACTORIES = {'single': ('make_tiny_train_step',),
                   'detect': ('make_detector_train_step',
                              'make_multihead_detector_train_step')}


def spied_flow(flow: str, cfg, workdir: str) -> dict:
    """The single-object ('single') or detector ('detect') training flow,
    one epoch over one synthetic video of FLOW_FRAMES[flow] frames, with a
    spy on its train step. Returns what the spy saw (the parameters before
    the first step, each step's batch size and whether its batch was
    replicated), the final step and parameters."""
    from object_tracking_tpu_torch import trainer, training
    from object_tracking_tpu_torch.parallel import is_replicated
    seen = {'local_batch': [], 'replicated': []}

    def spy(factory):
        def make(*args, **kw):
            step = factory(*args, **kw)

            def run(state, batch):
                seen.setdefault('initial', {
                    k: _np(p) for k, p in state.model.named_parameters()})
                lead = batch['images'] if 'images' in batch else \
                    batch['feats']
                seen['local_batch'].append(int(lead.shape[0]))
                seen['replicated'].append(is_replicated(batch))
                return step(state, batch)
            return run
        return make

    saved = {name: getattr(training, name) for name in _STEP_FACTORIES[flow]}
    synthetic_dirs = trainer._synthetic_dirs
    trainer._synthetic_dirs = lambda cfg, size, labels, **kw: \
        synthetic_dirs(cfg, size, labels, frames=FLOW_FRAMES[flow],
                       videos=1, workdir=kw.get('workdir'))
    for name, factory in saved.items():
        setattr(training, name, spy(factory))
    try:
        if flow == 'single':
            state = trainer.single_object_tracking(
                cfg, synthetic=True, epochs=1, workdir=workdir,
                device='cpu')
        else:
            state = trainer.keras_yolo_obj_detection(
                cfg, synthetic=True, epochs=1, workdir=workdir, train=True,
                device='cpu')
    finally:
        trainer._synthetic_dirs = synthetic_dirs
        for name, factory in saved.items():
            setattr(training, name, factory)
    seen['step'] = state.step
    seen['params'] = {k: _np(p) for k, p in state.model.named_parameters()}
    return seen


def flow_world(rank, n, store, flows):
    """Each flow of `flows` ({name: (kind, workdir, options)}) in turn on
    every rank of an n-rank world that the flows join themselves
    (`mesh.distributed`, a file:// rendezvous; the first joins, the later
    ones find the process group up), the data axis taking every rank:
    kind 'joint' is the joint flow with `options` set on its JointConfig,
    'single' and 'detect' the single-object and detector training flows
    (`spied_flow`)."""
    import torch.distributed as dist
    from object_tracking_tpu_torch import trainer
    out = {}
    for name, (kind, workdir, options) in flows.items():
        cfg = tiny_joint_config() if kind == 'joint' else tiny_flow_config()
        for k, v in options.items():
            setattr(cfg.joint, k, v)
        cfg.mesh.distributed = True
        cfg.mesh.coordinator_address = f'file://{store}'
        cfg.mesh.num_processes = n
        cfg.mesh.process_id = rank
        cfg.mesh.data_parallel = n
        if kind != 'joint':
            out[name] = spied_flow(kind, cfg, workdir)
            continue
        state = trainer.simult_multi_obj_detection_tracking(
            cfg, synthetic=True, workdir=workdir, device='cpu')
        out[name] = {'world': dist.get_world_size(), 'step': state.step,
                     'held': {k: tuple(p.shape)
                              for k, p in state.model.named_parameters()},
                     'params': {k: _np(p) for k, p in
                                state.model.named_parameters()}}
    return out


# ------------------------------------------------------ tensor parallelism

def op_world(rank, n, inputs):
    """The column-parallel operators over a model axis of n ranks against
    dense autograd: gather_blocks on dims 0 and 1, a column-parallel conv
    (with and without replicated_input at its input), and a conv layer
    whose weight is sharded beside a replicated bias."""
    import torch.nn.functional as F
    from torch import nn
    from object_tracking_tpu_torch.models.darknet19 import conv
    from object_tracking_tpu_torch.parallel.collectives import gather_blocks
    from object_tracking_tpu_torch.parallel.sharding import (
        Shard, column_conv)
    group = _mesh(1, n).group('model')
    out = {}
    for dim in (0, 1):
        whole = torch.from_numpy(inputs['blocks'])
        per = whole.shape[dim] // n
        mine = whole.narrow(dim, rank * per, per).clone().requires_grad_()
        y = gather_blocks(mine, group, dim)
        (y * torch.from_numpy(inputs['blocks_w'])).sum().backward()
        out[f'gather_{dim}'] = _np(y)
        out[f'gather_{dim}_grad'] = _np(mine.grad)

    w = torch.from_numpy(inputs['w'])
    b = torch.from_numpy(inputs['b'])
    per = w.shape[0] // n
    mine = slice(rank * per, (rank + 1) * per)
    for name, route in (('column', column_conv),
                        ('no_replicated_input', lambda x, wr, br, p, g:
                         gather_blocks(F.conv2d(x, wr, br, padding=p), g,
                                       1))):
        x = torch.from_numpy(inputs['x']).requires_grad_()
        wr = w[mine].clone().requires_grad_()
        br = b[mine].clone().requires_grad_()
        y = route(x, wr, br, 1, group)
        (y * torch.from_numpy(inputs['y_w'])).sum().backward()
        out[name] = _np(y)
        out[name + '_grads'] = {'x': _np(x.grad), 'w': _np(wr.grad),
                                'b': _np(br.grad)}

    layer = nn.Conv2d(w.shape[1], w.shape[0], 3)
    layer.weight = nn.Parameter(w[mine].clone())
    layer.bias = nn.Parameter(b.clone())
    layer.tp_shards = {'weight': Shard(group, rank, n, 0)}
    x = torch.from_numpy(inputs['x']).requires_grad_()
    (conv(x, layer) * torch.from_numpy(inputs['y_w'])).sum().backward()
    out['replicated_bias'] = {'x': _np(x.grad), 'w': _np(layer.weight.grad),
                              'b': _np(layer.bias.grad)}
    return out


TP_MODEL = dict(num_classes=3, num_anchors=5, convlstm_features=16,
                width_div=8)
TP_ENC = dict(net_h=64, net_w=64, grid_h=2, grid_w=2, num_classes=3,
              true_box_buffer=5)
TP_HEADS = {'dense': {}, 'moe': dict(moe_experts=2, moe_hidden=8)}
TP_MIN_PARAMS = 1 << 8


def _host(tensors) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tp_steps(weights, head: str, raw, mesh=None, shard: bool = True,
             dtype=torch.float32):
    """Two fused train steps (no augmentation, lr 1e-3) of the small joint
    model with `weights`, on this rank's slice of the raw global batch;
    with `shard`, the model is tensor-parallel over the mesh's model axis
    (min_params 1 << 8); `dtype` is the parameters' and activations' type.
    Returns the metrics of both steps, the global gradient norm and the
    dense gradients of the first, the dense state after each, the
    parameter shapes and bytes this rank holds, and the dense model's
    bytes."""
    from object_tracking_tpu_torch.config import YOLOV2_ANCHORS
    from object_tracking_tpu_torch.models import MultiObjDetTracker
    from object_tracking_tpu_torch.parallel import (
        gather_dense, shard_batch, shard_variables)
    from object_tracking_tpu_torch.training import (
        TrainState, make_joint_train_step_fused, make_optimizer)
    from object_tracking_tpu_torch.training.state import (
        clip_model_gradients_)
    model = MultiObjDetTracker(**TP_MODEL, **TP_HEADS[head], mesh=mesh,
                               dtype=dtype).to(dtype)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    out = {'dense_bytes': _param_bytes(model), 'metrics': []}
    if mesh is not None and shard:
        shard_variables(mesh, model, min_params=TP_MIN_PARAMS)
    out['bytes'] = _param_bytes(model)
    out['held'] = {k: tuple(p.shape) for k, p in model.named_parameters()}
    state = TrainState.create(model, make_optimizer(1e-3))
    step = make_joint_train_step_fused(YOLOV2_ANCHORS, augment=False,
                                       mesh=mesh, **TP_ENC)
    mine = raw if mesh is None else shard_batch(mesh, raw)
    for i in range(2):
        state, metrics = step(state, mine)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out['norm'] = float(clip_model_gradients_(model, float('inf')))
            out['grads'] = _host(gather_dense(model, {
                k: p.grad for k, p in model.named_parameters()}))
            out['step1'] = _host(gather_dense(model))
    out['step2'] = _host(gather_dense(model))
    return out


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tp_errors(got: dict, ref: dict) -> dict:
    """The largest gaps between two `tp_steps` runs: the first step's
    metrics (relative), gradients, parameters and BatchNorm statistics
    after it (relative L2 per leaf), and the gradient norms."""
    m1, r1 = got['metrics'][0], ref['metrics'][0]
    return {
        'metrics': max(abs(m1[k] - r1[k]) / max(abs(r1[k]), 1e-30)
                       for k in r1),
        'grads': max(_rel_l2(got['grads'][k], v)
                     for k, v in ref['grads'].items()),
        'step1': max(_rel_l2(got['step1'][k], v)
                     for k, v in ref['step1'].items()),
        'norm': abs(got['norm'] - ref['norm']) / ref['norm']}


def tp_world(rank, n, inputs, layouts):
    """The joint fused step under dp x tp for each (dp, tp) of `layouts`
    (dp·tp = n) and each head of TP_HEADS: in float64 the tensor-parallel
    run against the dense run on the same mesh (the errors, on every
    rank), the plan's summary, and on rank 0 the float32 tensor-parallel
    run whole and the float64 one's first step."""
    from object_tracking_tpu_torch.parallel import tp_sharding_summary
    out = {}
    for dp, tp in layouts:
        mesh = _mesh(dp, tp)
        for head in TP_HEADS:
            w, raw = inputs[head], inputs['raw']
            got = tp_steps(w, head, raw, mesh)
            res = {k: got[k] for k in ('held', 'bytes', 'dense_bytes')}
            got64 = tp_steps(w, head, raw, mesh, dtype=torch.float64)
            res['errors'] = tp_errors(got64, tp_steps(
                w, head, raw, mesh, shard=False, dtype=torch.float64))
            res['summary'] = tp_sharding_summary(
                {k: torch.from_numpy(v) for k, v in inputs[head].items()},
                mesh, min_params=TP_MIN_PARAMS)
            if rank == 0:
                res['run'] = {k: got[k] for k in
                              ('metrics', 'grads', 'step1', 'step2',
                               'norm')}
                res['run64'] = {k: got64[k] for k in ('metrics', 'grads')}
            out[f'{dp}x{tp}_{head}'] = res
    return out


# ----------------------------------- data-parallel detector and tiny steps

def _dp_model(case, mesh):
    from object_tracking_tpu_torch.models import Darknet19, TinyTracker
    from object_tracking_tpu_torch.models.darknet_cfg import build_from_cfg
    if case['kind'] == 'detector':
        model = Darknet19(num_classes=2, num_anchors=2, width_div=8,
                          mesh=mesh)
    elif case['kind'] == 'multihead':
        model = build_from_cfg(case['cfg'], mesh=mesh)[0]
    else:
        model = TinyTracker(case['feat'], lstm_units=16, out_dim=case['out'])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case['weights'].items()})
    return model


def _dp_step_fns(case, mesh):
    """(train step, eval step or None) of `case` over `mesh`."""
    from object_tracking_tpu_torch.training import (
        make_detector_train_step, make_multihead_detector_train_step,
        make_tiny_eval_step, make_tiny_train_step)
    if case['kind'] == 'detector':
        return make_detector_train_step(case['anchors'], mesh=mesh), None
    if case['kind'] == 'multihead':
        return make_multihead_detector_train_step(
            case['heads'], case['net'], mesh=mesh), None
    return (make_tiny_train_step(case['heatmap'], case['loss'], mesh=mesh),
            make_tiny_eval_step(case['heatmap'], case['loss'], mesh=mesh))


def dp_two_steps(case, mesh=None):
    """Two train steps of `case` (a model kind, its numpy weights, two
    global batches, the step's options) on this rank's slice of each
    batch: each step's metrics, the batch size it saw and whether the
    batch was replicated, the eval step's metrics before training (tiny
    steps), the first step's gradients and running statistics, and the
    parameters after both."""
    from object_tracking_tpu_torch.parallel import is_replicated, shard_batch
    from object_tracking_tpu_torch.training import TrainState, make_optimizer
    model = _dp_model(case, mesh)
    state = TrainState.create(model, make_optimizer(case['lr']))
    train, evaluate = _dp_step_fns(case, mesh)
    out = {'metrics': [], 'local_batch': [], 'replicated': []}
    for i, batch in enumerate(case['batches']):
        mine = batch if mesh is None else shard_batch(mesh, batch)
        lead = mine['images'] if 'images' in mine else mine['feats']
        out['local_batch'].append(int(lead.shape[0]))
        out['replicated'].append(is_replicated(mine))
        if evaluate is not None and i == 0:
            out['eval'] = {k: float(v) for k, v in
                           evaluate(state, mine).items()}
        state, metrics = train(state, mine)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out['grads'] = {k: _np(p.grad)
                            for k, p in model.named_parameters()
                            if p.grad is not None}
            out['stats'] = {k: _np(b) for k, b in model.named_buffers()}
    out['params'] = {k: _np(p) for k, p in model.named_parameters()}
    return out


def dp_world(rank, n, cases):
    """Every case of `cases` over a data axis of n ranks (dp_two_steps)."""
    mesh = _mesh(n, 1)
    return {name: dp_two_steps(case, mesh) for name, case in cases.items()}


def bn_group_world(rank, n, x, dy, weight, bias, device, dtype='float32'):
    """One training call of the batch-statistics BatchNorm entry
    (`ops/cuda/batch_norm.py::batch_norm`) on this rank's share of the
    channels_last batch x (rank r of n takes the r-th of n equal parts),
    the world its data group when n > 1, on 'cpu' (the ops' twins) or on
    'cuda' (cuda:0 for every rank): y, stats, dx, dweight, dbias."""
    from object_tracking_tpu_torch.ops.cuda import batch_norm as cbn
    dev = torch.device('cuda', 0) if device == 'cuda' else torch.device('cpu')
    per = x.shape[0] // n
    part = slice(rank * per, (rank + 1) * per)

    def put(a, dt=getattr(torch, dtype)):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    xs = put(x[part]).contiguous(memory_format=torch.channels_last)
    dys = put(dy[part]).contiguous(memory_format=torch.channels_last)
    w, b = (put(a, torch.float32).requires_grad_() for a in (weight, bias))
    xs.requires_grad_()
    group = dist.group.WORLD if n > 1 else None
    y, stats = cbn.batch_norm(xs, w, b, 1e-3, group)
    dx, dw, db = torch.autograd.grad(y, (xs, w, b), dys)
    out = {'y': y, 'stats': stats, 'dx': dx, 'dweight': dw, 'dbias': db}
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}
