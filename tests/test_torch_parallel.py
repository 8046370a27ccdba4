"""The port's process grid, its verification utilities and the
data-parallel train step (lvae_tpu_torch/parallel/, training/optim.py with
a mesh) at two gloo ranks on the CPU, launched as torchrun launches them
(tests/torch_ranks.py), in the pattern of tests/test_multiprocess.py:

  * mesh.py and dist_utils.py: a global sum of sharded rows, shard_batch's
    rows, replicate, check_model_equivalence (true; false after one rank
    perturbs one element, on both ranks; true again within an atol that
    covers it, and after sync_params_from_host0), broadcast_object,
    barrier;
  * the two-rank step on qres_tiny (64x64, global batch 8, 2 steps, Adam +
    EMA, grad_clip 2.0): the ranks' parameters, EMA, moments, counts and
    grad norm bitwise equal; within atol 5e-6 of the port's one-process
    step on the global batch, the loss within 1e-5 relative;
  * the JAX anchor: the same global batch and weights through the JAX
    make_train_step on the conftest's 8-device mesh (test_multiprocess.py's
    setup), its noise replayed to the ranks by their rows; the JAX test's
    tolerances, loss 1e-4 and atol 5e-6 on every parameter and EMA leaf;
  * at world size 1 the step with a mesh is bitwise the step without.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.models import base as jbase
from lvae_tpu.parallel import mesh as jmesh
from lvae_tpu.training.optim import create_train_state, \
    make_train_step as jax_make_train_step

import lvae_tpu_torch
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.parallel import mesh as pmesh
from lvae_tpu_torch.training.optim import TrainState, make_train_step

import torch_ranks

GLOBAL_BATCH, STEPS = 8, 2
LR, MEDIAN, EMA_DECAY = 1e-3, 1e9, 0.9
PORT_ATOL, PORT_LOSS_RTOL = 5e-6, 1e-5
JAX_ATOL, JAX_LOSS_ATOL = 5e-6, 1e-4

_RANK = r'''
import hashlib, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import lvae_tpu_torch
from lvae_tpu_torch.models import entropy_coding as tec
from lvae_tpu_torch.parallel import dist_utils, mesh as pmesh
from lvae_tpu_torch.training.optim import TrainState, make_train_step

work = sys.argv[1]
pmesh.init_distributed(backend='gloo', device='cpu')
rank = pmesh.process_index()
mesh = pmesh.get_data_mesh()
out = {}

# the grid and the utilities
g = np.arange(64, dtype=np.float32).reshape(16, 4)
rows = pmesh.shard_batch(g, mesh)
out['rows'] = rows[:, 0].tolist()
total = rows.sum().reshape(1)
torch.distributed.all_reduce(total)
out['global_sum'] = float(total)
out['local_batch'] = pmesh.local_batch_slice(16)
params = {'w': torch.full((3, 3), 1.5 + rank), 'b': torch.zeros(3)}
pmesh.replicate(params, mesh)
out['replicated'] = params['w'].tolist()
out['equal'] = dist_utils.check_model_equivalence(params, mesh)
if rank == 1:
    params['w'][1, 2] += 1e-3
out['perturbed'] = dist_utils.check_model_equivalence(params, mesh)
out['within_atol'] = dist_utils.check_model_equivalence(params, mesh,
                                                        atol=1e-2)
dist_utils.sync_params_from_host0(params)
out['synced'] = dist_utils.check_model_equivalence(params)
out['object'] = dist_utils.broadcast_object({'from': rank}, root=1)
dist_utils.barrier('utils')

# the data-parallel step
model = lvae_tpu_torch.get_model('qres_tiny', device='cpu')
weights = torch.load(f'{work}/weights.pt', weights_only=True)
batch_np = np.load(f'{work}/batch.npy')
jax_noise = np.load(f'{work}/noise.npz')


def run(noise):
    model.net.load_state_dict(weights)
    state = TrainState(model.net, optimizer='adam', ema=True)
    pmesh.replicate(state, mesh)
    step = make_train_step(
        lambda b, g: model.loss_and_stats(b, training=True, generator=g),
        state, grad_clip=2.0, use_ema=True, mesh=mesh)
    batch = pmesh.shard_batch(batch_np, mesh).permute(0, 3, 1, 2)
    real = tec.uniform_noise
    for i in range(2):
        if noise == 'jax':
            drawn = [jax_noise[f's{i}_{j}'] for j in range(len(jax_noise)
                                                           // 2)]

            def replay(like, generator=None):
                b, n = generator.batch
                t = torch.from_numpy(drawn.pop(0)).permute(0, 3, 1, 2)
                t = t[b * like.shape[0]:(b + 1) * like.shape[0]]
                assert t.shape == like.shape
                return t.contiguous()
            tec.uniform_noise = replay
        try:
            metrics = step(batch.contiguous(), torch.Generator().manual_seed(
                42 + i), 1e-3, 1e9, 0.9)
        finally:
            tec.uniform_noise = real
    h = hashlib.sha256(repr((state.step, state.count,
                             float(metrics['grad_norm']))).encode())
    for buf in state.flat_buffers().values():
        h.update(buf.numpy().tobytes())
    if rank == 0:
        np.savez(f'{work}/{noise}.npz',
                 **{f'params/{k}': v.numpy()
                    for k, v in state.named(state.flat).items()},
                 **{f'ema/{k}': v.numpy()
                    for k, v in state.named(state.ema).items()})
    return dict(digest=h.hexdigest(),
                metrics={k: float(v) for k, v in metrics.items()},
                equivalent=dist_utils.check_model_equivalence(state, mesh))


out['port'] = run('port')
out['jax'] = run('jax')
print('RESULT ' + json.dumps(out), flush=True)
'''


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit_init(self, net, seed=0, example_hw=64):
    """The JAX handle's init, jitted (one compile, not an op-by-op
    trace)."""
    self.net = net
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    self.params = jax.jit(net.init)({'params': jax.random.PRNGKey(seed)},
                                    dummy)['params']


@pytest.fixture(scope='module')
def batch_np():
    return np.random.default_rng(3).uniform(
        0, 1, (GLOBAL_BATCH, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def jax_run(batch_np):
    """The JAX step on the 8-device data mesh (test_multiprocess.py:115-145)
    -> (initial params, final params, final EMA, last loss, the noise each
    step drew, in order, global NHWC)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase.VAEModelBase, '__init__', _jit_init)
        model = lvae_tpu.get_model('qres_tiny')
    params0 = jax.device_get(model.params)
    log = []
    real = jax.random.uniform

    def record(*a, **kw):
        out = real(*a, **kw)
        log.append(out)
        return out

    def loss_fn(params, batch, rng):
        del log[:]
        loss, stats = model.loss_and_stats(params, batch, rng, training=True)
        return loss, dict(stats, **{f'noise{j}': d for j, d in
                                    enumerate(log)})

    m = jmesh.get_data_mesh()
    state, tx = create_train_state(model.params, optimizer='adam', ema=True)
    state = jmesh.replicate(state, m)
    step_fn = jax_make_train_step(loss_fn, tx, accum_num=1, grad_clip=2.0,
                                  use_ema=True)
    repl, data = jmesh.replicated_sharding(m), jmesh.data_sharding(m)
    step = jax.jit(step_fn, in_shardings=(repl, data, repl, repl, repl, repl),
                   out_shardings=(repl, repl), donate_argnums=(0,))
    batch = jax.device_put(batch_np, data)
    noise = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'uniform', record)
        for i in range(STEPS):
            state, metrics = step(state, batch, jax.random.PRNGKey(42 + i),
                                  jnp.float32(LR), jnp.float32(MEDIAN),
                                  jnp.float32(EMA_DECAY))
            metrics = jax.device_get(metrics)
            noise.update({f's{i}_{k[5:]}': np.asarray(v)
                          for k, v in metrics.items()
                          if k.startswith('noise')})
    return (params0, jax.device_get(state.params),
            jax.device_get(state.ema_params), float(metrics['loss']), noise)


def port_step(weights, batch_np, mesh=None, steps=STEPS):
    """The port's step on `batch_np` (NHWC numpy) from `weights`, with
    generators seeded 42 + i -> (state, last metrics as floats)."""
    model = lvae_tpu_torch.get_model('qres_tiny', device='cpu')
    model.net.load_state_dict(weights)
    state = TrainState(model.net, optimizer='adam', ema=True)
    step = make_train_step(
        lambda b, g: model.loss_and_stats(b, training=True, generator=g),
        state, grad_clip=2.0, use_ema=True, mesh=mesh)
    batch = torch.from_numpy(batch_np).permute(0, 3, 1, 2).contiguous()
    for i in range(steps):
        metrics = step(batch, torch.Generator().manual_seed(42 + i), LR,
                       MEDIAN, EMA_DECAY)
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope='module')
def two_ranks(jax_run, batch_np, tmp_path_factory):
    params0, _, _, _, noise = jax_run
    work = tmp_path_factory.mktemp('dp')
    weights = params_from_flax(params0)
    torch.save(weights, work / 'weights.pt')
    np.save(work / 'batch.npy', batch_np)
    np.savez(work / 'noise.npz', **noise)
    script = work / 'rank.py'
    script.write_text(_RANK)
    outs = torch_ranks.launch(script, 2, args=(work,), timeout=200)
    results = [json.loads(next(l for l in out.splitlines()
                               if l.startswith('RESULT '))[7:])
               for out in outs]
    dumps = {k: dict(np.load(work / f'{k}.npz')) for k in ('port', 'jax')}
    return weights, results, dumps


@pytest.mark.timeout(300)
def test_mesh_and_dist_utils_at_two_ranks(two_ranks):
    _, (r0, r1), _ = two_ranks
    assert r0['rows'] == [0.0, 4.0, 8.0, 12.0, 16.0, 20.0, 24.0, 28.0]
    assert r1['rows'] == [32.0, 36.0, 40.0, 44.0, 48.0, 52.0, 56.0, 60.0]
    for r in (r0, r1):
        assert r['global_sum'] == float(np.arange(64).sum())
        assert r['local_batch'] == 8
        assert r['replicated'] == [[1.5] * 3] * 3          # rank 0's
        assert r['equal'] and not r['perturbed'] and r['within_atol']
        assert r['synced']
        assert r['object'] == {'from': 1}


@pytest.mark.timeout(300)
def test_dp_step_ranks_bitwise(two_ranks):
    _, (r0, r1), _ = two_ranks
    for run in ('port', 'jax'):
        assert r0[run]['digest'] == r1[run]['digest'], run
        assert r0[run]['metrics'] == r1[run]['metrics'], run
        assert r0[run]['equivalent'] and r1[run]['equivalent']


@pytest.mark.timeout(300)
def test_dp_step_matches_one_process(two_ranks, batch_np):
    weights, (r0, _), dumps = two_ranks
    state, metrics = port_step(weights, batch_np)
    got = r0['port']['metrics']
    assert got['loss'] == pytest.approx(metrics['loss'], rel=PORT_LOSS_RTOL)
    assert got['grad_norm'] == pytest.approx(metrics['grad_norm'], rel=1e-5)
    for kind, flat in (('params', state.flat), ('ema', state.ema)):
        for name, want in state.named(flat).items():
            np.testing.assert_allclose(dumps['port'][f'{kind}/{name}'],
                                       want.numpy(), rtol=0, atol=PORT_ATOL,
                                       err_msg=f'{kind} {name}')


@pytest.mark.timeout(300)
def test_dp_step_matches_jax_eight_devices(two_ranks, jax_run):
    _, (r0, _), dumps = two_ranks
    _, params, ema, loss, _ = jax_run
    assert abs(r0['jax']['metrics']['loss'] - loss) < JAX_LOSS_ATOL
    for kind, tree in (('params', params), ('ema', ema)):
        for name, want in params_from_flax(tree).items():
            np.testing.assert_allclose(dumps['jax'][f'{kind}/{name}'],
                                       want.numpy(), rtol=0, atol=JAX_ATOL,
                                       err_msg=f'{kind} {name}')


@pytest.mark.timeout(120)
def test_world_size_one_mesh_step_is_bitwise(jax_run, batch_np):
    weights = params_from_flax(jax_run[0])
    plain, m_plain = port_step(weights, batch_np[:2])
    pmesh.init_distributed(backend='gloo', device='cpu')
    try:
        assert dist.get_world_size() == 1
        meshed, m_mesh = port_step(weights, batch_np[:2],
                                   mesh=pmesh.get_data_mesh())
    finally:
        dist.destroy_process_group()
    assert m_plain == m_mesh
    for name, a in plain.flat_buffers().items():
        assert torch.equal(a, meshed.flat_buffers()[name]), name
