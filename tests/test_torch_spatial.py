"""H-sharded evaluation and the DP x SP train step of the port
(lvae_tpu_torch/parallel/spatial.py) at four gloo ranks on the CPU,
launched as torchrun launches them (tests/torch_ranks.py), in the pattern
of tests/test_spatial.py:

  * spatial_eval at (1, 2) and (1, 4) on qarv_tiny, qres_tiny and rd_tiny
    at 256x128 (at (1, 4) the deepest grid is one row a rank, under 7x7
    and 3x3 convolutions: halos from two ranks away) against the port's
    unsharded forward, loss, bppix and psnr within rtol 1e-5; qarv_tiny at
    (1, 2) against the JAX spatial_eval on the same weights within rtol
    1e-4;
  * the halo exchange's gradient: a stack of every convolution the rule
    takes (7x7, 3x3, a 4x4 stride-2 conv with padding 1, transposed 5x5
    stride 2 as qres17m's deconv, 2x2 stride 2) sharded at (1, 2) and
    (1, 4), against unsharded autograd within atol 1e-6, in float64 (in
    float32 the parameters' gradients, sums of ~2,000 terms near 4, come
    out up to 5 ulp, 1.2e-6, apart by their summation order alone);
  * the 2x2 (data, space) step on qarv_tiny (batch 4, 128x64, Adam + EMA):
    the ranks bitwise equal, and within atol 5e-6 (loss 1e-5 relative) of
    the one-process step on the global batch;
  * a convolution the halo rule cannot take raises, in process at 1x1.

The ranks import this file for its helpers, so JAX is imported inside the
fixtures that need it.
"""
import json

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import lvae_tpu_torch
from lvae_tpu_torch import parallel
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.training.optim import TrainState, make_train_step

import torch_ranks

NAMES = ('qarv_tiny', 'qres_tiny', 'rd_tiny')
LMB = 512.0
STAT_RTOL, JAX_RTOL = 1e-5, 1e-4
GRAD_ATOL = 1e-6
STEP_ATOL, STEP_LOSS_RTOL = 5e-6, 1e-5

_RANK = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import lvae_tpu_torch
from lvae_tpu_torch import parallel
from lvae_tpu_torch.parallel import dist_utils
from lvae_tpu_torch.training.optim import TrainState, make_train_step
sys.path.insert(0, sys.argv[2])
import test_torch_spatial as spec

work = sys.argv[1]
parallel.init_distributed(backend='gloo', device='cpu')
rank = parallel.process_index()
image = np.load(f'{work}/image.npy')
out = {'eval': {}}
for name in spec.NAMES:
    model = lvae_tpu_torch.get_model(name, device='cpu')
    model.net.load_state_dict(torch.load(f'{work}/{name}.pt',
                                         weights_only=True))
    for n_space in (2, 4):
        mesh = parallel.get_2d_mesh(1, n_space)
        stats = parallel.spatial_eval(
            model, image, mesh, lmb=None if name == 'qres_tiny' else spec.LMB)
        assert (stats is None) == (rank >= n_space)
        out['eval'][f'{name}/{n_space}'] = stats

stack_x, stack_w = spec.stack_inputs()
for n_space in (2, 4):
    mesh = parallel.get_2d_mesh(1, n_space)
    grads = spec.sharded_stack_grads(mesh, stack_x, stack_w)
    np.savez(f'{work}/grads{n_space}_{rank}.npz', **grads)

model = lvae_tpu_torch.get_model('qarv_tiny', device='cpu')
model.net.load_state_dict(torch.load(f'{work}/qarv_tiny.pt',
                                     weights_only=True))
mesh = parallel.get_2d_mesh(2, 2)
state, metrics = spec.dpsp_step(model, np.load(f'{work}/batch.npy'), mesh)
out['step'] = dict(digest=spec.digest(state, metrics),
                   metrics={k: float(v) for k, v in metrics.items()},
                   equivalent=dist_utils.check_model_equivalence(state, mesh))
if rank == 0:
    np.savez(f'{work}/dpsp.npz', **{
        f'{kind}/{k}': v.numpy() for kind, flat in (('params', state.flat),
                                                    ('ema', state.ema))
        for k, v in state.named(flat).items()})
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


class Stack(nn.Module):
    """Every kind of convolution the halo rule takes."""

    def __init__(self):
        super().__init__()
        self.c7 = nn.Conv2d(3, 8, 7, padding=3)
        self.down = nn.Conv2d(8, 8, 4, stride=2, padding=1)
        self.dw = nn.Conv2d(8, 8, 7, padding=3, groups=8)
        self.c3 = nn.Conv2d(8, 8, 3, padding=1)
        self.deconv = nn.ConvTranspose2d(8, 8, 5, stride=2, padding=2,
                                          output_padding=1)
        self.patch = nn.Conv2d(8, 8, 2, stride=2)
        self.up = nn.ConvTranspose2d(8, 4, 2, stride=2)

    def forward(self, x):
        x = F.gelu(self.c7(x))
        x = self.dw(self.down(x))
        x = self.deconv(F.gelu(self.c3(x)))
        return self.up(self.patch(x))


def stack_inputs():
    """(x, w): the stack's (2, 3, 16, 8) input and the loss weights of its
    output, float64; the loss is sum(stack(x) * w)."""
    g = torch.Generator().manual_seed(5)
    return (torch.randn(2, 3, 16, 8, generator=g, dtype=torch.float64),
            torch.randn(2, 4, 16, 8, generator=g, dtype=torch.float64))


def _stack():
    torch.manual_seed(3)
    return Stack().double()


def sharded_stack_grads(mesh, x, w):
    """The gradients of sum(stack(x) * w) with x and w split over H, on
    this rank (every rank of the world calls it): the input's slab and the
    parameters' (summed over the ranks)."""
    net = _stack()
    if not mesh.includes_me:
        return {}
    sh = parallel.Sharding(mesh, (None, None, 'space'))
    xs = sh.local(x).clone().requires_grad_()
    with parallel.sharded(mesh):
        y = net(xs)
    loss = (y * sh.local(w)).sum()
    params = list(net.parameters())
    grads = torch.autograd.grad(loss, [xs] + params)
    out = {'x': grads[0].numpy()}
    for (name, _), g in zip(net.named_parameters(), grads[1:]):
        torch.distributed.all_reduce(g, group=mesh.group)
        out[name] = g.numpy()
    return out


def dpsp_step(model, batch_np, mesh):
    """One step of `model` on the (B, H, W, 3) batch (this rank's block of
    it under `mesh`) from a generator seeded 7 -> (state, metrics)."""
    state = TrainState(model.net, optimizer='adam', ema=True)
    step = make_train_step(
        lambda b, g: model.loss_and_stats(b, training=True, generator=g),
        state, grad_clip=2.0, wdecay=0.0, use_ema=True, mesh=mesh)
    if mesh is not None:
        batch_np = parallel.image_sharding(mesh).local(batch_np)
    batch = torch.from_numpy(np.ascontiguousarray(batch_np)).permute(
        0, 3, 1, 2).contiguous()
    metrics = step(batch, torch.Generator().manual_seed(7), 1e-4, 1e9, 0.999)
    return state, metrics


def digest(state, metrics):
    import hashlib
    h = hashlib.sha256(repr((state.step, state.count, float(
        metrics['grad_norm']))).encode())
    for buf in state.flat_buffers().values():
        h.update(buf.numpy().tobytes())
    return h.hexdigest()


def _jit_init(self, net, seed=0, example_hw=64, log_images=()):
    import jax
    import jax.numpy as jnp
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    self.net = net
    self.lmb_range = tuple(float(v) for v in net.lmb_range)
    self.default_lmb = self.lmb_range[1]
    lmb = jnp.full((1,), self.lmb_range[1], jnp.float32)
    self.params = jax.jit(net.init)({'params': jax.random.PRNGKey(seed),
                                     'noise': jax.random.PRNGKey(1)},
                                    dummy, lmb)['params']


@pytest.fixture(scope='module')
def image256():
    """tests/test_spatial.py's image."""
    rng = np.random.default_rng(11)
    from scipy.ndimage import gaussian_filter
    im = gaussian_filter(rng.uniform(0, 1, (256, 128, 3)), sigma=(3, 3, 0))
    im = (im - im.min()) / (im.max() - im.min() + 1e-9)
    return np.round(im * 255).astype(np.float32)[None] / 255


@pytest.fixture(scope='module')
def jax_qarv():
    import lvae_tpu
    from lvae_tpu.models.qarv import model as jqarv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqarv.QarvModel, '__init__', _jit_init)
        return lvae_tpu.get_model('qarv_tiny')


@pytest.fixture(scope='module')
def models(jax_qarv):
    """The three port models: qarv_tiny on the JAX model's weights, the
    others at their seeded init; qres_tiny's priors' last convs re-drawn
    and its posteriors' x300 (tests/test_torch_qres.py's _redraw): at init
    its posterior means round to 0 whatever the encoder computes."""
    out = {}
    for name in NAMES:
        torch.manual_seed(0)
        out[name] = lvae_tpu_torch.get_model(name, device='cpu')
    with torch.no_grad():
        for n, p in out['qres_tiny'].net.named_parameters():
            if n.endswith('prior.c4.weight'):
                p.copy_(torch.randn(p.shape) / p.shape[1] ** 0.5)
            elif n.endswith('posterior.c4.weight'):
                p.mul_(300)
    import jax
    out['qarv_tiny'].net.load_state_dict(
        params_from_flax(jax.device_get(jax_qarv.params)), strict=True)
    return out


@pytest.fixture(scope='module')
def batch4():
    return np.random.default_rng(3).uniform(0, 1, (4, 128, 64, 3)).astype(
        np.float32)


@pytest.fixture(scope='module')
def four_ranks(models, image256, batch4, tmp_path_factory):
    work = tmp_path_factory.mktemp('sp')
    for name, m in models.items():
        torch.save(m.net.state_dict(), work / f'{name}.pt')
    np.save(work / 'image.npy', image256)
    np.save(work / 'batch.npy', batch4)
    script = work / 'rank.py'
    script.write_text(_RANK)
    outs = torch_ranks.launch(script, 4, args=(
        work, torch_ranks.ROOT / 'tests'), timeout=250)
    results = [json.loads(next(l for l in out.splitlines()
                               if l.startswith('RESULT '))[7:])
               for out in outs]
    return work, results


@pytest.mark.timeout(300)
@pytest.mark.parametrize('name', NAMES)
def test_spatial_eval_matches_unsharded(four_ranks, models, image256, name):
    _, results = four_ranks
    m = models[name]
    ref = m.forward(image256) if name == 'qres_tiny' else \
        m.forward(image256, lmb=LMB)
    for n_space in (2, 4):
        got = [r['eval'][f'{name}/{n_space}'] for r in results[:n_space]]
        assert all(g == got[0] for g in got)      # the same on every rank
        for k in ('loss', 'bppix', 'psnr'):
            assert np.isfinite(got[0][k])
            assert got[0][k] == pytest.approx(ref[k], rel=STAT_RTOL), \
                (n_space, k, got[0][k], ref[k])


@pytest.mark.timeout(300)
def test_spatial_eval_matches_jax(four_ranks, jax_qarv, image256):
    from lvae_tpu import parallel as jparallel
    _, results = four_ranks
    ref = jparallel.spatial_eval(jax_qarv, image256,
                                 jparallel.get_2d_mesh(1, 2), lmb=LMB)
    got = results[0]['eval']['qarv_tiny/2']
    for k in ('loss', 'bppix', 'mse', 'psnr'):
        assert got[k] == pytest.approx(ref[k], rel=JAX_RTOL), \
            (k, got[k], ref[k])


@pytest.mark.timeout(300)
@pytest.mark.parametrize('n_space', [2, 4])
def test_halo_gradient_matches_unsharded(four_ranks, n_space):
    work, _ = four_ranks
    x, w = stack_inputs()
    x = x.clone().requires_grad_()
    net = _stack()
    loss = (net(x) * w).sum()
    grads = torch.autograd.grad(loss, [x] + list(net.parameters()))
    ranks = [dict(np.load(work / f'grads{n_space}_{r}.npz'))
             for r in range(n_space)]
    np.testing.assert_allclose(
        np.concatenate([r['x'] for r in ranks], axis=2), grads[0].numpy(),
        rtol=0, atol=GRAD_ATOL)
    for (name, _), g in zip(net.named_parameters(), grads[1:]):
        for r in ranks:
            np.testing.assert_allclose(r[name], g.numpy(), rtol=0,
                                       atol=GRAD_ATOL, err_msg=name)


@pytest.mark.timeout(300)
def test_dp_sp_step_matches_one_process(four_ranks, models, batch4):
    work, results = four_ranks
    steps = [r['step'] for r in results]
    assert all(s['digest'] == steps[0]['digest'] for s in steps)
    assert all(s['metrics'] == steps[0]['metrics'] for s in steps)
    assert all(s['equivalent'] for s in steps)
    model = lvae_tpu_torch.get_model('qarv_tiny', device='cpu')
    model.net.load_state_dict(models['qarv_tiny'].net.state_dict())
    state, metrics = dpsp_step(model, batch4, None)
    assert steps[0]['metrics']['loss'] == pytest.approx(
        float(metrics['loss']), rel=STEP_LOSS_RTOL)
    got = dict(np.load(work / 'dpsp.npz'))
    for kind, flat in (('params', state.flat), ('ema', state.ema)):
        for name, want in state.named(flat).items():
            np.testing.assert_allclose(got[f'{kind}/{name}'], want.numpy(),
                                       rtol=0, atol=STEP_ATOL,
                                       err_msg=f'{kind} {name}')


@pytest.mark.parametrize('conv', [
    nn.Conv2d(3, 4, 3, padding=0),               # no H padding
    nn.Conv2d(3, 4, 3, padding=1, dilation=2),
    nn.Conv2d(3, 4, 4, stride=2, padding=0),
    nn.Conv2d(3, 4, 3, padding=1, padding_mode='reflect'),
    nn.ConvTranspose2d(3, 4, 4, stride=2, padding=0),
])
def test_conv_without_halo_rule_raises(conv):
    mesh = parallel.get_2d_mesh(1, 1)
    x = torch.zeros(1, 3, 8, 8)
    with parallel.sharded(mesh), pytest.raises(ValueError,
                                               match='halo rule'):
        conv(x)
    conv(x)                                       # outside: as before
