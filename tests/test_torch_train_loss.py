"""The training loss of the port against the JAX package's on the CPU, at
qarv_tiny, qres_tiny and rd_tiny (64x64, B = 2): loss_and_stats and its
gradients against jax.value_and_grad of the JAX loss_and_stats, on the same
lambdas and the noise the JAX loss drew (jax.random.uniform / normal,
recorded inside the traced loss and replayed through
entropy_coding.uniform_noise / normal_noise).

Tolerances: float32, the loss within rtol 1e-5 and each gradient leaf
within atol 1e-5 * max|g| (the leaf's) + rtol 1e-4 (library convolutions
sum in other orders); bf16 (compute_dtype='bfloat16'), the loss within
1 % and the cosine of all gradients >= 0.99 per family (bf16 rounds
differently in XLA's and torch's CPU kernels). The gradients are compared
as flax trees, through flax_from_params, the inverse of
weights.params_from_flax (bitwise on a round trip). remat in the port
alone: the loss and gradients bitwise equal without it, and the generator
in the same state afterwards.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.models import base as jbase
from lvae_tpu.models.qarv import model as jqarv
from lvae_tpu.models.rd import model as jrd

import lvae_tpu_torch
from lvae_tpu_torch.models import entropy_coding as tec
from lvae_tpu_torch.models.weights import _torch_key, flatten, params_from_flax

NAMES = ['qarv_tiny', 'qres_tiny', 'rd_tiny']
LMBS = np.array([64.0, 1024.0], np.float32)
LOSS_RTOL = 1e-5
GRAD_ATOL_REL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_COSINE = 0.01, 0.99


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit_init(self, net, seed=0, example_hw=64, log_images=()):
    """The JAX handles' inits, jitted (one compile, not an op-by-op
    trace), with the attributes loss_and_stats reads."""
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    self.net = net
    key = {'params': jax.random.PRNGKey(seed)}
    if hasattr(net, 'lmb_range'):
        self.lmb_range = tuple(float(v) for v in net.lmb_range)
        self.default_lmb = self.lmb_range[1]
        lmb = jnp.full((1,), self.lmb_range[1], jnp.float32)
        key['noise'] = jax.random.PRNGKey(1)
        self.params = jax.jit(net.init)(key, dummy, lmb)['params']
    else:
        self.params = jax.jit(net.init)(key, dummy)['params']


def _redraw_prior(params, rng):
    """Each QRes prior's last conv at the lecun-normal scale (flax
    zero-initialises it)."""
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(c4['kernel'].shape[2])).astype(
                                np.float32)
    return params


def flax_from_params(sd, tree, net=None):
    """The port's state dict -> a flax tree shaped like `tree`: the inverse
    of params_from_flax."""
    transposed = set()
    if net is not None:
        transposed = {f'{n}.weight' for n, m in net.named_modules()
                      if isinstance(m, torch.nn.ConvTranspose2d)}
    out = {}
    for path, leaf in flatten(tree).items():
        key = _torch_key(path)
        a = sd[key].detach().cpu().numpy()
        if key in transposed:
            a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif path[-1] == 'kernel' and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif path[-1] == 'kernel' and a.ndim == 2:
            a = a.T
        elif path == ('bias',) and a.ndim == 4:
            a = a.transpose(0, 2, 3, 1)
        assert a.shape == np.shape(leaf), (path, a.shape)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


@pytest.fixture(scope='module')
def models():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase.VAEModelBase, '__init__', _jit_init)
        mp.setattr(jqarv.QarvModel, '__init__', _jit_init)
        mp.setattr(jrd.RDModel, '__init__', _jit_init)
        for name in NAMES:
            jm = lvae_tpu.get_model(name)
            params = jax.device_get(jm.params)
            if name == 'qres_tiny':
                params = _redraw_prior(params, np.random.default_rng(0))
            tm = lvae_tpu_torch.get_model(name, device='cpu')
            tm.net.load_state_dict(params_from_flax(params), strict=True)
            out[name] = jm, tm, params
    return out


@pytest.fixture(scope='module')
def image():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


def _has_lmb(name):
    return name != 'qres_tiny'


def jax_loss_grads(jm, name, params, im, cd):
    """jax.value_and_grad of the JAX loss_and_stats, jitted, -> (loss,
    stats, grads, the noise draws in order)."""
    log = []

    def record(f):
        def g(*a, **kw):
            out = f(*a, **kw)
            log.append(out)
            return out
        return g

    def fn(p, im):
        del log[:]
        kw = dict(lmb=jnp.asarray(LMBS)) if _has_lmb(name) else {}
        loss, stats = jm.loss_and_stats(p, im, jax.random.PRNGKey(3),
                                        training=True, compute_dtype=cd, **kw)
        return loss, (stats, list(log))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'uniform', record(jax.random.uniform))
        mp.setattr(jax.random, 'normal', record(jax.random.normal))
        (loss, (stats, drawn)), grads = jax.jit(
            jax.value_and_grad(fn, has_aux=True))(
                jax.tree.map(jnp.asarray, params), jnp.asarray(im))
    return jax.device_get((loss, stats, grads, drawn))


def port_loss_grads(tm, name, im, cd, drawn=None, generator=None,
                    remat=False):
    """The port's loss_and_stats and its gradients (torch names), the noise
    replayed from `drawn` when given."""
    x = torch.from_numpy(im).permute(0, 3, 1, 2).contiguous()
    kw = dict(lmb=torch.from_numpy(LMBS)) if _has_lmb(name) else {}
    with pytest.MonkeyPatch.context() as mp:
        if drawn is not None:
            queue = list(drawn)

            def replay(like, generator=None):
                # bf16 draws pass through float32 exactly
                t = torch.from_numpy(np.asarray(queue.pop(0), np.float32)
                                     ).permute(0, 3, 1, 2)
                assert tuple(t.shape) == tuple(like.shape)
                return t.to(like.dtype).contiguous()
            mp.setattr(tec, 'uniform_noise', replay)
            mp.setattr(tec, 'normal_noise', replay)
        loss, stats = tm.loss_and_stats(x, training=True, generator=generator,
                                        compute_dtype=cd, remat=remat, **kw)
        named = list(tm.net.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    if drawn is not None:
        assert not queue, 'the port drew less noise than the JAX loss'
    return loss.detach(), stats, {n: g for (n, _), g in zip(named, grads)}


@pytest.fixture(scope='module', params=[None, 'bfloat16'],
                ids=['f32', 'bf16'])
def compared(request, models, image):
    """Per family: (JAX loss, stats, grads; port loss, stats, flax-tree
    grads) at one compute dtype."""
    cd = request.param
    out = {}
    for name in NAMES:
        jm, tm, params = models[name]
        jl, js, jg, drawn = jax_loss_grads(jm, name, params, image, cd)
        assert len(drawn) == tm.num_latents
        tl, ts, tg = port_loss_grads(tm, name, image, cd, drawn)
        out[name] = (jl, js, jg, tl, ts, flax_from_params(tg, jg, tm.net))
    return cd, out


def test_flax_from_params_round_trips_bitwise(models):
    for name in NAMES:
        _, tm, params = models[name]
        back = flax_from_params(params_from_flax(params), params, tm.net)
        for path, leaf in flatten(params).items():
            got = flatten(back)[path]
            assert got.dtype == np.float32 and np.array_equal(
                got.view(np.uint32), np.asarray(leaf, np.float32).view(
                    np.uint32)), path


@pytest.mark.parametrize('name', NAMES)
def test_loss_and_grads_match_jax(compared, name):
    cd, out = compared
    jl, js, jg, tl, ts, tg = out[name]
    assert np.isfinite(float(tl))
    for k in js:
        assert ts[k].dtype == torch.float32, k
    if cd is None:
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
        for k in js:
            np.testing.assert_allclose(float(ts[k].detach()), float(js[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        for path, want in flatten(jg).items():
            got = flatten(tg)[path]
            want = np.asarray(want, np.float32)
            atol = GRAD_ATOL_REL * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                                       err_msg=str(path))
    else:
        rel = abs(float(tl) - float(jl)) / abs(float(jl))
        paths = sorted(flatten(jg))
        a = np.concatenate([np.ravel(flatten(jg)[p]).astype(np.float64)
                            for p in paths])
        b = np.concatenate([np.ravel(flatten(tg)[p]).astype(np.float64)
                            for p in paths])
        cos = a @ b / np.linalg.norm(a) / np.linalg.norm(b)
        print(f'{name} bf16: loss {rel:.2e} relative from the JAX '
              f'package\'s, gradient cosine {cos:.6f}')
        assert rel <= BF16_LOSS_RTOL and cos >= BF16_COSINE, (rel, cos)


@pytest.mark.parametrize('cd', [None, 'bfloat16'], ids=['f32', 'bf16'])
@pytest.mark.parametrize('name', NAMES)
def test_remat_is_bitwise_and_draws_once(models, image, name, cd):
    _, tm, _ = models[name]
    runs = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(11)
        loss, _, grads = port_loss_grads(tm, name, image, cd, generator=g,
                                         remat=remat)
        runs.append((loss, grads, g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(s0, s1)


def test_bf16_masters_stay_float32(models, image):
    """The bf16 forward's gradients land on the float32 parameters, and
    the parameters are not changed by the casts."""
    _, tm, _ = models['qarv_tiny']
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    _, _, grads = port_loss_grads(tm, 'qarv_tiny', image, 'bfloat16',
                                  generator=torch.Generator().manual_seed(0))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    after = tm.net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
