"""The port's train step (training/optim.py) against the JAX package's
make_train_step on a small synthetic parameter tree: a conv, a dense layer,
a LayerNorm, a layer scale and a seed bias, named as the models name them.
The loss is sum(b * p) over the leaves, so that each step's gradients are
the batch b itself in both packages: plain steps (Adam, Adamax, SGD
momentum), accumulation, the clip by global norm, the median-spike LR cut
with the EMA frozen, weight decay on the weights group, and the non-finite
skip. Parameters, EMA and moments within rtol 1e-5 + atol 1e-7 (the
global norm sums in another order; every other operation is the same),
and bitwise where the step leaves them as they were. Also the three
parameter groups on the tiny models' parameters, and the LR schedules.

The port's one deviation (recorded in ROADMAP.md C): on a skipped step
with weight decay, the JAX step adds wdecay * p to the zeroed gradients
(ADVICE r5), the port feeds the moments zeros.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn as nn
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.models import base as jbase
from lvae_tpu.models.qarv import model as jqarv
from lvae_tpu.models.rd import model as jrd
from lvae_tpu.training import optim as joptim
from lvae_tpu.training import schedules as jsched

import lvae_tpu_torch
from lvae_tpu_torch.models.weights import _torch_key, flatten, params_from_flax
from lvae_tpu_torch.training import optim, schedules

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)
        self.fc = nn.Linear(4, 5)
        self.norm = nn.LayerNorm(5)
        self.gamma = nn.Parameter(torch.zeros(5))
        self.bias = nn.Parameter(torch.zeros(1, 4, 1, 1))


def toy_tree(rng, scale=1.0):
    def r(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {'conv': {'kernel': r(3, 3, 3, 4), 'bias': r(4)},
            'fc': {'kernel': r(4, 5), 'bias': r(5)},
            'norm': {'scale': r(5), 'bias': r(5)},
            'gamma': r(5), 'bias': r(1, 1, 1, 4)}


def jax_loss(params, batch, rng):
    loss = sum(jnp.sum(b * p) for b, p in zip(jax.tree.leaves(batch),
                                               jax.tree.leaves(params)))
    return loss, {'loss': loss}


def port_loss(net):
    def loss_fn(batch, generator):
        loss = sum((batch[n] * p).sum() for n, p in net.named_parameters())
        return loss, {'loss': loss}
    return loss_fn


def run_both(steps, optimizer='adam', accum_num=1, grad_clip=2.0, wdecay=0.0,
             ema=True):
    """steps: [(gradient tree, lr, grad_median, ema_decay)] -> the JAX and
    the port's states after each step, as flax-named numpy dicts, and the
    metrics."""
    init = toy_tree(np.random.default_rng(0))
    state, tx = joptim.create_train_state(jax.tree.map(jnp.asarray, init),
                                          optimizer=optimizer, ema=ema)
    jstep = jax.jit(joptim.make_train_step(jax_loss, tx, accum_num, grad_clip,
                                           wdecay, use_ema=ema))
    net = Toy()
    net.load_state_dict(params_from_flax(init), strict=True)
    pstate = optim.TrainState(net, optimizer=optimizer, ema=ema)
    pstep = optim.make_train_step(port_loss(net), pstate, accum_num,
                                  grad_clip, wdecay, use_ema=ema)
    out = []
    for grads, lr, median, decay in steps:
        state, jm = jstep(state, jax.tree.map(jnp.asarray, grads),
                          jax.random.PRNGKey(0), jnp.float32(lr),
                          jnp.float32(median), jnp.float32(decay))
        pm = pstep(params_from_flax(grads), None, lr, median, decay)
        js = jax.device_get(state)
        moments = (('trace',) if optimizer == 'sgd' else ('mu', 'nu'))
        jmom = {k: params_from_flax(getattr(js.opt_state, k))
                for k in moments}
        out.append(dict(
            jax=dict(params=params_from_flax(js.params),
                     ema=params_from_flax(js.ema_params) if ema else None,
                     moments=jmom, gnorm=float(jm['grad_norm'])),
            port=dict(params=_clone(pstate.named(pstate.flat)),
                      ema=_clone(pstate.named(pstate.ema)) if ema else None,
                      moments={k: _clone(pstate.named(v))
                               for k, v in pstate.moments.items()},
                      gnorm=float(pm['grad_norm']))))
    return out


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


def assert_close(a, b, what):
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f'{what} {k}')


def assert_same_step(r):
    j, p = r['jax'], r['port']
    assert_close(j['params'], p['params'], 'params')
    if j['ema'] is not None:
        assert_close(j['ema'], p['ema'], 'ema')
    for k in j['moments']:
        assert_close(j['moments'][k], p['moments'][k], k)
    if math.isfinite(j['gnorm']):
        assert abs(j['gnorm'] - p['gnorm']) <= 1e-5 * j['gnorm']
    else:
        assert not math.isfinite(p['gnorm'])


def grads_seq(n, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return [toy_tree(rng, scale) for _ in range(n)]


@pytest.mark.parametrize('optimizer', ['adam', 'adamax', 'sgd'])
def test_plain_steps(optimizer):
    steps = [(g, 1e-2 * (i + 1), 1e9, 0.9) for i, g in
             enumerate(grads_seq(4, scale=0.1))]
    for r in run_both(steps, optimizer=optimizer):
        assert_same_step(r)


def test_accumulation():
    steps = [(g, 1e-2, 1e9, 0.5) for g in grads_seq(6, scale=0.1)]
    out = run_both(steps, accum_num=3)
    for r in out:
        assert_same_step(r)
    # parameters move on the 3rd and 6th step only
    p = [r['port']['params'] for r in out]
    assert all(torch.equal(p[0][k], p[1][k]) for k in p[0])
    assert not all(torch.equal(p[1][k], p[2][k]) for k in p[0])


def test_clip_on_raw_gradients():
    steps = [(g, 1e-2, 1e9, 0.9) for g in grads_seq(3, scale=50.0)]
    out = run_both(steps, grad_clip=2.0)
    for r in out:
        assert r['jax']['gnorm'] > 2.0
        assert_same_step(r)


def test_spike_cuts_lr_and_freezes_ema():
    g = grads_seq(3, scale=0.1)
    out = run_both([(g[0], 1e-2, 1e9, 0.9), (g[1], 1e-2, 1e-6, 0.9),
                    (g[2], 1e-2, 1e9, 0.9)])
    for r in out:
        assert_same_step(r)
    before, spiked = out[0]['port'], out[1]['port']
    assert all(torch.equal(before['ema'][k], spiked['ema'][k])
               for k in before['ema'])
    assert not all(torch.equal(before['params'][k], spiked['params'][k])
                   for k in before['params'])


def test_weight_decay_on_the_weights_group():
    steps = [(g, 1e-2, 1e9, 0.9) for g in grads_seq(3, scale=0.1)]
    out = run_both(steps, wdecay=0.1)
    for r in out:
        assert_same_step(r)
    net = Toy()
    st = optim.TrainState(net)
    assert st.groups == {'conv.weight': 'weights', 'conv.bias': 'bias',
                         'fc.weight': 'weights', 'fc.bias': 'bias',
                         'norm.weight': 'other', 'norm.bias': 'bias',
                         'gamma': 'other', 'bias': 'bias'}


def _nan_step(g):
    bad = jax.tree.map(np.copy, g)
    bad['fc']['kernel'][0, 0] = np.nan
    return bad


def test_nonfinite_step_is_skipped():
    g = grads_seq(3, scale=0.1)
    out = run_both([(g[0], 1e-2, 1e9, 0.9), (_nan_step(g[1]), 1e-2, 1e9, 0.9),
                    (g[2], 1e-2, 1e9, 0.9)])
    for r in out:
        assert_same_step(r)
    before, skipped = out[0]['port'], out[1]['port']
    for what in ('params', 'ema'):
        assert all(torch.equal(before[what][k], skipped[what][k])
                   for k in before[what])
    # the moments take one zero-gradient step
    for k in before['moments']['mu']:
        assert torch.equal(skipped['moments']['mu'][k],
                           before['moments']['mu'][k] * optim.B1)


def test_nonfinite_step_with_weight_decay_feeds_zeros():
    """The recorded deviation: the port's skipped step feeds the moments
    zeros with wdecay > 0, the JAX step wdecay * p."""
    g = grads_seq(2, scale=0.1)
    out = run_both([(g[0], 1e-2, 1e9, 0.9), (_nan_step(g[1]), 1e-2, 1e9, 0.9)],
                   wdecay=0.1)
    assert_same_step(out[0])
    before, skipped = out[0]['port'], out[1]['port']
    for what in ('params', 'ema'):
        assert all(torch.equal(before[what][k], skipped[what][k])
                   for k in before[what])
        assert_close(out[1]['jax'][what], skipped[what], what)
    for k in before['moments']['mu']:
        assert torch.equal(skipped['moments']['mu'][k],
                           before['moments']['mu'][k] * optim.B1)
    jmu = out[1]['jax']['moments']['mu']['conv.weight']
    assert not torch.allclose(jmu, skipped['moments']['mu']['conv.weight'])


def _shape_init(self, net, *args, **kwargs):
    """The JAX handles without their init: the parameter tree's shapes."""
    self.net = net
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    keys = {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}
    if hasattr(net, 'lmb_range'):
        lmb = jnp.full((1,), 64.0, jnp.float32)
        self.params = jax.eval_shape(net.init, keys, dummy, lmb)['params']
    else:
        self.params = jax.eval_shape(net.init, keys, dummy)['params']


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny', 'rd_tiny'])
def test_param_groups_match_jax_labels(name):
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jbase.VAEModelBase, jqarv.QarvModel, jrd.RDModel):
            mp.setattr(cls, '__init__', _shape_init)
        jm = lvae_tpu.get_model(name)
    net = lvae_tpu_torch.get_model(name, device='cpu').net
    paths = flatten(jax.tree.map(lambda s: s.shape, jm.params,
                                 is_leaf=lambda x: hasattr(x, 'shape')))
    assert len(paths) == len(list(net.parameters()))
    counts = {}
    for path in paths:
        want = joptim.param_group_label(path)
        got = optim.param_group_label(_torch_key(path), net)
        assert got == want, (path, got, want)
        counts[want] = counts.get(want, 0) + 1
    assert set(counts) == {'weights', 'bias', 'other'}


def test_schedules_match_jax():
    T = 1000
    for sched in ('constant', 'cosine', 'const-0.5-cos'):
        for warmup in (0, 50):
            for t in range(0, T, 7):
                assert schedules.lr_factor(t, T, sched, warmup, 0.01) == \
                    jsched.lr_factor(t, T, sched, warmup, 0.01)
    for t in range(0, 200, 3):
        assert schedules.get_cosine_factor(t, 199, 0.05) == \
            jsched.get_cosine_factor(t, 199, 0.05)
    with pytest.raises(NotImplementedError):
        schedules.lr_factor(10, T, 'linear')


def test_state_dict_round_trip():
    net = Toy()
    st = optim.TrainState(net, optimizer='adamax')
    step = optim.make_train_step(port_loss(net), st)
    for g in grads_seq(2, scale=0.1):
        step(params_from_flax(g), None, 1e-2, 1e9, 0.9)
    sd = st.state_dict()
    net2 = Toy()
    st2 = optim.TrainState(net2, optimizer='adamax')
    st2.load_state_dict(sd)
    assert (st2.count, st2.step, st2.accum_count) == (2, 2, 0)
    for a, b in ((st.flat, st2.flat), (st.ema, st2.ema),
                 (st.moments['nu'], st2.moments['nu'])):
        assert torch.equal(a, b)
    assert torch.equal(net2.fc.weight, net.fc.weight)
