"""The sampling entry points of QARV and QRes-VAE in the port against the
JAX package's on the CPU (qarv_tiny, qres_tiny, qres_tiny_lossless):
conditional sampling on a model's own latents equals its eval
reconstruction; samples at temperature 0 (no noise counts) and samples on
the noise the JAX package drew (jax.random.normal and uniform recorded in
order inside the jitted JAX sampling and replayed through
entropy_coding.normal_noise / uniform_noise); inpaint at steps=2 on
replayed noise (the JAX handle's own loop, its two network calls jitted);
write_png read back by read_png and by Pillow; study's PNGs within one
grey level of the JAX package's.

Tolerances: the samples at temperature 0 atol 1e-5 (library convolutions
summed in other orders). The samples on drawn noise atol 1e-5 + rtol 1e-4,
the trunk floats' tolerance: at flax init qarv_tiny's pre-clip output
reaches |x| = 317 (one float32 ulp there is 3.1e-5), and 4 of its 24,576
sampled values come out 1.69e-5 apart.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import lvae_tpu
from lvae_tpu.models import base as jbase
from lvae_tpu.models.qarv import model as jqarv

import lvae_tpu_torch
from lvae_tpu_torch.models import entropy_coding as tec
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.utils import coding

ATOL = 1e-5
RTOL_NOISE = 1e-4
COLLIE = 'images/collie64.png'
NAMES = ['qarv_tiny', 'qres_tiny', 'qres_tiny_lossless']
LMB = 512.0


def _jit_init(self, net, seed=0, example_hw=64, log_images=()):
    """The JAX handles' inits, jitted (one compile, not an op-by-op trace);
    QarvModel's keeps its own attributes."""
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    self.net = net
    if isinstance(net, jqarv.VariableRateLossyVAENet):
        self.lmb_range = tuple(float(v) for v in net.lmb_range)
        self.default_lmb = self.lmb_range[1]
        self._logging_images = list(log_images)
        self.num_latents = sum(1 for b in net.dec_blocks
                               if getattr(b, 'is_latent_block', False))
        self.compressing = False
        lmb = jnp.full((1,), self.lmb_range[1], jnp.float32)
        self.params = jax.jit(net.init)({'params': jax.random.PRNGKey(seed)},
                                        dummy, lmb)['params']
    else:
        self.params = jax.jit(net.init)({'params': jax.random.PRNGKey(seed)},
                                        dummy)['params']


def _redraw_prior(params, rng):
    """Each QRes prior's last conv at the lecun-normal scale (flax
    zero-initialises it: pm = 0 and one scale everywhere)."""
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(c4['kernel'].shape[2])).astype(
                                np.float32)
    return params


@pytest.fixture(scope='module')
def models():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase.VAEModelBase, '__init__', _jit_init)
        mp.setattr(jqarv.QarvModel, '__init__', _jit_init)
        for name in NAMES:
            jm = lvae_tpu.get_model(name)
            params = jax.device_get(jm.params)
            if name != 'qarv_tiny':
                params = _redraw_prior(params, np.random.default_rng(0))
            jm.params = jax.tree.map(jnp.asarray, params)
            if name != 'qarv_tiny':     # built by its handle's init
                jm.num_latents = sum(
                    1 for b in jm.net.dec_blocks
                    if getattr(b, 'is_latent_block', False))
            tm = lvae_tpu_torch.get_model(name, device='cpu')
            tm.net.load_state_dict(params_from_flax(params), strict=True)
            out[name] = jm, tm
    return out


@pytest.fixture(scope='module')
def image():
    return coding.read_png(COLLIE).astype(np.float32)[None] / 255.0


class Recorded:
    """A jitted JAX function that also returns the normal and uniform
    draws it made, in order, with their kinds (taken while tracing)."""

    def __init__(self, fn):
        self.kinds = None
        log = []

        def wrapped(*args):
            del log[:]
            out = fn(*args)
            self.kinds = [k for k, _ in log]
            return out, [a for _, a in log]
        self.log = log
        self.jit = jax.jit(wrapped)

    def __call__(self, *args):
        normal, uniform = jax.random.normal, jax.random.uniform

        def rec(kind, f):
            def g(*a, **kw):
                out = f(*a, **kw)
                self.log.append((kind, out))
                return out
            return g
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'normal', rec('normal', normal))
            mp.setattr(jax.random, 'uniform', rec('uniform', uniform))
            out, drawn = self.jit(*args)
        return jax.device_get(out), list(zip(self.kinds,
                                             jax.device_get(drawn)))


def replay(monkeypatch, drawn):
    """The port's noise helpers return the JAX draws in the order drawn
    (NHWC -> NCHW); returns the queue, which must end empty."""
    queue = list(drawn)

    def pop(kind):
        def draw(like, generator=None):
            k, a = queue.pop(0)
            assert k == kind
            t = torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
            assert tuple(t.shape) == tuple(like.shape)
            return t.to(like.dtype).contiguous()
        return draw
    monkeypatch.setattr(tec, 'normal_noise', pop('normal'))
    monkeypatch.setattr(tec, 'uniform_noise', pop('uniform'))
    return queue


def jax_sampler(jm, bhw, t, seed=0, lmb=LMB):
    """The JAX handle's sampling, jitted: QARV conditional_sample (lvae_tpu/
    models/qarv/model.py:499-512), QRes uncond_sample / cond_sample
    (lvae_tpu/models/qresvae/model.py:473-498), clip included."""
    rng = jax.random.PRNGKey(seed)
    if isinstance(jm.net, jqarv.VariableRateLossyVAENet):
        def fn(params, latents):
            lmbs = jnp.full((bhw[0],), lmb, jnp.float32)
            x = jm.net.apply({'params': params}, lmbs, latents, bhw, t,
                             method=jm.net.forward_sampling,
                             rngs={'sample': rng})
            return jnp.clip(x, -1, 1) * 0.5 + 0.5
        return Recorded(fn)

    def fn(params, latents, paint_masks=None):
        if latents is None:
            feature = jm.net.apply({'params': params}, bhw, t,
                                   method=jm.net.forward_uncond,
                                   rngs={'sample': rng})
        else:
            feature = jm.net.apply({'params': params}, latents, None, t,
                                   paint_masks,
                                   method=jm.net.forward_with_latents,
                                   rngs={'sample': rng})
        if jm.lossless:
            x = jm.net.apply({'params': params}, feature, rng, t,
                             method=jm.net.sample_output)
        else:
            x = jm.net.apply({'params': params}, feature, None,
                             method=jm.net.sample_output)
        return jnp.clip(x, -1, 1) * 0.5 + 0.5
    return Recorded(fn)


def prior_only(jm):
    """The latents argument of an unconditional JAX sample."""
    if isinstance(jm.net, jqarv.VariableRateLossyVAENet):
        return [None] * jm.num_latents
    return None


def port_uncond(tm, bhw, t, seed=0):
    if hasattr(tm, 'unconditional_sample'):
        return tm.unconditional_sample(LMB, bhw, t=t, seed=seed)
    return tm.uncond_sample(bhw, temprature=t, seed=seed)


def port_latents(tm, im):
    if hasattr(tm, 'unconditional_sample'):
        return tm.forward_get_latents(im, LMB)
    return tm.forward_get_latents(im)


@pytest.mark.parametrize('name', NAMES)
def test_conditional_sample_on_own_latents_equals_reconstruction(
        models, image, name):
    """The decoder on forward_get_latents' z is the eval forward's decoder:
    bitwise (a lossless model's pixels at temperature 0: the head's
    means)."""
    _, tm = models[name]
    lat = port_latents(tm, image)
    assert len(lat) == tm.num_latents
    assert all(st['z'].ndim == 4 and st['kl'].shape == st['z'].shape
               for st in lat)
    z = [st['z'] for st in lat]
    if name == 'qarv_tiny':
        rec = tm.reconstruct(image, LMB)
        got = tm.conditional_sample(LMB, z)
    else:
        rec = tm.reconstruct(image)
        got = tm.cond_sample(z, temprature=0.0 if tm.lossless else 1.0)
    assert got.shape == rec.shape == image.shape
    assert np.array_equal(got, rec)


@pytest.mark.parametrize('name', NAMES)
def test_temperature_zero_samples_match_jax(models, name):
    jm, tm = models[name]
    for bhw in [(2, 1, 1), (1, 2, 1)]:
        want, _ = jax_sampler(jm, bhw, 0.0)(jm.params, prior_only(jm))
        got = port_uncond(tm, bhw, 0.0)
        assert got.shape == (bhw[0], 64 * bhw[1], 64 * bhw[2], 3)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('name', NAMES)
def test_samples_on_jax_drawn_noise_match_jax(models, name, monkeypatch):
    jm, tm = models[name]
    bhw = (2, 1, 1)
    want, drawn = jax_sampler(jm, bhw, 1.0)(jm.params, prior_only(jm))
    kinds = [k for k, _ in drawn]
    n = tm.num_latents
    assert kinds == ['normal', 'uniform'] * n + (['normal'] if name ==
                                                 'qres_tiny_lossless' else [])
    means = port_uncond(tm, bhw, 0.0)
    queue = replay(monkeypatch, drawn)
    got = port_uncond(tm, bhw, 1.0)
    assert not queue
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL_NOISE)
    assert np.abs(got - means).max() > 1e-3       # the noise counted


def test_samples_repeat_for_a_seed(models):
    for name in NAMES:
        _, tm = models[name]
        a = port_uncond(tm, (2, 1, 1), 1.0, seed=5)
        assert np.array_equal(a, port_uncond(tm, (2, 1, 1), 1.0, seed=5))
        assert not np.array_equal(a, port_uncond(tm, (2, 1, 1), 1.0))
        assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1


@pytest.mark.parametrize('name', ['qres_tiny', 'qres_tiny_lossless'])
def test_inpaint_on_jax_drawn_noise_matches_jax(models, image, name,
                                                monkeypatch):
    """The JAX handle's inpaint loop with its forward_get_latents and
    cond_sample jitted (the noise of each step recorded), then the port's
    inpaint on that noise: the two samples within atol."""
    jm, tm = models[name]
    box = (0.25, 0.25, 0.75, 0.75)
    latents_fn = jax.jit(lambda p, x: jm.net.apply(
        {'params': p}, x, False, True, method=jm.net.forward,
        rngs={'noise': jax.random.PRNGKey(0)})[2])
    drawn = []
    samplers = {}

    def forward_get_latents(x):
        stats = jax.device_get(latents_fn(jm.params, jnp.asarray(x)))
        return [{k: np.asarray(v) for k, v in st.items()} for st in stats]

    def cond_sample(latents, temprature=1.0, paint_masks=None, seed=0):
        if seed not in samplers:
            samplers[seed] = jax_sampler(jm, None, temprature, seed)
        out, d = samplers[seed](jm.params, [jnp.asarray(z) for z in latents],
                                [jnp.asarray(m) for m in paint_masks])
        drawn.extend(d)
        return np.asarray(out)

    monkeypatch.setattr(jm, 'forward_get_latents', forward_get_latents)
    monkeypatch.setattr(jm, 'cond_sample', cond_sample)
    want = jm.inpaint(image, box, steps=2)
    assert len(drawn) == 2 * (2 * tm.num_latents + tm.lossless)
    queue = replay(monkeypatch, drawn)
    got = tm.inpaint(image, box, steps=2)
    assert not queue
    assert got.shape == image.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL_NOISE)


def test_write_png_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    for h, w in [(1, 1), (5, 7), (64, 129)]:
        a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        p = tmp_path / f'{h}x{w}.png'
        coding.write_png(p, a)
        assert np.array_equal(coding.read_png(p), a)
        assert np.array_equal(np.asarray(Image.open(p).convert('RGB')), a)
        assert coding.png_size(p) == (h, w)
    with pytest.raises(ValueError, match='uint8'):
        coding.write_png(tmp_path / 'x.png', np.zeros((2, 2, 3)))
    # batch_to_image rounds as the JAX package's does
    x = rng.uniform(-0.1, 1.1, (1, 9, 11, 3)).astype(np.float32)
    assert np.array_equal(coding.batch_to_image(x),
                          np.asarray(jbase.batch_to_image(x)))


def test_study_within_one_grey_level_of_jax(models, tmp_path, monkeypatch):
    """qarv_tiny's study in both packages (the sample grids on the same
    noise, collie64 beside its reconstruction): every PNG of the JAX
    package's, pixel for pixel within one grey level."""
    jm, tm = models['qarv_tiny']
    jm._logging_images = tm._logging_images = ['collie64.png']
    drawn = []
    samplers = {}

    def unconditional_sample(lmb, bhw_repeat, t=1.0, seed=0):
        key = tuple(bhw_repeat)
        if key not in samplers:
            samplers[key] = jax_sampler(jm, key, t, seed, lmb)
        out, d = samplers[key](jm.params, [None] * jm.num_latents)
        drawn.extend(d)
        return np.asarray(out)

    monkeypatch.setattr(jm, 'unconditional_sample', unconditional_sample)
    jm.study(tmp_path / 'jax')
    queue = replay(monkeypatch, drawn)
    tm.study(tmp_path / 'port')
    assert not queue
    names = sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert names == ['collie64.png', 'samples_k1_hw64.png',
                     'samples_k2_hw128.png']
    assert names == sorted(p.name for p in (tmp_path / 'port').iterdir())
    for n in names:
        want = np.asarray(Image.open(tmp_path / 'jax' / n).convert('RGB'))
        got = coding.read_png(tmp_path / 'port' / n)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1, n
