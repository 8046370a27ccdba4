"""The port's RD model (lvae_tpu_torch/models/rd/model.py) against the JAX
package's on the CPU: linear_sqrt, gaussian_kl and std_smooth on seeded
inputs and at their edges; rd_tiny and its non-companded ('nosmooth')
variant through the training forward on the normals the JAX package drew
(jax.random.normal recorded inside the jitted forward and replayed through
entropy_coding.normal_noise); forward_sampling on given latents and at
t = 0; self_evaluate's lambda grid and stats on a 64 x 64 PNG.

Tolerances: the elementwise functions rtol 1e-6 + atol 1e-7 (XLA's and
torch's tanh, pow, log and logaddexp differ in the last bits); each
block's kl atol 1e-5 + rtol 1e-4, x_hat and the samples atol 1e-5, the
stats rtol 1e-4, PSNR 1e-3 dB (library convolutions summed in other
orders).
"""
import math
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.models.rd import model as jrd

import lvae_tpu_torch
from lvae_tpu_torch.models import entropy_coding as tec
from lvae_tpu_torch.models.rd import model as trd
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.utils import coding

FN_RTOL, FN_ATOL = 1e-6, 1e-7
KL_ATOL, KL_RTOL = 1e-5, 1e-4
X_ATOL = 1e-5
STATS_RTOL = 1e-4
PSNR_DB = 1e-3
COLLIE = 'images/collie64.png'
LMBS = [4.0, 2048.0]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, atol, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert err.max() <= 0, f'max excess {err.max():.3g}'


# ---- the elementwise functions -------------------------------------------

def _edges():
    f = np.float32
    six = f(6.0)
    ulp = [np.nextafter(six, f(0)), six, np.nextafter(six, f(10))]
    vals = [f(0), f(-0.0), f(1e-30), f(1e-7), f(0.5), f(1), f(3)] + ulp
    vals += [f(7), f(100), f(1e4), f(3e38)]
    vals = np.array(vals, np.float32)
    rng = np.random.default_rng(0)
    rand = rng.normal(0, 4, 4096).astype(np.float32)
    return np.concatenate([vals, -vals, rand])


def test_linear_sqrt_matches_jax():
    x = _edges()
    want = np.asarray(jrd.linear_sqrt(jnp.asarray(x)))
    got = trd.linear_sqrt(torch.from_numpy(x)).numpy()
    close(got, want, FN_ATOL, FN_RTOL)
    # x == 0 returns x itself, the sign of zero too
    zeros = np.array([0.0, -0.0], np.float32)
    z = trd.linear_sqrt(torch.from_numpy(zeros)).numpy()
    assert np.array_equal(np.signbit(z), np.signbit(zeros))
    # either side of the threshold takes its own branch
    six = np.float32(6.0)
    below = np.nextafter(six, np.float32(0))
    above = np.nextafter(six, np.float32(10))
    got = trd.linear_sqrt(torch.tensor([below, six, above])).numpy()
    soft = np.power(np.float64([below, six]),
                    1 - 0.5 * np.tanh(np.float64([below, six])))
    assert np.allclose(got[:2], soft, rtol=1e-6)
    assert np.isclose(got[2], math.sqrt(float(above) + 1e-8), rtol=1e-6)


def test_gaussian_kl_matches_jax():
    rng = np.random.default_rng(1)
    n = 4096
    mu1, mu2 = rng.normal(0, 3, (2, n)).astype(np.float32)
    v1, v2 = np.exp(rng.uniform(-4, 3, (2, n))).astype(np.float32)
    want = np.asarray(jrd.gaussian_kl(*map(jnp.asarray, (mu1, v1, mu2, v2))))
    got = trd.gaussian_kl(*map(torch.from_numpy, (mu1, v1, mu2, v2))).numpy()
    # the sum cancels (kl 0.005 from terms of 2.5), so the relative
    # tolerance is taken of the terms' magnitude, not of the result's
    m1, s1, m2, s2 = (a.astype(np.float64) for a in (mu1, v1, mu2, v2))
    quad = 0.5 * (s1 ** 2 + (m1 - m2) ** 2) / s2 ** 2
    terms = 0.5 + np.abs(np.log(s2)) + np.abs(np.log(s1)) + quad
    excess = np.abs(got.astype(np.float64) - want) - (FN_ATOL
                                                      + FN_RTOL * terms)
    assert excess.max() <= 0, f'max excess {excess.max():.3g}'
    # and each package within float32 rounding of the float64 value: eight
    # rounded operations on terms of that magnitude
    exact = -0.5 + np.log(s2) - np.log(s1) + quad
    for a in (got, want):
        assert (np.abs(a - exact) <= 8 * 2.0 ** -24 * terms).all()
    # standard deviations, not variances: KL(N(0, 1) || N(0, 2^2))
    one = torch.ones(1)
    kl = trd.gaussian_kl(0 * one, one, 0 * one, 2 * one).item()
    assert math.isclose(kl, math.log(2) + 1 / 8 - 0.5, rel_tol=1e-6)


def test_std_smooth_matches_jax_either_side_of_the_threshold():
    f = np.float32
    edge = f(12.0 / math.log(2.0))
    around = [edge]
    for _ in range(3):
        around += [np.nextafter(around[-1], f(100))]
    v = around[-1]
    for _ in range(6):
        v = np.nextafter(v, f(0))
        around.append(v)
    rng = np.random.default_rng(2)
    x = np.concatenate([np.array(around, np.float32),
                        np.array([-100, -20, -1, 0, 1, 20, 100, 1e6],
                                 np.float32),
                        rng.normal(0, 8, 4096).astype(np.float32)])
    beta = math.log(2.0)
    assert (x * np.float32(beta) > 12).any() and \
        (x * np.float32(beta) <= 12).any()
    want = np.asarray(jrd.std_smooth(jnp.asarray(x)))
    got = trd.std_smooth(torch.from_numpy(x)).numpy()
    close(got, want, FN_ATOL, FN_RTOL)
    # torch's softplus(beta, threshold) is the same definition
    ref = torch.nn.functional.softplus(torch.from_numpy(x), beta=beta,
                                       threshold=12.0).numpy()
    close(got, ref, FN_ATOL, FN_RTOL)


# ---- rd_tiny ---------------------------------------------------------------

def _jit_init(self, net, seed=0, example_hw=64, log_images=()):
    """RDModel's init (lvae_tpu/models/rd/model.py:249-260), jitted: one
    compile, not an op-by-op trace of the whole forward."""
    self.lmb_range = tuple(float(v) for v in net.lmb_range)
    self.default_lmb = self.lmb_range[1]
    self._logging_images = list(log_images)
    self.net = net
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    dummy_lmb = jnp.full((1,), self.lmb_range[1], jnp.float32)
    self.params = jax.jit(net.init)({'params': jax.random.PRNGKey(seed),
                                     'noise': jax.random.PRNGKey(1)},
                                    dummy, dummy_lmb)['params']
    self.num_latents = sum(1 for b in net.dec_blocks
                           if getattr(b, 'is_latent_block', False))


@pytest.fixture(scope='module')
def models():
    """{'smooth': (jax, port) rd_tiny at the JAX package's flax init,
    'nosmooth': the same weights with use_linear_sqrt=False in both
    packages}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrd.RDModel, '__init__', _jit_init)
        jm = lvae_tpu.get_model('rd_tiny')
    sd = params_from_flax(jax.device_get(jm.params))
    out = {}
    for kind in ('smooth', 'nosmooth'):
        tm = lvae_tpu_torch.get_model('rd_tiny', device='cpu')
        tm.net.load_state_dict(sd, strict=True)
        if kind == 'nosmooth':
            j2 = jrd.RDModel.__new__(jrd.RDModel)
            j2.__dict__.update(jm.__dict__)
            j2.net = jm.net.clone(dec_blocks=tuple(
                b.clone(use_linear_sqrt=False)
                if isinstance(b, jrd.LatentVariableBlock) else b
                for b in jm.net.dec_blocks))
            for b in tm.net.dec_blocks:
                if isinstance(b, trd.LatentVariableBlock):
                    b.use_linear_sqrt = False
            out[kind] = j2, tm
        else:
            out[kind] = jm, tm
    return out


@pytest.fixture(scope='module')
def image():
    im = coding.read_png(COLLIE).astype(np.float32) / 255.0
    rng = np.random.default_rng(4)
    return np.stack([im, rng.uniform(0, 1, im.shape).astype(np.float32)])


_FORWARDS = {}


def jax_forward(jm, im, lmbs, monkeypatch):
    """The JAX training forward (jitted) -> (per-block stats with z, x_hat,
    loss_and_stats's stats, the normals it drew in order); one run a model,
    image and lambdas."""
    key = (id(jm), im.tobytes(), tuple(lmbs))
    if key not in _FORWARDS:
        _FORWARDS[key] = _jax_forward(jm, im, lmbs, monkeypatch)
    return _FORWARDS[key]


def _jax_forward(jm, im, lmbs, monkeypatch):
    drawn = []
    normal = jax.random.normal

    def record(*args, **kwargs):
        out = normal(*args, **kwargs)
        drawn.append(out)
        return out

    rng_noise = jax.random.split(jax.random.PRNGKey(0))[1]
    lmb = jnp.asarray(lmbs, jnp.float32)

    def run(params, x):
        del drawn[:]
        x_hat, lat = jm.net.apply({'params': params}, x, lmb, True, True,
                                  method=jm.net.forward_end2end,
                                  rngs={'noise': rng_noise})
        n = len(drawn)
        _, stats = jm.loss_and_stats(params, x, jax.random.PRNGKey(0),
                                     lmb=lmb)
        return lat, x_hat, stats, list(drawn[:n]), list(drawn[n:])

    monkeypatch.setattr(jax.random, 'normal', record)
    try:
        lat, x_hat, stats, d1, d2 = jax.device_get(
            jax.jit(run)(jm.params, jnp.asarray(im)))
    finally:
        monkeypatch.setattr(jax.random, 'normal', normal)
    for a, b in zip(d1, d2):          # the same key: the same draws
        assert np.array_equal(a, b)
    return lat, x_hat, stats, d1


def replay(monkeypatch, drawn, cycle=False):
    """entropy_coding.normal_noise returning the JAX draws in order (NHWC
    -> NCHW), from the start again after the last when `cycle`."""
    queue = [nchw(np.asarray(d)) for d in drawn]
    state = {'i': 0}

    def pop(like, generator=None):
        i = state['i']
        state['i'] += 1
        t = queue[i % len(queue)] if cycle else queue[i]
        assert tuple(t.shape) == tuple(like.shape)
        return t.to(like.dtype)
    monkeypatch.setattr(tec, 'normal_noise', pop)
    return state


@pytest.mark.parametrize('kind', ['smooth', 'nosmooth'])
def test_forward_on_jax_drawn_noise(models, image, kind, monkeypatch):
    jm, tm = models[kind]
    lat_w, xhat_w, want, drawn = jax_forward(jm, image, LMBS, monkeypatch)
    assert len(drawn) == tm.num_latents == 3
    state = replay(monkeypatch, drawn + drawn)
    lmb = tm._lmbs(LMBS, 2)
    with torch.no_grad():
        x_hat, lat = tm.net.forward_end2end(nchw(image), lmb, True, True)
        _, got = tm.loss_and_stats(nchw(image), lmb)
    assert state['i'] == 6
    for st_g, st_w in zip(lat, lat_w):
        close(nhwc(st_g['kl']), st_w['kl'], KL_ATOL, KL_RTOL)
        close(nhwc(st_g['z']), st_w['z'], X_ATOL, KL_RTOL)
    close(nhwc(x_hat), xhat_w, X_ATOL, 0)
    for k in ('loss', 'bppix', 'mse'):
        close(float(got[k]), float(want[k]), 0, STATS_RTOL)
    psnr = lambda m: -10 * math.log10(float(m))  # noqa: E731
    assert abs(psnr(got['mse_im']) - psnr(want['mse_im'])) <= PSNR_DB
    # the companding is what the variants differ by
    assert any(isinstance(b, trd.LatentVariableBlock)
               and b.use_linear_sqrt == (kind == 'smooth')
               for b in tm.net.dec_blocks)


def test_forward_noise_follows_the_seed(models, image):
    _, tm = models['smooth']
    a = tm.forward(image, lmb=64.0)
    assert a == tm.forward(image, lmb=64.0)
    assert a != tm.forward(image, lmb=64.0, seed=1)
    g = torch.Generator().manual_seed(0)
    assert a == tm.forward(image, lmb=64.0, generator=g)


def _jax_sample(jm, lmb, latents, bhw, t):
    """JAX's forward_sampling, jitted (None latents are empty pytrees)."""
    lmb_arr = jnp.full((bhw[0],), lmb, jnp.float32)
    fn = jax.jit(lambda p, lm, lat: jm.net.apply(
        {'params': p}, lm, lat, bhw, t, method=jm.net.forward_sampling,
        rngs={'sample': jax.random.PRNGKey(0)}))
    return np.asarray(fn(jm.params, lmb_arr, latents))


@pytest.mark.parametrize('kind', ['smooth', 'nosmooth'])
def test_forward_sampling_matches_jax(models, image, kind, monkeypatch):
    jm, tm = models[kind]
    lat_w, _, _, _ = jax_forward(jm, image, LMBS, monkeypatch)
    latents = [np.asarray(st['z']) for st in lat_w]
    want = _jax_sample(jm, 512.0, [jnp.asarray(z) for z in latents],
                       (2, 1, 1), 1.0)
    with torch.no_grad():
        got = tm.net.forward_sampling(
            tm._lmbs(512.0, 2), [nchw(z) for z in latents], (2, 1, 1))
    close(nhwc(got), want, X_ATOL, 0)
    # through the handle: clip(x, -1, 1) * 0.5 + 0.5 of the same
    rec = tm.conditional_sample(512.0, latents)
    close(rec, np.clip(want, -1, 1) * 0.5 + 0.5, X_ATOL, 0)
    # t = 0: the prior means, whatever the noise
    for bhw in [(2, 1, 1), (1, 2, 3)]:
        want = _jax_sample(jm, 64.0, [None] * 3, bhw, 0.0)
        got = tm.unconditional_sample(64.0, bhw, t=0.0)
        close(got, np.clip(want, -1, 1) * 0.5 + 0.5, X_ATOL, 0)
        assert got.shape == (bhw[0], 64 * bhw[1], 64 * bhw[2], 3)


def test_unconditional_sample_repeats_and_study_writes_pngs(models,
                                                           tmp_path):
    _, tm = models['smooth']
    a = tm.unconditional_sample(512.0, (2, 1, 1), seed=3)
    assert np.array_equal(a, tm.unconditional_sample(512.0, (2, 1, 1),
                                                     seed=3))
    assert not np.array_equal(a, tm.unconditional_sample(512.0, (2, 1, 1)))
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
    tm.study(tmp_path)
    for k, hw in ((1, 64), (2, 128)):
        png = coding.read_png(tmp_path / f'samples_k{k}_hw{hw}.png')
        assert png.shape == (hw, 6 * hw, 3)


def test_self_evaluate_matches_jax(models, tmp_path, monkeypatch):
    jm, tm = models['smooth']
    shutil.copy(COLLIE, tmp_path)
    im = coding.read_png(COLLIE).astype(np.float32)[None] / 255.0
    _, _, _, drawn = jax_forward(jm, im, [64.0], monkeypatch)
    want = jm.self_evaluate(str(tmp_path), steps=2)
    p = 3.0
    grid = (np.linspace(4 ** (1 / p), 2048 ** (1 / p), 2) ** p).tolist()
    state = replay(monkeypatch, drawn, cycle=True)
    got = tm.self_evaluate(tmp_path, steps=2)
    assert state['i'] == 2 * len(drawn)
    assert got['lambda'] == want['lambda'] == grid
    for k in ('loss', 'bpp'):
        close(got[k], want[k], 0, STATS_RTOL)
    assert np.abs(np.subtract(got['psnr'], want['psnr'])).max() <= PSNR_DB
    # a lmb_range and more steps: the same grid as JAX's
    lam = tm.self_evaluate(tmp_path, lmb_range=(16, 1024), steps=5)
    assert lam['lambda'] == jm.self_evaluate(
        str(tmp_path), lmb_range=(16, 1024), steps=5)['lambda']
