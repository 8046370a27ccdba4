"""The port's forward-pass eval against the JAX package's on the CPU: the
probability functions of models/entropy_coding.py, the training/eval
forward of qarv_tiny, qres_tiny and qres_tiny_lossless (stats and each
latent block's kl), its training branch on the noise the JAX package drew,
QarvModel.self_evaluate (with and without shape buckets, and its
channel-stats files), image_self_evaluate and video_fast_evaluate (the
latter two also with one stub model passed to both packages), on the same
random weights and seeded inputs.

Tolerances. The probability masses come from two normal CDFs through erf.
XLA's CPU erf is off by up to 2.4e-7 (it stops at +-0.9999998 beyond |x| ~
4), torch.erf by 6e-8, so a mass P differs between the packages by up to
P_ERR and -log P by up to P_ERR / P: each latent element's kl is held at
KL_ATOL plus that (capped at the 20.8 nats between the two clamps), and a
stat that sums kl at STATS_RTOL plus the sum of those slacks. Elements far
in a tail (P ~ 1e-7) need the slack: one of qarv_tiny's on a 128 x 128
image of uniform noise at lambda 512 is 1.386 nats apart (P 3.0e-8 in JAX,
1.2e-7 in the port). Where both packages' eval kl sit at the clamp
-log(1e-9) there is no slack, and the deep-tail tests hold the clamp and
the prob_clamp fallback themselves, where both CDFs round to 0 and erf
plays no part.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image
from scipy.ndimage import gaussian_filter

import lvae_tpu
import lvae_tpu.models.qarv.model
from lvae_tpu import evaluation as jeval
from lvae_tpu.models import entropy_coding as jec

import lvae_tpu_torch
from lvae_tpu_torch import evaluation as teval
from lvae_tpu_torch.models import entropy_coding as tec
from lvae_tpu_torch.models.weights import params_from_flax

P_ERR = 5e-7
KL_ATOL = 1e-4
KL_CAP = -math.log(1e-9) + 0.1
# the eval kl's largest value: -log of discrete_likelihood's bound, float32
KL_MAX = float(-np.log(np.float32(1e-9)))
STATS_RTOL = 1e-4
LOG2_E = math.log2(math.e)
SIZES = [(100, 90), (128, 128)]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redraw_prior(params, rng):
    """Each QRes prior's last conv at lecun-normal scale (flax
    zero-initialises it: pm = 0 and one scale everywhere)."""
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            fan_in = c4['kernel'].shape[2]
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(fan_in)).astype(np.float32)
    return params


@pytest.fixture(scope='module')
def models():
    out = {}
    for name in ('qarv_tiny', 'qres_tiny', 'qres_tiny_lossless'):
        jm = lvae_tpu.get_model(name)
        params = jax.device_get(jm.params)
        if name != 'qarv_tiny':
            params = _redraw_prior(params, np.random.default_rng(0))
            jm.params = jax.tree.map(jnp.asarray, params)
        tm = lvae_tpu_torch.get_model(name, device='cpu')
        tm.net.load_state_dict(params_from_flax(params), strict=True)
        out[name] = jm, tm
    return out


def jax_latents(jm, im, lmb=None):
    """JAX's per-block stats {'kl', 'z'} of the eval forward: what
    forward_get_latents returns, jitted (one compile a model and shape;
    forward_get_latents dispatches op by op)."""
    fn = getattr(jm, '_test_latents', None)
    if fn is None:
        key = {'noise': jax.random.PRNGKey(0)}
        if isinstance(jm.net, lvae_tpu.models.qarv.model
                      .VariableRateLossyVAENet):
            fn = jax.jit(lambda p, x, lmb: jm.net.apply(
                {'params': p}, x, lmb, False, True,
                method=jm.net.forward_end2end, rngs=key)[1])
        else:
            fn = jax.jit(lambda p, x, lmb: jm.net.apply(
                {'params': p}, x, False, True, method=jm.net.forward,
                rngs=key)[2])
        jm._test_latents = fn
    lmbs = jnp.asarray(np.broadcast_to(np.float32(0 if lmb is None else lmb),
                                       (im.shape[0],)))
    return jax.device_get(fn(jm.params, jnp.asarray(im), lmbs))


def _smooth(rng, h, w):
    im = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), sigma=(3, 3, 0))
    return (im - im.min()) / (im.max() - im.min() + 1e-9)


@pytest.fixture(scope='module')
def images():
    """Two smooth 128 x 128 images in [0, 1], float32 NHWC."""
    rng = np.random.default_rng(5)
    return np.stack([_smooth(rng, 128, 128) for _ in range(2)]).astype(
        np.float32)


@pytest.fixture(scope='module')
def img_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('fwd')
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray((_smooth(rng, h, w) * 255).astype(np.uint8)).save(
            d / f'fwd{i}.png')
    return d


def at_clamp(kl):
    return np.asarray(kl, np.float64) >= KL_MAX - 1e-5


def kl_slack(kl_jax, kl_port=None):
    """Per element: the mass's P_ERR through -log, capped. Given the port's
    eval kl too, none where both sit at the clamp -log(1e-9): there both
    packages' likelihood is the bound itself, and must be the same one."""
    slack = np.minimum(P_ERR * np.exp(np.asarray(kl_jax, np.float64)),
                       KL_CAP)
    if kl_port is not None:
        slack[at_clamp(kl_jax) & at_clamp(kl_port)] = 0.0
    return slack


def assert_kl_close(kl_port, kl_jax, clamped=True):
    """Each element at KL_ATOL plus its slack. clamped: the eval branch's
    kl (-log discrete_likelihood), which lies at or under KL_MAX and gets
    no slack where both packages sit at it; else the training branch's."""
    kl_port = np.asarray(kl_port, np.float64)
    kl_jax = np.asarray(kl_jax, np.float64)
    assert kl_port.shape == kl_jax.shape
    err = np.abs(kl_port - kl_jax)
    if clamped:
        assert kl_port.max() <= KL_MAX + 1e-5
        slack = kl_slack(kl_jax, kl_port)
    else:
        slack = kl_slack(kl_jax)
    assert (err <= KL_ATOL + slack).all(), err.max()


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().cpu().numpy()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# ---- the probability functions -----------------------------------------

def test_entropy_coding_functions_equal_jax():
    rng = np.random.default_rng(0)
    n = 20000
    mean = rng.normal(0, 3, n).astype(np.float32)
    scale = np.exp(rng.uniform(-3, 3, n)).astype(np.float32)
    x = (mean + rng.normal(0, 1, n) * scale * rng.uniform(0, 6, n)).astype(
        np.float32)
    for bin_size in (1.0, 1 / 127.5):
        for jf, tf, jcdf, tcdf in (
                (jec.gaussian_log_prob_mass, tec.gaussian_log_prob_mass,
                 jec._normal_cdf, tec._normal_cdf),
                (jec.laplace_log_prob_mass, tec.laplace_log_prob_mass,
                 jec._laplace_cdf, tec._laplace_cdf)):
            want = np.asarray(jf(mean, scale, x, bin_size), np.float64)
            got = tf(mean, scale, x, bin_size).numpy().astype(np.float64)
            assert np.isfinite(got).all()
            # each side's mass: the branch it took; a mass within P_ERR of
            # the clamp 1e-6 may fall on either side of it
            masses = [np.asarray(cdf((x + 0.5 * bin_size - mean) / scale)
                                 - cdf((x - 0.5 * bin_size - mean) / scale),
                                 np.float64)
                      for cdf in (jcdf, lambda v: tcdf(torch.from_numpy(
                          np.asarray(v))).numpy())]
            same = (masses[0] > 1e-6) == (masses[1] > 1e-6)
            assert np.abs(masses[0] - masses[1]).max() <= P_ERR
            assert (np.abs(masses[0][~same] - 1e-6) <= P_ERR).all()
            # there: the outputs' masses at 1e-6, the logs at 1e-6 plus the
            # masses' erf error through the log
            assert np.abs(np.exp(got) - np.exp(want))[same].max() <= 1e-6
            err = np.abs(got - want)[same]
            assert (err <= 1e-6 + kl_slack(-want[same])).all()
    # _safe_log_prob_mass with the normal pieces and another clamp
    want = np.asarray(jec._safe_log_prob_mass(
        jec._normal_cdf, jec._normal_log_pdf, jnp.asarray(mean),
        jnp.asarray(scale), jnp.asarray(x), 0.5, 1e-3), np.float64)
    got = tec._safe_log_prob_mass(
        tec._normal_cdf, tec._normal_log_pdf, torch.from_numpy(mean),
        torch.from_numpy(scale), torch.from_numpy(x), 0.5, 1e-3).numpy()
    same = (np.exp(want) > 1e-3) == (np.exp(got) > 1e-3)
    assert (np.abs(got - want)[same]
            <= 1e-6 + kl_slack(-want[same])).all()
    qm = (x * 3).astype(np.float32)
    assert np.array_equal(tec.quantize_dequantize(
        torch.from_numpy(qm), torch.from_numpy(mean)).numpy(),
        np.asarray(jec.quantize_dequantize(qm, mean)))
    z = np.array(jec.quantize_dequantize(qm, mean))
    want = np.asarray(jec.discrete_likelihood(z, scale, mean, 0.11))
    got = tec.discrete_likelihood(torch.from_numpy(z),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(mean), 0.11).numpy()
    assert got.dtype == np.float32 and np.abs(got - want).max() <= 1e-6
    assert got.min() >= 1e-9


def _tail_inputs(n=4000, seed=1, scales=(8, 12)):
    """Means, scales and signed distances of 8 to 12 scales (or `scales`)."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 3, n).astype(np.float32)
    scale = np.exp(rng.uniform(-2, 3, n)).astype(np.float32)
    k = rng.uniform(*scales, n) * rng.choice([-1.0, 1.0], n)
    return mean, scale, k


def test_discrete_likelihood_is_the_bound_in_deep_tails():
    """A residual whose whole bin lies 8-12 scales out: both CDFs round to
    0 in float32 in either package, so the likelihood is the bound 1e-9
    itself (its kl KL_MAX), and a bound given explicitly is honoured."""
    mean, scale, k = _tail_inputs()
    bounded = np.maximum(scale, np.float32(0.11))
    z = (mean + np.sign(k) * (0.5 + np.abs(k) * bounded)).astype(np.float32)
    args = (z, scale, mean, 0.11)
    got = tec.discrete_likelihood(*map(torch.from_numpy, args[:3]),
                                  0.11).numpy()
    want = np.asarray(jec.discrete_likelihood(*args))
    assert got.dtype == np.float32
    assert (got == np.float32(1e-9)).all() and (want == got).all()
    assert (-np.log(got) == np.float32(KL_MAX)).all()
    got = tec.discrete_likelihood(*map(torch.from_numpy, args[:3]), 0.11,
                                  likelihood_bound=1e-7).numpy()
    assert (got == np.float32(1e-7)).all()


def _normal_log_pdf64(x, mean, scale):
    z = (x - mean) / scale
    return -0.5 * z * z - np.log(scale) - 0.5 * math.log(2 * math.pi)


def _laplace_log_pdf64(x, mean, scale):
    return -np.abs(x - mean) / scale - np.log(2.0 * scale)


@pytest.mark.parametrize('bin_size', [1.0, 1 / 127.5])
@pytest.mark.parametrize('family', ['gaussian', 'laplace'])
def test_log_prob_mass_falls_back_below_prob_clamp(family, bin_size):
    """The port's log mass on its own masses M (float32, as it computes
    them): log M where M > 1e-6, the default prob_clamp, else log-pdf plus
    log(bin) (float64 here), each at 1e-6 relative; bins far out (8-12
    scales for the normal, 16-24 for the Laplace, whose mass there is <=
    0.5 exp(-16)) all take the fallback, and masses on both sides of the
    clamp occur."""
    tf, cdf, log_pdf, far = {
        'gaussian': (tec.gaussian_log_prob_mass, tec._normal_cdf,
                     _normal_log_pdf64, (8, 12)),
        'laplace': (tec.laplace_log_prob_mass, tec._laplace_cdf,
                    _laplace_log_pdf64, (16, 24))}[family]
    rng = np.random.default_rng(2)
    n = 20000
    mean = rng.normal(0, 3, n).astype(np.float32)
    scale = np.exp(rng.uniform(-3, 3, n)).astype(np.float32)
    x = mean + rng.normal(0, 1, n) * scale * rng.uniform(0, 6, n)
    t_mean, t_scale, k = _tail_inputs(scales=far)
    mean = np.concatenate([mean, t_mean])
    scale = np.concatenate([scale, t_scale])
    # the bin's nearer edge that far out
    x = np.concatenate([x, t_mean + np.sign(k) * (
        0.5 * bin_size + np.abs(k) * t_scale)]).astype(np.float32)
    tail = np.arange(x.size) >= n
    got = tf(mean, scale, x, bin_size).numpy().astype(np.float64)
    tm, ts, tx = map(torch.from_numpy, (mean, scale, x))
    mass = (cdf((tx + 0.5 * bin_size - tm) / ts)
            - cdf((tx - 0.5 * bin_size - tm) / ts)).numpy().astype(np.float64)
    fallback = mass <= 1e-6
    assert fallback[tail].all()
    assert ((mass > 1e-6) & (mass < 1e-5)).any()
    assert ((mass > 1e-8) & (mass <= 1e-6)).any()
    x64, m64, s64 = (a.astype(np.float64) for a in (x, mean, scale))
    want = np.where(fallback,
                    log_pdf(x64, m64, s64) + math.log(bin_size),
                    np.log(np.maximum(mass, 1e-8)))
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)


# ---- the forward --------------------------------------------------------

def _port_forward(name, tm, im, lmb, **kw):
    x = nchw(im)
    with torch.no_grad():
        if name == 'qarv_tiny':
            return tm.net.forward_end2end(x, tm._lmbs(lmb, x.shape[0]), **kw)
        return tm.net.forward(x, **kw)[1:]


def _stats_close(got, want, slack_nats, C=3):
    """STATS_RTOL, plus the kl slack (nats a dimension) where a stat sums
    kl: loss and kl directly, bppix times log2(e) * C."""
    assert set(got) == set(want)
    for k, w in want.items():
        extra = {'loss': slack_nats, 'kl': slack_nats,
                 'bppix': slack_nats * LOG2_E * C}.get(k, 0.0)
        assert abs(got[k] - w) <= STATS_RTOL * abs(w) + extra, (k, got[k], w)


@pytest.mark.parametrize('name,lmb', [
    ('qarv_tiny', 16.0), ('qarv_tiny', 2048.0), ('qarv_tiny', [16.0, 2048.0]),
    ('qres_tiny', None), ('qres_tiny_lossless', None)])
def test_forward_stats_and_block_kl_equal_jax(models, images, name, lmb):
    jm, tm = models[name]
    im = images
    kw = {} if lmb is None else {'lmb': lmb}
    rec = lmb != 2048.0             # the JAX reconstruction compiles once
    want = jm.forward(im, **kw, return_rec=rec)
    got = tm.forward(im, **kw, return_rec=rec)
    if rec:
        rec_w, rec_g = want.pop('im_hat'), got.pop('im_hat')
        assert rec_g.shape == im.shape
        assert np.abs(rec_g - rec_w).max() <= 1e-4
    lat_w = jax_latents(jm, im, lmb)
    _, lat_g = _port_forward(name, tm, im, lmb, get_latent=True) \
        if name == 'qarv_tiny' else \
        _port_forward(name, tm, im, lmb, get_latents=True)
    assert len(lat_g) == len(lat_w) > 0
    for st_g, st_w in zip(lat_g, lat_w):
        assert_kl_close(nhwc(st_g['kl']), st_w['kl'])
        assert np.abs(nhwc(st_g['z']) - st_w['z']).max() <= 1e-4
    slack = sum(kl_slack(st_w['kl'], nhwc(st_g['kl'])).sum()
                for st_g, st_w in zip(lat_g, lat_w)) / im.size
    _stats_close(got, want, slack)


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny'])
def test_training_branch_on_jax_drawn_noise(models, images, name,
                                            monkeypatch):
    """The JAX training forward's noise (jax.random.uniform, recorded as it
    is drawn, returned from the jitted forward) replayed through
    entropy_coding.uniform_noise: each block's z and kl, and
    loss_and_stats, agree."""
    jm, tm = models[name]
    im = images
    drawn = []
    uniform = jax.random.uniform

    def record(*args, **kwargs):
        out = uniform(*args, **kwargs)
        drawn.append(out)
        return out

    key = {'noise': jax.random.PRNGKey(3)}
    lmb = jnp.asarray([16.0, 2048.0])

    def run(params, x):
        del drawn[:]
        if name == 'qarv_tiny':
            _, lat = jm.net.apply({'params': params}, x, lmb, True, True,
                                  method=jm.net.forward_end2end, rngs=key)
            _, stats = jm.loss_and_stats(params, x, jax.random.PRNGKey(3),
                                         lmb=lmb)
        else:
            _, _, lat = jm.net.apply({'params': params}, x, True, True,
                                     method=jm.net.forward, rngs=key)
            _, stats = jm.loss_and_stats(params, x, jax.random.PRNGKey(3))
        return lat, stats, list(drawn)

    monkeypatch.setattr(jax.random, 'uniform', record)
    lat_w, want, drawn = jax.device_get(jax.jit(run)(jm.params,
                                                     jnp.asarray(im)))
    monkeypatch.setattr(jax.random, 'uniform', uniform)
    n = len(lat_w)
    assert len(drawn) == 2 * n
    replay = [torch.from_numpy(np.array(d)).permute(0, 3, 1, 2)
              for d in drawn]
    monkeypatch.setattr(tec, 'uniform_noise',
                        lambda like, generator=None: replay.pop(0))
    if name == 'qarv_tiny':
        _, lat_g = _port_forward(name, tm, im, [16.0, 2048.0],
                                 training=True, get_latent=True)
        _, got = tm.loss_and_stats(nchw(im), tm._lmbs([16.0, 2048.0], 2))
    else:
        _, lat_g = _port_forward(name, tm, im, None, training=True,
                                 get_latents=True)
        _, got = tm.loss_and_stats(nchw(im))
    assert not replay
    for st_g, st_w in zip(lat_g, lat_w):
        assert np.abs(nhwc(st_g['z']) - st_w['z']).max() <= 1e-4
        assert_kl_close(nhwc(st_g['kl']), st_w['kl'], clamped=False)
    slack = sum(kl_slack(st['kl']).sum() for st in lat_w) / im.size
    _stats_close({k: float(v.detach()) for k, v in got.items()},
                 {k: float(v) for k, v in want.items()}, slack)


def test_training_noise_follows_the_generator(models, images):
    _, tm = models['qarv_tiny']
    x = nchw(images)
    runs = []
    for seed in (0, 0, 1):
        g = torch.Generator().manual_seed(seed)
        loss, stats = tm.loss_and_stats(x, generator=g)
        runs.append(float(loss.detach()))
    assert runs[0] == runs[1] != runs[2]
    loss.backward()
    grads = [p.grad for p in tm.net.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    tm.net.zero_grad(set_to_none=True)


# ---- the forward-only sweeps -------------------------------------------

@pytest.mark.parametrize('shape_buckets', [0, 2])
def test_self_evaluate_equals_jax(models, img_dir, tmp_path, shape_buckets):
    jm, tm = models['qarv_tiny']
    out, logs = {}, {}
    for side, m in (('jax', jm), ('port', tm)):
        logs[side] = tmp_path / side
        out[side] = m.self_evaluate(img_dir, lmb_range=(16, 2048), steps=2,
                                    log_dir=logs[side],
                                    shape_buckets=shape_buckets)
    want, got = out['jax'], out['port']
    assert list(got) == list(want) == ['loss', 'bpp', 'psnr', 'lambda']
    assert got['lambda'] == want['lambda']
    # the slack: each package's per-element kl of the padded images
    from lvae_tpu.utils import coding as jcoding
    paths = sorted(img_dir.glob('*.png'))
    sizes = [Image.open(p).size[::-1] for p in paths]
    buckets = (jcoding.choose_shape_buckets(sizes, 64, shape_buckets)
               if shape_buckets else None)
    channel_slack = []          # per lambda: per block, bpp per channel
    for i, lmb in enumerate(want['lambda']):
        slack, per_block = 0.0, 0.0
        for path, (h, w) in zip(paths, sizes):
            ph, pw = (jcoding.bucket_for(h, w, buckets) if buckets
                      else (h + -h % 64, w + -w % 64))
            padded = np.asarray(jcoding.pad_to_shape(Image.open(path), ph,
                                                     pw), np.float32) / 255
            lat = [kl_slack(st_w['kl'], nhwc(st_g['kl'])) for st_w, st_g in
                   zip(jax_latents(jm, padded[None], lmb), _port_forward(
                       'qarv_tiny', tm, padded[None], lmb,
                       get_latent=True)[1])]
            slack += sum(sl.sum() for sl in lat) / (3 * h * w) / len(paths)
            per_block = per_block + np.asarray([
                sl.sum((0, 1, 2)) * LOG2_E / (ph * pw) / len(paths)
                for sl in lat], dtype=object)
        channel_slack.append(list(per_block))
        assert abs(got['bpp'][i] - want['bpp'][i]) <= (
            STATS_RTOL * want['bpp'][i] + slack * LOG2_E * 3)
        assert abs(got['loss'][i] - want['loss'][i]) <= (
            STATS_RTOL * want['loss'][i] + slack)
        assert abs(got['psnr'][i] - want['psnr'][i]) <= (
            STATS_RTOL * want['psnr'][i])
    names = sorted(p.name for p in logs['jax'].iterdir())
    assert sorted(p.name for p in logs['port'].iterdir()) == names == [
        'all_lmb_channel_stats.txt', 'channel-bppix-lmb16.txt',
        'channel-bppix-lmb2048.txt']
    sections = {'all_lmb_channel_stats.txt': channel_slack,
                'channel-bppix-lmb16.txt': channel_slack[:1],
                'channel-bppix-lmb2048.txt': channel_slack[1:]}
    for name, slacks in sections.items():
        lines_w = (logs['jax'] / name).read_text().splitlines()
        lines_g = (logs['port'] / name).read_text().splitlines()
        assert len(lines_g) == len(lines_w)
        # each section: a line per block (its channels), then the blocks'
        # sums; the '%-7.4f ' fields equal to the printed digit plus the
        # slack of the tail elements in that channel
        tols = [t for per_block in slacks
                for t in per_block + [np.asarray([b.sum()
                                                  for b in per_block])]]
        numeric = [(lg, lw) for lg, lw in zip(lines_g, lines_w)
                   if lw[:1].isdigit()]
        assert len(numeric) == len(tols)
        for (lg, lw), tol in zip(numeric, tols):
            vw, vg = np.float64(lw.split()), np.float64(lg.split())
            assert vg.shape == vw.shape == tol.shape
            assert (np.abs(vg - vw) <= 1e-4 + 1e-7 + tol).all(), (name, lg,
                                                                 lw)
        assert [lg for lg in lines_g if not lg[:1].isdigit()] == [
            lw for lw in lines_w if not lw[:1].isdigit()]


class StubModel:
    """Records what each evaluation gives it: the same stub goes to both
    packages' loops."""

    max_stride = 64

    def __init__(self):
        self.seen = []

    def forward(self, im):
        a = np.asarray(im)
        self.seen.append(a)
        return {'mean': float(a.mean()), 'h': a.shape[1], 'flag': True,
                'name': 'not a number', 'w': float(a.shape[2])}

    def forward_eval(self, frames):
        a = [np.asarray(f) for f in frames]
        self.seen.append(a)
        return {'n': len(a), 'mean': float(np.mean([f.mean() for f in a])),
                'shape': a[0].shape}


def test_image_self_evaluate_equals_jax(models, img_dir):
    for name in ('qarv_tiny', 'qres_tiny'):
        jm, tm = models[name]
        want = jeval.image_self_evaluate(jm, str(img_dir), progress=False)
        got = teval.image_self_evaluate(tm, str(img_dir), progress=False)
        assert got.keys() == want.keys()
        for k, w in want.items():
            # the crop is 64 x 64 (100 x 90) and 128 x 128: the slack of a
            # tail element is not needed here
            assert abs(got[k] - w) <= STATS_RTOL * abs(w), (name, k)
    stubs = StubModel(), StubModel()
    want = jeval.image_self_evaluate(stubs[0], str(img_dir), progress=False)
    got = teval.image_self_evaluate(stubs[1], str(img_dir), progress=False)
    assert got == want and set(got) == {'mean', 'h', 'flag', 'w'}
    assert len(stubs[1].seen) == len(stubs[0].seen) == 2
    for a, b in zip(*(s.seen for s in stubs)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_video_fast_evaluate_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    for s, n in (('seq_a', 3), ('seq_b', 2)):
        (tmp_path / s).mkdir()
        for f in range(n):
            Image.fromarray(rng.integers(0, 256, (70, 130, 3), np.uint8)
                            ).save(tmp_path / s / f'f{f:03d}.png')
    (tmp_path / 'notes.txt').write_text('not a sequence')
    for max_frames in (None, 2):
        stubs = StubModel(), StubModel()
        want = jeval.video_fast_evaluate(stubs[0], str(tmp_path), max_frames)
        got = teval.video_fast_evaluate(stubs[1], str(tmp_path), max_frames)
        assert got == want and set(got) == {'n', 'mean'}
        for a, b in zip(*(s.seen for s in stubs)):
            assert len(a) == len(b) and all(
                x.shape == (1, 64, 128, 3) and np.array_equal(x, y)
                for x, y in zip(a, b))
    with pytest.raises(FileNotFoundError):
        teval.video_fast_evaluate(StubModel(), str(tmp_path / 'none'))
