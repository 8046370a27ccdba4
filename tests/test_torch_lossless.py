"""The port's lossless QRes-VAE (qres_tiny_lossless at 64x64, N = 16)
against the JAX package: the two head kernels' plain versions against the
Pallas kernels in interpret mode, the head's CDF table, and the fused codec
on both trunks against the JAX fused codec on the same weights.

What "the same" means for the head. The JAX kernels' source computes
round(m * 127.5 + 127.5), / 127.5 and / bin_size as separate float32
operations, and so do the port's plain versions and its CUDA kernels. In
interpret mode on the CPU, XLA rewrites each division by a constant into a
multiplication by its reciprocal and fuses a * b + c into one FMA (its CPU
backend always allows FMA fusion), so the reference's pm differs from the
source's formula in the last bits, and its grid value where m * 127.5 +
127.5 lies within an ulp of a half-point. The plain version is therefore
held bitwise against the source's formula computed in numpy, and against
the Pallas kernel to the width of those roundings; its scale indexes differ
from the reference's only where the scale lies within a few ulps of a table
entry (XLA's exp and log differ from torch's in the last bits, and exp
turns one ulp of its argument into up to ~8 ulps). In the codec, the
head's symbols are pixel distances from round(m * 127.5 + 127.5), so a
mean that the two trunks compute within their float tolerance of a grid
half-point can land one grid value apart (as a posterior float near x.5
does for a latent symbol); the tests list each such symbol, and require
identical bodies, and an exact decode of the other package's file, where
there is none.

The weights: qres_tiny_lossless's flax init (seed 0), each prior's last conv
re-drawn at the lecun-normal scale (flax zero-initialises it). "default"
leaves the head as initialised: its scales lie beyond the table, so every
head index is the last. "spread" re-draws the head's conv_scale so that
the scales cover the table, and scales each posterior's last conv x300 so
that latent escapes occur; the random conv_mean then makes most pixel
symbols escape.
"""
import math
import pickle
import struct

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import lvae_tpu
import lvae_tpu_torch
from lvae_tpu.models import entropy_coding as jec
from lvae_tpu.models.qresvae import model as jqres
from lvae_tpu.models.qresvae import zoo as jzoo
from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.ops.pallas import trunk as ptk
from lvae_tpu_torch.models import entropy_coding as ec
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.ops import cdf, trunk

COLLIE = 'images/collie64.png'
N = 16
ESC_CAP = 1 << 15
BIN = 1 / 127.5
SHAPE = (2, 64, 64, 3)
f32 = np.float32


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the two kernels' plain versions ----------------------------------------

def _nudge(x, k):
    """x moved by k[i] float32 ulps (k in a small range)."""
    x = x.copy()
    for s in range(1, int(np.abs(k).max()) + 1):
        up, dn = k >= s, k <= -s
        x[up] = np.nextafter(x[up], f32(np.inf))
        x[dn] = np.nextafter(x[dn], f32(-np.inf))
    return x


@pytest.fixture(scope='module')
def head_inputs():
    """(p_mean, p_scale_raw, table): means on the pixel grid's half-points
    (k + 0.5) / 127.5 - 1 moved by up to 3 ulps, a tenth of them in
    [-3, 3]; raw scales that put the head's scale on a random table entry,
    moved by up to 4 ulps, a twentieth of them far beyond either end."""
    rng = np.random.default_rng(0)
    n = int(np.prod(SHAPE))
    m = ((rng.integers(-3, 259, n) + 0.5) / 127.5 - 1).astype(f32)
    m = _nudge(m, rng.integers(-3, 4, n))
    out = rng.random(n) < 0.1
    m[out] = rng.uniform(-3, 3, int(out.sum())).astype(f32)
    table = cdf.lossless_head_scale_table().astype(f32)
    entry = table[rng.integers(0, 128, n)].astype(np.float64)
    r = (np.log(entry) + math.log(BIN)).astype(f32)   # softplus(r+16)-16 ~ r
    r = _nudge(r, rng.integers(-4, 5, n))
    ends = rng.random(n) < 0.05
    r[ends] = rng.choice([-12.0, -9.0, 0.0, 3.0], int(ends.sum())).astype(f32)
    return m.reshape(SHAPE), r.reshape(SHAPE), table


def _source_pm(m):
    """pm by the Pallas source's formula, each operation one IEEE float32
    rounding (numpy): the plain version's and the CUDA kernel's."""
    grid = np.round(m * f32(127.5) + f32(127.5))
    return (grid / f32(127.5) - f32(1.0)) / f32(BIN)


def test_nll_head_plain_matches_jax(head_inputs):
    m, r, table = head_inputs
    jpm, jidx = map(np.asarray, ptk.nll_head(
        jnp.asarray(m), jnp.asarray(r), jnp.asarray(table), BIN,
        interpret=True))
    pm, pv, idx = (a.numpy() for a in trunk.nll_scales_plain(
        torch.from_numpy(m), torch.from_numpy(r), torch.from_numpy(table),
        BIN))
    tpm, tidx = trunk.nll_head_plain(torch.from_numpy(m), torch.from_numpy(r),
                                     torch.from_numpy(table), BIN)
    assert np.array_equal(tpm.numpy(), pm) and np.array_equal(tidx, idx)
    assert pm.dtype == np.float32 and idx.dtype == np.int32
    assert np.array_equal(pm, _source_pm(m))
    # the grid values: equal except where m * 127.5 + 127.5 lies within the
    # two-rounding chain's error of a half-point (the reference fuses it)
    grid, jgrid = np.round(pm + 127.5), np.round(jpm + 127.5)
    exact = m.astype(np.float64) * 127.5 + 127.5
    to_half = np.abs(exact - (np.floor(exact) + 0.5))
    chain = (np.spacing(np.abs(m * f32(127.5)))
             + np.spacing(np.abs(exact).astype(f32)))
    differ = grid != jgrid
    print(f'grid values differing from the reference: {int(differ.sum())} '
          f'of {grid.size}, all within the chain error of a half-point')
    assert (to_half[differ] <= chain[differ]).all()
    # where the grid agrees, pm is (grid / 127.5 - 1) / bin either way, to
    # the roundings of the / 127.5 - 1 step (ulps of 1, times 127.5)
    assert np.abs(pm - jpm)[~differ].max() <= 4 * 127.5 * np.spacing(f32(1))
    # the scale indexes: a flip only at a table entry
    flip = idx != jidx
    ulps = (np.abs(pv[flip][:, None] - table[None])
            / np.spacing(table)[None]).min(1)
    print(f'index flips against the reference: {int(flip.sum())} of '
          f'{idx.size}, at scales {pv[flip][:5].tolist()}..., within '
          f'{ulps.max() if flip.any() else 0:g} ulps of a table entry')
    assert (ulps <= 16).all()
    assert len(np.unique(idx)) == 128                  # every entry reached


def test_nll_recon_plain_matches_jax(head_inputs):
    """Bitwise on the head's own means and on random means, symbols in
    [-300, 300] (many clipped)."""
    m, r, table = head_inputs
    jpm, _ = ptk.nll_head(jnp.asarray(m), jnp.asarray(r), jnp.asarray(table),
                          BIN, interpret=True)
    rng = np.random.default_rng(1)
    syms = rng.integers(-300, 301, SHAPE).astype(np.int32)
    for pm in (np.asarray(jpm),
               rng.uniform(-200, 200, SHAPE).astype(f32)):
        want = np.asarray(ptk.nll_recon(jnp.asarray(syms), jnp.asarray(pm),
                                        BIN, interpret=True))
        got = trunk.nll_recon_plain(torch.from_numpy(syms),
                                    torch.from_numpy(pm.copy()), BIN).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert got.min() == 0 and got.max() == 255


def test_head_cdf_table_matches_jax():
    """The head's scale table and quantized CDF table, byte for byte."""
    st = cdf.lossless_head_scale_table()
    assert np.array_equal(st, jcdf.lossless_head_scale_table())
    want = jec.DiscretizedConditional(jcdf.lossless_head_scale_table(),
                                      dist='gaussian')
    want.update()
    got = ec.DiscretizedGaussian(st).update()
    w = want._cdf_table
    for a, b in ((got.cdfs, w.cdfs), (got.cdf_lengths, w.cdf_lengths),
                 (got.offsets, w.offsets)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---- the fused codec against the JAX fused codec ----------------------------

def _weights(params, spread):
    """The module doc's weight settings on a copy of the flax tree."""
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.array, params)
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            fan_in = c4['kernel'].shape[2]
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(fan_in)).astype(f32)
            if spread:
                blk['posterior']['c4']['kernel'] *= 300
    if spread:
        conv = params['out_net']['conv_scale']['conv']
        conv['kernel'] *= 0.2
        conv['bias'] = rng.uniform(-7.0, -2.0, conv['bias'].shape).astype(f32)
    return params


@pytest.fixture(scope='module')
def models():
    """The JAX model (its fused codecs' payload assembly records the
    symbols and indexes it receives) and the port's, and the two weight
    settings as flax trees."""
    jm = lvae_tpu.get_model('qres_tiny_lossless')
    base = jax.device_get(jm.params)
    settings = {k: _weights(base, k == 'spread')
                for k in ('default', 'spread')}
    tm = lvae_tpu_torch.get_model('qres_tiny_lossless', device='cpu')
    return jm, tm, settings


def _use(jm, tm, params):
    jm.params = jax.tree.map(jnp.asarray, params)
    tm.net.load_state_dict(params_from_flax(params), strict=True)


def _jax_capture(jm, image, portable):
    jm.compress_mode(coder='fused', num_lanes=N, portable=portable,
                     esc_cap=ESC_CAP)
    codec = jm._fused
    if not hasattr(codec, 'captured'):
        codec.captured = []
        orig = codec.pack_payload

        def spy(syms_flat, idx_flat):
            jax.debug.callback(
                lambda *a: codec.captured.append([np.asarray(x) for x in a]),
                *syms_flat, *idx_flat)
            return orig(syms_flat, idx_flat)
        codec.pack_payload = spy
    obj = jm.compress(image, portable=portable)
    arrs = codec.captured[-1]
    nb = len(arrs) // 2
    return obj, arrs[:nb], arrs[nb:]


def _port_capture(tm, image, portable):
    """The port's object, the symbols and indexes of each block its payload
    assembly received, the posterior floats (qm - pm) of the latent blocks'
    symbols and the head's raw means m (NHWC), flat."""
    tm.compress_mode(num_lanes=N, portable=portable, esc_cap=ESC_CAP)
    codec = tm._fused
    seen, qms, pms, means = [], [], [], []
    blocks = [b for b in tm.net.dec_blocks
              if getattr(b, 'is_latent_block', False)]

    def recorder(fn, out, pick=lambda r: r):
        return lambda *a: (lambda r: out.append(pick(r)) or r)(fn(*a))

    for blk in blocks:
        blk.posterior_qm = recorder(blk.posterior_qm, qms)
    codec._prior = recorder(codec._prior, pms, lambda r: r[1])
    orig = codec.pack_payload
    codec.pack_payload = lambda s, i: (seen.append(
        ([x.numpy().copy() for x in s], [x.numpy().copy() for x in i]))
        or orig(s, i))
    nll_head = trunk.nll_head
    trunk.nll_head = lambda m, *a: means.append(m) or nll_head(m, *a)
    hook = tm.net.out_net.conv_mean.register_forward_hook(
        lambda mod, args, out: means.append(out.permute(0, 2, 3, 1)))
    try:
        obj = tm.compress(image)
    finally:
        for blk in blocks:
            del blk.posterior_qm
        del codec._prior, codec.pack_payload
        trunk.nll_head = nll_head
        hook.remove()
    to_nhwc = (lambda t: t.permute(0, 2, 3, 1)) if not portable else (
        lambda t: t)
    posterior = torch.cat([
        (qm.permute(0, 2, 3, 1) - to_nhwc(pm)).reshape(-1)
        for qm, pm in zip(qms, pms)]).numpy()
    return (obj, seen[0][0], seen[0][1], posterior,
            means[0].reshape(-1).numpy())


def _head_flips(tsyms, jsyms, m):
    """Positions where the two packages' head symbols differ, each checked
    to be a grid rounding of the head's mean m within the trunk floats'
    tolerance (atol 1e-5 + rtol 1e-4 on m) of a half-point: the symbol is
    the pixel's distance from round(m * 127.5 + 127.5)."""
    flip = tsyms != jsyms
    v = m[flip].astype(np.float64) * 127.5 + 127.5
    to_half = np.abs(v - (np.floor(v) + 0.5))
    print(f'{int(flip.sum())} of {flip.size} head symbols differ from JAX, '
          f'at means {m[flip].tolist()} ({to_half.tolist()} from a '
          f'half-point of the grid)')
    assert (np.abs(tsyms[flip] - jsyms[flip]) == 1).all()
    assert (to_half <= 127.5 * (1e-5 + 1e-4 * np.abs(m[flip]))).all()
    return flip


@pytest.fixture(scope='module')
def image():
    return np.asarray(Image.open(COLLIE).convert('RGB'))


@pytest.mark.parametrize('setting', ['default', 'spread'])
@pytest.mark.parametrize('portable', [False, True])
def test_codec_matches_jax_and_round_trips(models, image, setting,
                                           portable):
    """Against the JAX fused codec on the same trunk: the same latent and
    head indexes; the same latent symbols except where the posterior float
    (a library convolution: XLA there, oneDNN here) lies within float error
    of x.5, and the same head symbols except where the head's mean lies
    within the trunk's float tolerance of a grid half-point, each such
    exception listed; with none, the bodies are identical. The port decodes
    its stream to the input's pixels exactly."""
    jm, tm, settings = models
    _use(jm, tm, settings[setting])
    im = image.astype(f32)[None] / 255.0
    jobj, jsyms, jidx = _jax_capture(jm, im, portable)
    tobj, tsyms, tidx, posterior, means = _port_capture(tm, im, portable)
    assert len(tsyms) == len(jsyms) == 4              # 3 latent + the head
    for a, b in zip(tidx, jidx):
        assert np.array_equal(a.reshape(-1), b.reshape(-1))
    head_idx = tidx[-1] - tm._fused.head_index_base
    print(f'{setting}: {len(np.unique(head_idx))} distinct head indexes')
    if setting == 'spread':
        assert len(np.unique(head_idx)) > 40
    else:
        assert (head_idx == 127).all()
    head_flip = _head_flips(tsyms[-1].reshape(-1), jsyms[-1].reshape(-1),
                            means)
    ts = np.concatenate([s.reshape(-1) for s in tsyms[:-1]])
    js = np.concatenate([s.reshape(-1) for s in jsyms[:-1]])
    assert np.array_equal(np.round(posterior), ts)
    flip = ts != js
    print(f'{setting}: {int(flip.sum())} of {ts.size} latent symbols differ '
          f'from JAX, at posterior floats {posterior[flip].tolist()}')
    ulp = np.spacing(np.abs(posterior[flip]).astype(f32))
    assert (np.abs(np.abs(posterior[flip] - ts[flip]) - 0.5) <= 8 * ulp).all()
    assert tobj[1] == jobj[1]
    if not (flip.any() or head_flip.any()):
        assert tobj[0] == jobj[0]
    n_esc = struct.unpack('<IIH', tobj[0][:10])[1]
    print(f'{setting}: {n_esc} escapes, {len(tobj[0])} bytes')
    if setting == 'spread':
        assert n_esc > 0
    dec = tm.decompress(tobj)
    assert dec.dtype == np.float32 and np.array_equal(dec, im)
    _, recon = tm.compress_check(im)
    assert np.array_equal(recon, im)
    assert tm.decompress_to_device(tobj[0], 1, 1).dtype == torch.uint8


@pytest.mark.parametrize('setting', ['default', 'spread'])
def test_compress_file_bytes_match_jax_and_cross_decode(models, image,
                                                        setting, tmp_path):
    """The port's portable file is byte-identical to the JAX package's, and
    each package decodes the other's file to the PNG's pixels exactly,
    except where a head symbol differs (test_codec_matches_jax_and_round_
    trips): there the bodies differ and the other package's decode is one
    grey level off at exactly those pixels."""
    jm, tm, settings = models
    _use(jm, tm, settings[setting])
    jm.compress_mode(coder='fused', num_lanes=N, esc_cap=ESC_CAP)
    tm.compress_mode(num_lanes=N, esc_cap=ESC_CAP)     # legacy mode
    jpath, tpath = tmp_path / 'jax.bits', tmp_path / 'port.bits'
    jm.compress_file(COLLIE, str(jpath))               # portable default
    tm.compress_file(COLLIE, tpath)
    obj = pickle.loads(tpath.read_bytes())
    assert obj[1:] == [(1, 1, 1, 16), (64, 64)]
    assert struct.unpack('<H', obj[0][8:10])[0] == 0x8000 | N
    want = image.astype(f32)[None] / 255.0
    assert np.array_equal(tm.decompress_file(tpath), want)
    _, jsyms, _ = _jax_capture(jm, want, True)
    _, tsyms, _, posterior, means = _port_capture(tm, want, True)
    assert all(np.array_equal(a, b) for a, b in zip(tsyms[:-1], jsyms[:-1]))
    flip = _head_flips(tsyms[-1].reshape(-1), jsyms[-1].reshape(-1), means)
    assert (tpath.read_bytes() == jpath.read_bytes()) == (not flip.any())
    for got in (tm.decompress_file(jpath), jm.decompress_file(str(tpath))):
        off = np.abs(got - want).reshape(-1) * 255
        assert np.array_equal(off > 0.5, flip)
        assert (np.abs(off[flip] - 1) < 1e-3).all()


def test_batch_bodies_equal_single_bodies(models, image):
    """On the portable trunk compress_batch (B = 2) writes each image's
    single-image body, and each batch stream decodes alone; on both trunks
    decompress_batch gives the pixels exactly, as encode_check_batch
    reconstructs them. (A legacy stream decodes at the batch size that
    wrote it: its library convolutions may choose their algorithm by it.)"""
    jm, tm, settings = models
    _use(jm, tm, settings['spread'])
    ims = np.stack([image, image[::-1, ::-1]]).astype(f32) / 255.0
    t = torch.from_numpy(ims).permute(0, 3, 1, 2).contiguous()
    for portable in (False, True):
        tm.compress_mode(num_lanes=N, portable=portable, esc_cap=ESC_CAP)
        objs = tm.compress_batch(ims)
        assert np.array_equal(tm.decompress_batch(objs), ims)
        bodies, recon = tm._fused.encode_check_batch(t)
        assert bodies == [o[0] for o in objs] and np.array_equal(recon, ims)
        if portable:
            assert [o[0] for o in objs] == [tm.compress(ims[b:b + 1])[0]
                                            for b in range(2)]
            for b, o in enumerate(objs):
                assert np.array_equal(tm.decompress(o)[0], ims[b])


def test_lossless_refusals():
    with pytest.raises(RuntimeError, match='pretrained'):
        lvae_tpu_torch.get_model('qres34m_lossless', pretrained=True,
                                 device='cpu')
    tm = lvae_tpu_torch.get_model('qres_tiny_lossless', device='cpu')
    from lvae_tpu_torch.models.qresvae import fused
    with pytest.raises(NotImplementedError, match='head_cdf_table'):
        fused.PortableQresCodec(tm.net, tm._coder.update(), num_lanes=N)


def test_weights_load_strict(models):
    """params_from_flax maps the JAX trees of qres_tiny_lossless (its
    initialised parameters) and qres34m_lossless (from jax.eval_shape)
    onto the port's models, strict, the head's out_net/conv_mean/conv and
    out_net/conv_scale/conv included."""
    jm, _, _ = models
    enc, dec, ch = jzoo._qres34m_blocks(lossless=True)
    from lvae_tpu.models import common as jcommon
    net = jqres.HierarchicalVAENet(
        enc_blocks=tuple(enc), dec_blocks=tuple(dec),
        out_net=jqres.GaussianNLLOutputNet(
            conv_mean=jcommon.patch_upsample(3, rate=4),
            conv_scale=jcommon.patch_upsample(3, rate=4)),
        im_shift=jzoo.IMAGENET_SHIFT, im_scale=jzoo.IMAGENET_SCALE,
        max_stride=64)
    shapes = jax.eval_shape(lambda: net.init(
        {'params': jax.random.PRNGKey(0)},
        jnp.zeros((1, 64, 64, 3), jnp.float32)))['params']
    big = jax.tree.map(lambda s: np.zeros(s.shape, f32), shapes)
    for tree, name in ((jax.device_get(jm.params), 'qres_tiny_lossless'),
                       (big, 'qres34m_lossless')):
        sd = params_from_flax(tree)
        tm = lvae_tpu_torch.get_model(name, device='cpu')
        assert set(sd) == set(tm.net.state_dict())
        assert {'out_net.conv_mean.conv.weight', 'out_net.conv_scale.conv.bias'
                } <= set(sd)
        tm.net.load_state_dict(sd, strict=True)
        n = sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))
        assert n == tm.num_params()
