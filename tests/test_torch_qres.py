"""The port's QRes-VAE codec end to end on qres_tiny at 64x64 against the JAX
package's fused QRes codec on the same random weights (the JAX portable
trunk's Pallas kernels in interpret mode, the port's trunk functions
through their plain versions).

The weights: qres_tiny's flax init (seed 0), each prior's last conv re-drawn
at the lecun-normal scale (flax zero-initialises it, so that the prior would
give one scale index everywhere) and each posterior's last conv scaled x300
so that the symbols are large and escapes occur.
"""
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
from lvae_tpu.models.qresvae import model as jqres
from lvae_tpu.models.qresvae import zoo as jzoo
from lvae_tpu_torch.models.weights import params_from_flax

COLLIE = 'images/collie64.png'
N = 16


def _redraw(params, rng):
    """Prior c4 at lecun-normal scale, posterior c4 x300 (module doc)."""
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            fan_in = c4['kernel'].shape[2]
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(fan_in)).astype(np.float32)
            post = blk['posterior']['c4']
            post['kernel'] = np.asarray(post['kernel']) * 300
    return params


@pytest.fixture(scope='module')
def models():
    jm = lvae_tpu.get_model('qres_tiny')
    params = _redraw(jax.device_get(jm.params), np.random.default_rng(0))
    jm.params = jax.tree.map(jnp.asarray, params)
    # the JAX portable codec's payload assembly records the symbols and
    # indexes it receives (a debug callback, traced into its one program)
    jm.compress_mode(coder='fused', num_lanes=N, portable=True)
    codec = jm._fused
    codec.captured = []
    orig = codec.pack_payload

    def spy(syms_flat, idx_flat):
        jax.debug.callback(
            lambda *a: codec.captured.append([np.asarray(x) for x in a]),
            *syms_flat, *idx_flat)
        return orig(syms_flat, idx_flat)

    codec.pack_payload = spy
    tm = lvae_tpu_torch.get_model('qres_tiny', device='cpu')
    tm.net.load_state_dict(params_from_flax(params), strict=True)
    return jm, tm


@pytest.fixture(scope='module')
def images():
    return np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)


@pytest.mark.parametrize('portable', [False, True])
def test_roundtrip_bit_exact(models, images, portable):
    _, tm = models
    tm.compress_mode(num_lanes=N, portable=portable)
    obj, recon = tm.compress_check(images[:1])
    body, shape = obj
    n_words, n_esc, lanes_field = struct.unpack('<IIH', body[:10])
    assert shape == (1, 1, 1, 16) and n_esc > 0
    assert lanes_field == N | (0x8000 if portable else 0)
    assert tm.compress(images[:1]) == obj                # deterministic
    dec = tm.decompress(obj)
    assert dec.dtype == np.float32 and dec.shape == (1, 64, 64, 3)
    assert np.array_equal(dec, recon)
    assert np.isfinite(dec).all() and 0 <= dec.min() and dec.max() <= 1


def _jax_capture(jm, image):
    """The JAX portable codec's object plus the symbols and indexes its
    payload assembly received."""
    jm.compress_mode(coder='fused', num_lanes=N, portable=True)
    obj = jm.compress(image, portable=True)
    arrs = jm._fused.captured[-1]
    nb = len(arrs) // 2
    return obj, np.concatenate(arrs[:nb]), np.concatenate(arrs[nb:])


def _port_capture(tm, image):
    """The port's portable object, the symbols and indexes its payload
    assembly received, and the posterior floats (qm - pm) the symbols were
    rounded from."""
    tm.compress_mode(num_lanes=N, portable=True)
    codec = tm._fused
    seen, qms, pms = [], [], []
    blocks = [b for b in tm.net.dec_blocks
              if getattr(b, 'is_latent_block', False)]

    def recorder(fn, out, pick=lambda r: r):
        return lambda *a: (lambda r: out.append(pick(r)) or r)(fn(*a))

    for blk in blocks:
        blk.posterior_qm = recorder(blk.posterior_qm, qms)
    codec._prior = recorder(codec._prior, pms, lambda r: r[1])
    orig = codec.pack_payload
    codec.pack_payload = lambda s, i: (seen.append(
        (torch.cat(s).numpy().copy(), torch.cat(i).numpy().copy()))
        or orig(s, i))
    try:
        obj = tm.compress(image)
    finally:
        for blk in blocks:
            del blk.posterior_qm
        del codec._prior, codec.pack_payload
    posterior = torch.cat([
        (qm.permute(0, 2, 3, 1) - pm).reshape(-1)
        for qm, pm in zip(qms, pms)]).numpy()
    return obj, seen[0][0], seen[0][1], posterior


def test_scaled_posterior_matches_jax(models, images):
    """Against the JAX portable codec: the same scale indexes, and the same
    symbols except where the posterior float (a library convolution: XLA in
    JAX, oneDNN here) lies within float error of x.5, where the two round
    to neighbours; each such exception is listed. With no exception the
    bodies are identical, and the JAX package decodes the port's stream to
    the port's pixels within the two trunks' float tolerance."""
    jm, tm = models
    for b in range(2):
        jobj, jsyms, jidx = _jax_capture(jm, images[b:b + 1])
        tobj, tsyms, tidx, posterior = _port_capture(tm, images[b:b + 1])
        assert np.array_equal(tidx, jidx)
        assert len(np.unique(tidx)) > 8                 # the table is used
        assert np.array_equal(np.round(posterior), tsyms)
        flip = tsyms != jsyms
        print(f'image {b}: {int(flip.sum())} of {tsyms.size} symbols differ '
              f'from JAX, at posterior floats {posterior[flip].tolist()} '
              f'(JAX {jsyms[flip].tolist()}, port {tsyms[flip].tolist()})')
        ulp = np.spacing(np.abs(posterior[flip]).astype(np.float32))
        assert np.abs(tsyms - jsyms).max() <= 1
        assert (np.abs(np.abs(posterior[flip] - tsyms[flip]) - 0.5)
                <= 8 * ulp).all()
        assert tobj[1] == jobj[1]
        if not flip.any():
            assert tobj[0] == jobj[0]
        np.testing.assert_allclose(jm.decompress(tobj), tm.decompress(tobj),
                                   atol=1e-3)


def test_compress_file_bytes_match_jax_and_cross_decode(models, tmp_path):
    """The port's portable file is byte-identical to the JAX package's
    (the same pickled container), and each package decodes the other's
    file: the port bitwise as its own, JAX within the trunks' tolerance."""
    jm, tm = models
    jm.compress_mode(coder='fused', num_lanes=N)
    tm.compress_mode(num_lanes=N)                        # legacy mode
    jpath, tpath = tmp_path / 'jax.bits', tmp_path / 'port.bits'
    jm.compress_file(COLLIE, str(jpath))                 # portable default
    tm.compress_file(COLLIE, tpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    obj = pickle.loads(tpath.read_bytes())
    assert obj[1:] == [(1, 1, 1, 16), (64, 64)]
    n_words, n_esc, lanes_field = struct.unpack('<IIH', obj[0][:10])
    assert lanes_field == 0x8000 | N and n_esc > 0
    dec = tm.decompress_file(jpath)
    assert dec.shape == (1, 64, 64, 3)
    img = np.asarray(Image.open(COLLIE).convert('RGB'), np.float32) / 255.0
    _, recon = tm.compress_check(img[None], portable=True)
    assert np.array_equal(dec, recon)
    np.testing.assert_allclose(jm.decompress_file(str(tpath)), dec,
                               atol=1e-3)


def test_container_refuses_code(models, tmp_path):
    """decompress_file reads lists, tuples, bytes and ints only."""
    _, tm = models
    tm.compress_mode(num_lanes=N)
    path = tmp_path / 'evil.bits'
    path.write_bytes(pickle.dumps([print, (1, 1, 1, 16), (64, 64)]))
    with pytest.raises(pickle.UnpicklingError, match='refused'):
        tm.decompress_file(path)


def test_batch_streams_decode_across_batch_sizes(models, images):
    """compress_batch (B = 2) decodes bitwise to encode_check_batch's
    reconstruction; a batch stream decodes alone and single streams as a
    batch, bitwise."""
    _, tm = models
    tm.compress_mode(num_lanes=N, portable=True)
    objs = tm.compress_batch(images)
    assert [o[1] for o in objs] == [(1, 1, 1, 16)] * 2
    dec = tm.decompress_batch(objs)
    ims = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    bodies, recon = tm._fused.encode_check_batch(ims)
    assert [o[0] for o in objs] == bodies
    assert dec.shape == (2, 64, 64, 3) and np.array_equal(dec, recon)
    for b, obj in enumerate(objs):
        assert np.array_equal(tm.decompress(obj)[0], dec[b])
    singles = [tm.compress(images[b:b + 1]) for b in range(2)]
    alone = np.concatenate([tm.decompress(s) for s in singles])
    assert np.array_equal(tm.decompress_batch(singles), alone)
    h = tm.compress_batch_async(images)
    assert tm.compress_batch_finish(h) == objs           # the async pair


def test_firewall_and_routing(models, images):
    """A codec never parses the other trunk kind's stream; decode routes by
    the stream's marker bit, whatever compress_mode chose."""
    _, tm = models
    tm.compress_mode(num_lanes=N)                        # legacy
    legacy_codec = tm._fused
    legacy, legacy_rec = tm.compress_check(images[:1])
    tm.compress_mode(num_lanes=N, portable=True)
    portable_codec = tm._fused
    portable, portable_rec = tm.compress_check(images[:1])
    with pytest.raises(ValueError, match=r'trunk kind \(legacy\) != codec '
                                         r'\(portable\)'):
        portable_codec.parse_payload(legacy[0])
    with pytest.raises(ValueError, match=r'trunk kind \(portable\) != codec '
                                         r'\(legacy\)'):
        legacy_codec.parse_payload(portable[0])
    for mode in (False, True):
        tm.compress_mode(num_lanes=N, portable=mode)
        assert np.array_equal(tm.decompress(legacy), legacy_rec)
        assert np.array_equal(tm.decompress(portable), portable_rec)
        img = tm.decompress_to_device(portable[0], 1, 1)
        assert img.dtype == torch.float16 and img.shape == (1, 64, 64, 3)
    with pytest.raises(ValueError, match='mixed lane counts'):
        tm.decompress_batch([legacy, portable])


def test_refusals(models, images):
    """What the QRes entry points refuse, as the JAX package does: host
    input outside [0, 1], a shape off the stride, an automatic lane count;
    an output head that is neither the MSE nor the lossless one, and
    pretrained=True."""
    _, tm = models
    tm.compress_mode(num_lanes=N, portable=True)
    bad = images[:1].copy()
    bad[0, 1, 2, 0] = 1.5
    with pytest.raises(ValueError, match=r'in \[0, 1\]'):
        tm.compress(bad)
    with pytest.raises(ValueError, match='divisible by 64'):
        tm.compress(images[:1, :48])
    with pytest.raises(ValueError, match='num_lanes'):
        tm.compress_mode(num_lanes='auto')
    net = tm.net
    out_net = net.out_net
    try:
        net.out_net = torch.nn.Identity()                # not the MSE head
        with pytest.raises(NotImplementedError, match='lossless'):
            tm.compress_mode(num_lanes=32, portable=True)
    finally:
        net.out_net = out_net
    with pytest.raises(RuntimeError, match='pretrained'):
        lvae_tpu_torch.get_model('qres34m', pretrained=True, device='cpu')


def test_qres34m_weights_load_strict():
    """params_from_flax maps the whole JAX qres34m tree (taken from
    jax.eval_shape, so nothing of the JAX model is initialised) onto the
    port's qres34m, strict: the same names and shapes, 34M parameters."""
    enc, dec, _ = jzoo._qres34m_blocks(lossless=False)
    net = jqres.HierarchicalVAENet(
        enc_blocks=tuple(enc), dec_blocks=tuple(dec),
        out_net=jqres.MSEOutputNet(mse_lmb=32.0),
        im_shift=jzoo.IMAGENET_SHIFT, im_scale=jzoo.IMAGENET_SCALE,
        max_stride=64)
    shapes = jax.eval_shape(lambda: net.init(
        {'params': jax.random.PRNGKey(0)},
        jnp.zeros((1, 64, 64, 3), jnp.float32)))['params']
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = params_from_flax(tree)
    tm = lvae_tpu_torch.get_model('qres34m', device='cpu')
    assert set(sd) == set(tm.net.state_dict())
    tm.net.load_state_dict(sd, strict=True)
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n == tm.num_params() and 33e6 < n < 35e6


def test_load_weights_reads_a_jax_weight_file(models, tmp_path):
    """load_weights (what the zoo's pretrained=<path> calls) reads the JAX
    package's flax msgpack file of the QRes tree into the state that
    params_from_flax gives."""
    jm, tm = models
    path = tmp_path / 'qres_tiny.msgpack'
    jm.save_weights(path)
    fresh = lvae_tpu_torch.get_model('qres_tiny', device='cpu')
    fresh.load_weights(path)
    want, got = tm.net.state_dict(), fresh.net.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
