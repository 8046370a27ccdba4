"""The port's host and device coders (compress_mode(coder='host' |
'device'), models/staged.py) end to end on qarv_tiny and qres_tiny (and,
through test_torch_host_codec_lossless.py, qres_tiny_lossless) at 64x64, against the JAX package's host and device
coders on the same random weights, and against the port's own legacy
fused codec.

The weights: the flax init (seed 0); qarv_tiny's posterior kernels x300,
qres's priors' last convs re-drawn at the lecun-normal scale (flax
zero-initialises them) and their posteriors' last convs x300, so that the
symbols are large and escapes occur. The lossless head keeps its init: its
scales lie beyond the head's table, so every head index is the last.

What "the same" means. The scale indexes must be identical. A symbol may
differ by one where the posterior float (a library convolution: XLA there,
oneDNN here) lies within float error of x.5 (ROADMAP.md C, "Rounding-
boundary symbols"), and a head symbol where the head's mean lies within the
trunk's float tolerance of a grid half-point (C, "Lossless grid rounding");
each such symbol is listed. The wire format is held byte for byte on the
JAX package's own symbols and indexes.
"""
import pickle
import struct

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import lvae_tpu
import lvae_tpu_torch
from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.utils import coding as jcoding
from lvae_tpu_torch.models import staged
from lvae_tpu_torch.ops import cdf as tcdf
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.utils import coding as tcoding

COLLIE = 'images/collie64.png'
LMB = 512.0
NAMES = ('qarv_tiny', 'qres_tiny')   # qres_tiny_lossless: its own file


def _scaled_posterior(tree, rng, qres):
    """The module doc's weights, on a flax tree of numpy leaves."""
    for name, blk in tree.items():
        if not (name.startswith('dec_blocks_') and 'posterior' in blk):
            continue
        if qres:
            c4 = blk['prior']['c4']
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(c4['kernel'].shape[2])).astype(
                                np.float32)
            post = blk['posterior']['c4']
        else:
            post = blk['posterior']
        post['kernel'] = np.asarray(post['kernel']) * 300
    return tree


class Models:
    """Both packages' models on the same weights, the port's coders'
    per-block inputs recorded."""

    def __init__(self, name):
        self.name = name
        self.qres = name.startswith('qres')
        self.lossless = name.endswith('lossless')
        self.jm = lvae_tpu.get_model(name)
        params = _scaled_posterior(jax.device_get(self.jm.params),
                                   np.random.default_rng(0), self.qres)
        self.jm.params = jax.tree.map(jnp.asarray, params)
        self.tm = lvae_tpu_torch.get_model(name, device='cpu')
        self.tm.net.load_state_dict(params_from_flax(params), strict=True)
        self.jcoders = ([self.jm._block_coder] if self.qres
                        else [self.jm._coder])
        self.tcoders = [self.tm._coder]
        if self.lossless:
            self.jcoders.append(self.jm._head_coder)
            self.tcoders.append(self.tm._head_coder)

    def kw(self):
        return {} if self.qres else {'lmb': LMB}

    def ctx(self):
        """The port's trunk context: the lambda for QARV."""
        return () if self.qres else (self.tm._lmb_tensor([LMB]),)

    def mode(self, m, coder):
        extra = {'esc_cap': 1 << 15} if coder == 'fused' else {}
        if coder == 'fused' and not self.qres:
            extra['num_lanes'] = 16
        m.compress_mode(coder=coder, **extra)


def _record(coders, method):
    """Record every call of `method` on the coders: -> list of (coder
    number, inputs, output); restore with the returned function."""
    calls = []
    for k, c in enumerate(coders):
        orig = getattr(c, method)

        def spy(*a, _k=k, _orig=orig):
            out = _orig(*a)
            calls.append((_k, [np.asarray(x).copy() for x in a
                               if not isinstance(x, bytes)], out))
            return out
        setattr(c, method, spy)
    return calls, lambda: [c.__dict__.pop(method) for c in coders]


def _compress(models, m, coders, im, coder):
    models.mode(m, coder)
    calls, restore = _record(coders, 'compress_symbols')
    try:
        obj = m.compress(im, **models.kw())
    finally:
        restore()
    return obj, calls


def _posterior_floats(models, im):
    """The port's posterior float minus prior mean of every latent symbol
    of its host compress, flat in the coded order (NHWC)."""
    tm = models.tm
    codec = tm._staged_codec()
    qms, pms = [], []
    blocks = [b for b in tm.net.dec_blocks
              if getattr(b, 'is_latent_block', False)]
    orig_prior = codec._prior
    for blk in blocks:
        orig = blk.posterior_qm
        blk.posterior_qm = (lambda *a, _o=orig: (lambda r: qms.append(r)
                                                 or r)(_o(*a)))
    codec._prior = lambda *a: (lambda r: pms.append(r[1]) or r)(
        orig_prior(*a))
    try:
        codec.encode_blocks(tm._to_input(im), *models.ctx())
    finally:
        for blk in blocks:
            del blk.posterior_qm
        del codec._prior
    return np.concatenate([(qm - pm).permute(0, 2, 3, 1).reshape(-1).numpy()
                           for qm, pm in zip(qms, pms)])


def _check_symbols(tcalls, jcalls, posterior):
    """Identical indexes; latent symbol flips only at posterior floats
    within float error of x.5, head symbol flips of one grid step."""
    assert [k for k, _, _ in tcalls] == [k for k, _, _ in jcalls]
    latent_t, latent_j, head_flips = [], [], 0
    for (k, (ts, ti), _), (_, (js, ji), _) in zip(tcalls, jcalls):
        assert np.array_equal(ti.reshape(-1), ji.reshape(-1))
        if k == 0:
            latent_t.append(ts.reshape(-1))
            latent_j.append(js.reshape(-1))
        else:
            flip = ts.reshape(-1) != js.reshape(-1)
            assert (np.abs(ts.reshape(-1) - js.reshape(-1))[flip] == 1).all()
            head_flips += int(flip.sum())
    ts, js = np.concatenate(latent_t), np.concatenate(latent_j)
    assert np.array_equal(np.round(posterior), ts)
    flip = ts != js
    ulp = np.spacing(np.abs(posterior[flip]).astype(np.float32))
    print(f'{int(flip.sum())} of {ts.size} latent symbols and {head_flips} '
          f'head symbols differ from JAX; posterior floats '
          f'{posterior[flip].tolist()}')
    assert (np.abs(np.abs(posterior[flip] - ts[flip]) - 0.5) <= 8 * ulp).all()
    return int(flip.sum()) + head_flips


@pytest.fixture(scope='module', params=NAMES)
def models(request):
    return Models(request.param)


@pytest.fixture(scope='module')
def image():
    """Random 8-bit pixels (the lossless head codes the 8-bit grid)."""
    return np.random.default_rng(3).integers(
        0, 256, (1, 64, 64, 3)).astype(np.float32) / 255


def _recon_equal(a, b, lossless):
    if lossless:       # the host coder returns the pixels as floats
        return np.array_equal(np.round(a * 255), np.round(b * 255))
    return np.array_equal(a, b)


@pytest.mark.parametrize('coder', ['host', 'device'])
def test_roundtrip_exact_and_equal_to_legacy_fused(models, image, coder):
    tm = models.tm
    if coder == 'device' and models.lossless:
        with pytest.raises(AssertionError, match='no lossless head'):
            tm.compress_mode(coder='device')
        with pytest.raises(AssertionError, match='no lossless head'):
            models.jm.compress_mode(coder='device')
        return
    models.mode(tm, 'fused')
    _, legacy = tm.compress_check(image, **models.kw(), portable=False)
    models.mode(tm, coder)
    obj, recon = tm.compress_check(image, **models.kw())
    assert obj == tm.compress(image, **models.kw())        # deterministic
    dec = tm.decompress(obj)
    assert dec.dtype == np.float32 and dec.shape == (1, 64, 64, 3)
    assert np.array_equal(dec, recon)
    assert _recon_equal(dec, legacy, models.lossless)
    if models.lossless:
        assert np.array_equal(np.round(dec * 255), np.round(image * 255))
    if coder == 'device':
        payload = obj[0] if models.qres else obj[10:]
        n_words, n_esc, lanes = struct.unpack('<IIH', payload[:10])
        assert lanes == 128 and n_esc > 0
        assert len(payload) > 10 + 4 * 128 + 2 * n_words
        # the escapes' positions run across the blocks: they fall in more
        # than one, and decode patched them block by block
        syms = tm._staged_codec().encode_blocks(tm._to_input(image),
                                                *models.ctx())[0]
        pos = staged.parse_interleaved(payload, 128)[2]
        hit = np.searchsorted(np.cumsum([s.shape[1] for s in syms]),
                              pos[pos >= 0], side='right')
        assert pos[pos >= 0].size == n_esc and np.unique(hit).size >= 2


def test_symbols_and_indexes_match_jax(models, image):
    tobj, tcalls = _compress(models, models.tm, models.tcoders, image,
                             'host')
    jobj, jcalls = _compress(models, models.jm, models.jcoders, image,
                             'host')
    flips = _check_symbols(tcalls, jcalls, _posterior_floats(models, image))
    if models.qres:
        assert tobj[-2 if models.lossless else -1] == \
            jobj[-2 if models.lossless else -1]
    else:
        assert tobj[:10] == jobj[:10]
    if not flips:
        assert tobj == jobj


def test_wire_bytes_from_jax_symbols_equal_jax(models, image):
    """The port's host stream and device payload assembled from the JAX
    package's own per-block symbols and indexes are its bytes."""
    jm, tm = models.jm, models.tm
    models.mode(tm, 'host')                 # builds the port's coders
    jobj, jcalls = _compress(models, jm, models.jcoders, image, 'host')
    strings = [tm_c.compress_symbols(s, ix) for (k, (s, ix), _), tm_c in
               zip(jcalls, [models.tcoders[k] for k, _, _ in jcalls])]
    assert strings == [out for _, _, out in jcalls]
    latent = [(s.reshape(-1), ix.reshape(-1))
              for k, (s, ix), _ in jcalls if k == 0]
    if models.qres:
        want = [[s] for s in strings[:len(latent)]]
        assert jobj[:len(latent)] == want
    else:
        assert jobj[10:] == jcoding.pack_byte_strings(strings)
        assert jobj[10:] == tcoding.pack_byte_strings([
            tm._coder.compress_symbols(s, ix) for s, ix in latent])
    if models.lossless:
        return
    jdev, _ = _compress(models, jm, models.jcoders, image, 'device')
    payload = staged.interleaved_payload(
        [s for s, _ in latent], [ix for _, ix in latent],
        tm._coder.cdf_table, 128)
    assert payload == (jdev[0] if models.qres else jdev[10:])


def test_host_files_decode_across_packages(models, tmp_path, monkeypatch):
    """A host-coded file written by either package decodes in the other to
    the writer's symbols. The lossless head's indexes are computed on the
    host from exp(plogv), whose float32 differs between the packages in the
    last bits (ROADMAP.md C, "Lossless grid rounding"): a head index may
    differ by one row where plogv lies within the trunk floats' tolerance
    (atol 1e-5 + rtol 1e-4) of the log of the table entry between them,
    and then that image's head string desynchronises
    from there on (C, "Host-coded lossless files across packages"), so its
    symbols are compared only where no head index differs."""
    jm, tm = models.jm, models.tm
    jpath, tpath = str(tmp_path / 'jax.bits'), tmp_path / 'port.bits'
    kw = models.kw()
    for m in (jm, tm):
        models.mode(m, 'host')
    jcalls, restore = _record(models.jcoders, 'compress_symbols')
    jm.compress_file(COLLIE, jpath, **kw)
    restore()
    tcalls, restore = _record(models.tcoders, 'compress_symbols')
    tm.compress_file(COLLIE, tpath, **kw)
    restore()
    if models.qres:
        tobj = pickle.loads(tpath.read_bytes())
        assert tobj[-1] == (64, 64)
        assert all(type(v) is int for v in tobj[-2 - models.lossless])
    table = tcdf.lossless_head_scale_table()
    for writer, reader, path, coders, cdf_module in (
            (jcalls, tm, jpath, models.tcoders, tcdf),
            (tcalls, jm, tpath, models.jcoders, jcdf)):
        scales = []
        lookup = cdf_module.build_indexes_np
        with monkeypatch.context() as mp:
            mp.setattr(cdf_module, 'build_indexes_np', lambda s, t: (
                scales.append(np.asarray(s)) or lookup(s, t)))
            got, restore = _record(coders, 'decompress_symbols')
            try:
                rec = reader.decompress_file(str(path))
            finally:
                restore()
        assert rec.shape == (1, 64, 64, 3)
        assert [k for k, _, _ in got] == [k for k, _, _ in writer]
        for (k, (ix,), out), (_, (s, wix), _) in zip(got, writer):
            ix, wix = ix.reshape(-1), wix.reshape(-1)
            if k == 1:
                flip = ix != wix
                scale = scales[-1].reshape(-1)[flip]
                edge = table[np.minimum(ix, wix)[flip]]
                print(f'{int(flip.sum())} of {ix.size} head indexes differ '
                      f'from the writer\'s, at scales {scale.tolist()}')
                assert (np.abs(ix - wix)[flip] == 1).all()
                # plogv within the trunk floats' tolerance of the entry
                plogv = np.log(scale.astype(np.float64))
                assert (np.abs(plogv - np.log(edge))
                        <= 1e-5 + 1e-4 * np.abs(plogv)).all()
                if flip.any():
                    continue
            else:
                assert np.array_equal(ix, wix)
            assert np.array_equal(np.asarray(out).reshape(-1), s.reshape(-1))
    assert np.abs(tm.decompress_file(tpath)
                  - jm.decompress_file(jpath)).max() < 1e-3


def test_entry_points_of_the_fused_coder_refuse_the_staged(models, image):
    tm = models.tm
    models.mode(tm, 'host')
    with pytest.raises(ValueError, match='coder="fused"'):
        tm.compress_batch(np.concatenate([image, image]))
    with pytest.raises(ValueError, match='coder'):
        tm.compress_mode(coder='cpu')
