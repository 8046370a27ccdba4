"""The port's fused codec end to end on qarv_tiny at 64x64, on the legacy and
the portable trunk, against the JAX package's fused codec of the same kind
on the same random weights (the JAX portable trunk's Pallas kernels run in
interpret mode, the port's trunk functions through their plain versions).

The posterior kernels are scaled x300 so that escapes occur (untrained tiny
models otherwise code ~zero symbols).
"""
import struct

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.utils import coding as jcoding
from PIL import Image

import lvae_tpu_torch
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.utils import coding as tcoding

COLLIE = 'images/collie64.png'


def _scale_posterior(tree, factor=300.0):
    return {k: (_scale_posterior(v, factor) if k != 'posterior'
                else {kk: vv * factor if kk == 'kernel' else vv
                      for kk, vv in v.items()})
            if isinstance(v, dict) else v for k, v in tree.items()}


@pytest.fixture(scope='module')
def models():
    jm = lvae_tpu.get_model('qarv_tiny')
    params = _scale_posterior(jax.device_get(jm.params))
    jm.params = jax.tree.map(jnp.asarray, params)
    tm = lvae_tpu_torch.get_model('qarv_tiny', device='cpu')
    tm.net.load_state_dict(params_from_flax(params), strict=True)
    return jm, tm


@pytest.fixture(scope='module')
def image():
    return np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)


@pytest.mark.parametrize('num_lanes,lmb', [(16, 512.0), ('auto', 2048.0)])
def test_roundtrip_bit_exact(models, image, num_lanes, lmb):
    _, tm = models
    tm.compress_mode(num_lanes=num_lanes)
    bits, recon = tm.compress_check(image, lmb=lmb)
    n_words, n_esc, lanes = struct.unpack('<IIH', bits[10:20])
    assert n_esc > 0 and lanes == (16 if num_lanes == 16 else 128)
    assert tm.compress(image, lmb=lmb) == bits          # deterministic
    dec = tm.decompress(bits)
    assert dec.dtype == np.float32 and dec.shape == (1, 64, 64, 3)
    assert np.array_equal(dec, recon)
    assert np.isfinite(dec).all() and 0 <= dec.min() and dec.max() <= 1


def _jax_symbols(jm, image, lmb, num_lanes, portable=False):
    """The JAX fused codec's stream plus the symbols and indexes its
    payload assembly received (captured with a debug callback)."""
    jm.compress_mode(coder='fused', num_lanes=num_lanes, portable=portable)
    codec = jm._fused
    captured = []
    orig = codec.pack_payload

    def spy(syms_flat, idx_flat):
        jax.debug.callback(
            lambda *a: captured.append([np.asarray(x) for x in a]),
            *syms_flat, *idx_flat)
        return orig(syms_flat, idx_flat)

    codec.pack_payload = spy
    bits = jm.compress(image, lmb=lmb, portable=portable)
    codec.pack_payload = orig
    arrs = captured[-1]
    nb = len(arrs) // 2
    return bits, codec, np.concatenate(arrs[:nb]), np.concatenate(arrs[nb:])


def test_symbols_match_jax_codec(models, image):
    jm, tm = models
    lmb, N = 512.0, 16
    jbits, jcodec, jsyms, jidx = _jax_symbols(jm, image, lmb, N)
    tm.compress_mode(num_lanes=N)
    codec = tm._fused
    seen = []
    orig = codec.pack_payload
    codec.pack_payload = lambda s, i: (seen.append(
        (torch.cat(s).numpy().copy(), torch.cat(i).numpy().copy()))
        or orig(s, i))
    try:
        tbits = tm.compress(image, lmb=lmb)
    finally:
        codec.pack_payload = orig
    tsyms, tidx = seen[0]
    sym_agree, idx_agree = (tsyms == jsyms).mean(), (tidx == jidx).mean()
    print(f'symbols: {int((tsyms != jsyms).sum())} of {tsyms.size} differ; '
          f'indexes: {int((tidx != jidx).sum())} differ')
    assert sym_agree >= 0.999 and idx_agree >= 0.999
    assert tbits[:10] == jbits[:10]                     # lambda + shape
    if sym_agree == 1.0 and idx_agree == 1.0:
        assert tbits == jbits                           # same wire bytes
    # the JAX codec's parser accepts the port's body and reads what the
    # port's parser reads (the JAX buffers cut to the stream's lengths)
    body = tbits[10:]
    n_words, n_esc = struct.unpack('<II', body[:8])
    jst, jpk, jpos, jval = jcodec.parse_payload(body)
    pk = np.asarray(jpk).view(np.uint32)
    jwords = np.stack([pk & 0xFFFF, pk >> 16], 1).reshape(-1)[:n_words]
    st, words, pos, val = codec.parse_payload(body)
    assert np.array_equal(np.asarray(jst), st)
    assert np.array_equal(jwords, words)
    assert np.array_equal(np.asarray(jpos)[:n_esc], pos)
    assert np.array_equal(np.asarray(jval)[:n_esc], val)


def test_compress_file_roundtrip(models, tmp_path):
    _, tm = models
    tm.compress_mode(num_lanes='auto')
    path = tmp_path / 'collie.bits'
    tm.compress_file(COLLIE, path, lmb=256.0)
    data = path.read_bytes()
    assert data[:4] == struct.pack('2H', 64, 64)
    lmb, = struct.unpack('f', data[4:8])
    assert lmb == 256.0 and struct.unpack('3H', data[8:14]) == (1, 1, 1)
    lanes_field, = struct.unpack('<H', data[22:24])
    assert lanes_field == 0x8000 | 32            # portable by default
    dec = tm.decompress_file(path)
    assert dec.shape == (1, 64, 64, 3)
    img = np.asarray(Image.open(COLLIE).convert('RGB'), np.float32) / 255.0
    _, recon = tm.compress_check(img[None], lmb=256.0, portable=True)
    assert np.array_equal(dec, recon)


def test_compress_file_pads_and_crops_like_the_reference(models, tmp_path):
    """A 50x60 photo is edge-padded to 64x64 exactly as the JAX package
    pads it, coded, and cropped back on decode."""
    _, tm = models
    tm.compress_mode(num_lanes=16)
    small = Image.open(COLLIE).convert('RGB').crop((0, 0, 60, 50))
    png = tmp_path / 'small.png'
    small.save(png)
    padded = np.asarray(jcoding.pad_divisible_by(small, 64))
    assert np.array_equal(padded, tcoding.pad_divisible_by(
        np.asarray(small), 64))
    bits = tmp_path / 'small.bits'
    tm.compress_file(png, bits, lmb=1024.0)
    assert bits.read_bytes()[:4] == struct.pack('2H', 50, 60)
    dec = tm.decompress_file(bits)
    assert dec.shape == (1, 50, 60, 3)
    _, recon = tm.compress_check(padded[None] / np.float32(255), lmb=1024.0,
                                 portable=True)
    assert np.array_equal(dec, recon[:, :50, :60])


def test_overflows_and_refusals(models, image):
    _, tm = models
    tm.compress_mode(num_lanes=16, esc_cap=8)
    with pytest.raises(OverflowError, match='escapes exceed'):
        tm.compress(image, lmb=512.0)
    tm.compress_mode(num_lanes=16, word_cap=8)
    with pytest.raises(OverflowError, match='coded words exceed'):
        tm.compress(image, lmb=512.0)
    tm.compress_mode(num_lanes=16)
    bits = bytearray(tm.compress(image, lmb=512.0))
    bits[19] |= 0x80                                    # portable marker
    with pytest.raises(ValueError, match=r'stream trunk kind \(portable\)'):
        tm._fused.parse_payload(bytes(bits[10:]))
    # 'host' and 'device' are coders too; an unknown coder is refused
    with pytest.raises(ValueError, match='coder'):
        tm.compress_mode(coder='cpu')


# ---- the portable trunk ----------------------------------------------------

@pytest.mark.parametrize('num_lanes,lmb', [(16, 512.0), ('auto', 2048.0)])
def test_portable_roundtrip_bit_exact(models, image, num_lanes, lmb):
    _, tm = models
    tm.compress_mode(num_lanes=num_lanes, portable=True)
    bits, recon = tm.compress_check(image, lmb=lmb)
    n_words, n_esc, lanes_field = struct.unpack('<IIH', bits[10:20])
    assert n_esc > 0 and lanes_field & 0x8000
    assert lanes_field & 0x7FFF == (16 if num_lanes == 16 else 128)
    assert tm.compress(image, lmb=lmb) == bits          # deterministic
    dec = tm.decompress(bits)
    assert dec.shape == (1, 64, 64, 3) and np.array_equal(dec, recon)
    assert np.isfinite(dec).all() and 0 <= dec.min() and dec.max() <= 1


def test_portable_symbols_and_bytes_match_jax_codec(models, image):
    """Symbols, scale indexes and wire bytes equal the JAX CPU portable
    codec's, and the JAX parser reads the port's portable container."""
    jm, tm = models
    lmb, N = 512.0, 16
    jbits, jcodec, jsyms, jidx = _jax_symbols(jm, image, lmb, N,
                                              portable=True)
    tm.compress_mode(num_lanes=N, portable=True)
    codec = tm._fused
    seen = []
    orig = codec.pack_payload
    codec.pack_payload = lambda s, i: (seen.append(
        (torch.cat(s).numpy().copy(), torch.cat(i).numpy().copy()))
        or orig(s, i))
    try:
        tbits = tm.compress(image, lmb=lmb)
    finally:
        codec.pack_payload = orig
    tsyms, tidx = seen[0]
    print(f'portable: {int((tsyms != jsyms).sum())} of {tsyms.size} symbols '
          f'and {int((tidx != jidx).sum())} indexes differ')
    assert np.array_equal(tsyms, jsyms) and np.array_equal(tidx, jidx)
    assert tbits == jbits                               # same wire bytes
    body = tbits[10:]
    n_words, n_esc, lanes_field = struct.unpack('<IIH', body[:10])
    assert lanes_field == 0x8000 | N and n_esc > 0
    jst, jpk, jpos, jval = jcodec.parse_payload(body)
    pk = np.asarray(jpk).view(np.uint32)
    jwords = np.stack([pk & 0xFFFF, pk >> 16], 1).reshape(-1)[:n_words]
    st, words, pos, val = codec.parse_payload(body)
    assert np.array_equal(np.asarray(jst), st)
    assert np.array_equal(jwords, words)
    assert np.array_equal(np.asarray(jpos)[:n_esc], pos)
    assert np.array_equal(np.asarray(jval)[:n_esc], val)
    # and the JAX portable codec decodes the port's stream to the pixels
    # the port decodes, within the float tolerance of the two trunks
    jdec = jm.decompress(tbits)
    np.testing.assert_allclose(tm.decompress(tbits), jdec, atol=1e-3)


def test_portable_legacy_firewall_and_routing(models, image):
    """A codec never parses the other trunk kind's stream; the model routes
    by the stream's marker bit, whatever compress_mode chose
    (tests/test_portable_trunk.py:155-174)."""
    _, tm = models
    tm.compress_mode(num_lanes=16)                      # legacy
    legacy_codec = tm._fused
    legacy, legacy_rec = tm.compress_check(image, lmb=512.0)
    tm.compress_mode(num_lanes=16, portable=True)
    portable_codec = tm._fused
    portable, portable_rec = tm.compress_check(image, lmb=512.0)
    assert legacy[10:20] != portable[10:20]
    with pytest.raises(ValueError, match=r'trunk kind \(legacy\) != codec '
                                         r'\(portable\)'):
        portable_codec.parse_payload(legacy[10:])
    with pytest.raises(ValueError, match=r'trunk kind \(portable\) != codec '
                                         r'\(legacy\)'):
        legacy_codec.parse_payload(portable[10:])
    # both kinds decode through either configured mode
    assert np.array_equal(tm.decompress(legacy), legacy_rec)
    assert np.array_equal(tm.decompress(portable), portable_rec)
    tm.compress_mode(num_lanes=16)
    assert np.array_equal(tm.decompress(portable), portable_rec)
    assert np.array_equal(tm.decompress(legacy), legacy_rec)
    # per-call override, and compress_mode leaves the other kind cached
    assert tm.compress(image, lmb=512.0, portable=True) == portable
    assert tm._fused is legacy_codec


def test_compress_file_portable_by_default(models, tmp_path):
    _, tm = models
    tm.compress_mode(num_lanes=16)                      # legacy mode
    img = np.asarray(Image.open(COLLIE).convert('RGB'), np.float32) / 255.0
    for portable, marker in ((None, 0x8000), (True, 0x8000), (False, 0)):
        path = tmp_path / f'collie_{portable}.bits'
        tm.compress_file(COLLIE, path, lmb=512.0, portable=portable)
        data = path.read_bytes()
        lanes_field, = struct.unpack('<H', data[22:24])
        assert lanes_field == marker | 16
        _, recon = tm.compress_check(img[None], lmb=512.0,
                                     portable=bool(marker))
        assert np.array_equal(tm.decompress_file(path), recon)


@pytest.mark.parametrize('portable', [False, True])
def test_codecs_leave_process_flags_alone(models, image, portable):
    """Either trunk scopes its precision policy to its own library calls:
    coding neither reads nor changes the process's TF32 / cuDNN flags."""
    _, tm = models
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    tm.compress_mode(num_lanes=16, portable=portable)
    want, want_rec = tm.compress_check(image, lmb=512.0)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.deterministic = False
        # another esc_cap: a codec built under these flags
        tm.compress_mode(num_lanes=16, portable=portable, esc_cap=4096)
        bits = tm.compress(image, lmb=512.0)
        rec = tm.decompress(bits)
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.benchmark,
                torch.backends.cudnn.deterministic) == (True, True, True,
                                                         False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
    assert bits == want and np.array_equal(rec, want_rec)


# ---- the entry points' contracts (lvae_tpu/models/qarv/model.py) ----------

@pytest.mark.parametrize('bad', [1.5, -0.25, np.nan])
def test_host_input_outside_unit_range_raises(models, image, bad):
    """Host (numpy) input outside [0, 1] is refused by compress and
    compress_batch, as the JAX _check_input refuses it; device tensors are
    not range-checked."""
    _, tm = models
    tm.compress_mode(num_lanes=16, portable=True)
    im = image.copy()
    im[0, 3, 5, 1] = bad
    with pytest.raises(ValueError, match=r'in \[0, 1\]'):
        tm.compress(im, lmb=512.0)
    with pytest.raises(ValueError, match=r'in \[0, 1\]'):
        tm.compress_batch(np.concatenate([image, im]), lmb=512.0)
    if not np.isnan(bad):
        assert tm.compress(torch.from_numpy(im), lmb=512.0)[:4] == \
            struct.pack('f', 512.0)


def test_decompress_to_device_takes_the_jax_form(models, image):
    """decompress_to_device(lmb, nB, nH, nW, body), the JAX package's form,
    gives the whole-stream form's image; nB != 1 raises."""
    _, tm = models
    tm.compress_mode(num_lanes='auto', portable=True)
    bits = tm.compress(image, lmb=1024.0)
    lmb, = struct.unpack('f', bits[:4])
    nB, nH, nW = struct.unpack('3H', bits[4:10])
    whole = tm.decompress_to_device(bits)
    parts = tm.decompress_to_device(lmb, nB, nH, nW, bits[10:])
    assert parts.shape == (1, 64, 64, 3) and torch.equal(parts, whole)
    with pytest.raises(ValueError, match='holds 2 images'):
        tm.decompress_to_device(lmb, 2, nH, nW, bits[10:])
    with pytest.raises(TypeError):
        tm.decompress_to_device(lmb, bits[10:])


@pytest.mark.parametrize('mode', ['L', 'P'])
def test_compress_file_gray_and_palette_png(models, tmp_path, mode):
    """A gray or palette PNG codes as its RGB conversion and round-trips."""
    _, tm = models
    tm.compress_mode(num_lanes=16)
    src = Image.open(COLLIE).convert(mode)
    png = tmp_path / f'collie_{mode}.png'
    src.save(png)
    bits = tmp_path / f'collie_{mode}.bits'
    tm.compress_file(png, bits, lmb=512.0)
    dec = tm.decompress_file(bits)
    rgb = np.asarray(src.convert('RGB'), np.float32) / 255.0
    _, recon = tm.compress_check(rgb[None], lmb=512.0, portable=True)
    assert dec.shape == (1, 64, 64, 3) and np.array_equal(dec, recon)
