"""The port's batch serving (compress_batch / decompress_batch) on qarv_tiny
at 64x64 against the JAX package's, on the legacy and the portable trunk:
three seeded images at lambda 64 / 512 / 2048 with num_lanes='auto' (one
lane count for the batch: 128), the posterior kernels scaled x300 so that
escapes occur (the tests/test_torch_codec.py fixture). On the CPU the
multi-image rANS kernels run through their plain versions (the JAX ones in
interpret mode).
"""
import struct

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
import lvae_tpu_torch
from lvae_tpu_torch.models.weights import params_from_flax

LMBS = [64.0, 512.0, 2048.0]


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
def images():
    return np.random.default_rng(5).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)


def _lmb_tensor(lmbs):
    return torch.tensor([struct.unpack('f', struct.pack('f', v))[0]
                         for v in lmbs])


def _nchw(ims):
    return torch.from_numpy(ims).permute(0, 3, 1, 2).contiguous()


def _jax_batch(jm, images, portable):
    """The JAX compress_batch streams and the (B, total) symbols and
    indexes its batch payload assembly received."""
    jm.compress_mode(coder='fused', num_lanes='auto', portable=portable)
    codec = jm._get_fused(128)
    captured = []
    orig = codec.pack_payload_batch

    def spy(syms_flat, idx_flat):
        jax.debug.callback(
            lambda *a: captured.append([np.asarray(x) for x in a]),
            *syms_flat, *idx_flat)
        return orig(syms_flat, idx_flat)

    codec.pack_payload_batch = spy
    try:
        bodies = jm.compress_batch(images, lmb=LMBS)
    finally:
        codec.pack_payload_batch = orig
    arrs = captured[-1]
    nb = len(arrs) // 2
    return (bodies, np.concatenate(arrs[:nb], 1),
            np.concatenate(arrs[nb:], 1))


def _port_batch(tm, images, portable):
    """The port's compress_batch streams, the per-block (B, nsym) symbols
    and indexes its batch payload assembly received, and the posterior
    floats (qm - pm) the symbols were rounded from, (B, total)."""
    tm.compress_mode(num_lanes='auto', portable=portable)
    codec = tm._get_fused(128)
    seen, qms, pms = [], [], []
    blocks = [b for b in tm.net.dec_blocks
              if getattr(b, 'is_latent_block', False)]

    def recorder(fn, out, pick=lambda r: r):
        return lambda *a: (lambda r: out.append(pick(r)) or r)(fn(*a))

    for blk in blocks:
        blk.posterior_qm = recorder(blk.posterior_qm, qms)
    codec._prior = recorder(codec._prior, pms, lambda r: r[1])
    orig = codec.pack_payload_batch
    codec.pack_payload_batch = lambda s, i: (seen.append(
        ([x.numpy().copy() for x in s], [x.numpy().copy() for x in i]))
        or orig(s, i))
    try:
        bodies = tm.compress_batch(images, lmb=LMBS)
    finally:
        for blk in blocks:
            del blk.posterior_qm
        del codec._prior, codec.pack_payload_batch
    B = images.shape[0]
    posterior = torch.cat([
        (qm.permute(0, 2, 3, 1) - codec._to(pm, 'NHWC')).reshape(B, -1)
        for qm, pm in zip(qms, pms)], 1).numpy()
    return codec, bodies, seen[0][0], seen[0][1], posterior


@pytest.mark.parametrize('portable', [False, True])
def test_batch_matches_jax_and_round_trips(models, images, portable):
    """Against the JAX compress_batch: the same scale indexes, and the same
    symbols except where the posterior float (a library convolution: XLA
    in JAX, oneDNN here) lies within float error of a rounding boundary,
    where the two round it to neighbours; with the port's symbols, the JAX
    batch payload assembly gives the port's bodies byte for byte (and with
    no flip, the bodies equal the JAX compress_batch's). decompress_batch
    equals encode_check_batch's reconstruction bitwise; each stream is a
    single-image stream."""
    jm, tm = models
    jbodies, jsyms, jidx = _jax_batch(jm, images, portable)
    codec, bodies, syms, idx, posterior = _port_batch(tm, images, portable)
    tsyms, tidx = np.concatenate(syms, 1), np.concatenate(idx, 1)
    assert tsyms.shape == jsyms.shape and tsyms.shape[0] == 3
    assert np.array_equal(tidx, jidx)
    assert np.array_equal(np.round(posterior), tsyms)
    flip = tsyms != jsyms
    print(f'portable={portable}: {int(flip.sum())} of {tsyms.size} symbols '
          f'differ, at posterior floats {posterior[flip].tolist()}')
    assert np.abs(tsyms - jsyms).max() <= 1 and flip.mean() <= 0.02
    ulp = np.spacing(np.abs(posterior[flip]).astype(np.float32))
    assert (np.abs(np.abs(posterior[flip] - tsyms[flip]) - 0.5)
            <= 8 * ulp).all()
    jcodec = jm._get_fused(128)
    jpayload = jcodec.pack_payload_batch([jnp.asarray(s) for s in syms],
                                         [jnp.asarray(i) for i in idx])
    assert [b[10:] for b in bodies] == jcodec._payloads_to_bytes(
        jpayload, (64, 64, 3))
    if not flip.any():
        assert bodies == jbodies
    marker = 0x8000 if portable else 0
    for body, lmb in zip(bodies, LMBS):
        assert body[:10] == struct.pack('f', lmb) + struct.pack('3H', 1, 1, 1)
        n_words, n_esc, lanes_field = struct.unpack('<IIH', body[10:20])
        assert lanes_field == marker | 128 and n_esc > 0
        st, words, pos, val = codec.parse_payload(body[10:])
        assert words.size == n_words and pos.size == n_esc
    bodies2, recon = codec.encode_check_batch(_nchw(images),
                                              _lmb_tensor(LMBS))
    assert [b[10:] for b in bodies] == bodies2
    dec = tm.decompress_batch(bodies)
    assert dec.dtype == np.float32 and dec.shape == (3, 64, 64, 3)
    assert np.array_equal(dec, recon)


def test_portable_streams_decode_across_batch_sizes(models, images):
    """A batch stream decodes bitwise through single decompress; single
    streams decode bitwise through one decompress_batch; the JAX package's
    decompress reads the port's batch streams (atol 1e-3, the two trunks'
    float tolerance)."""
    jm, tm = models
    tm.compress_mode(num_lanes='auto', portable=True)
    bodies = tm.compress_batch(images, lmb=LMBS)
    dec = tm.decompress_batch(bodies)
    for b, body in enumerate(bodies):
        assert np.array_equal(tm.decompress(body)[0], dec[b])
    singles = [tm.compress(images[b:b + 1], lmb=2048.0) for b in range(3)]
    alone = np.concatenate([tm.decompress(s) for s in singles])
    assert np.array_equal(tm.decompress_batch(singles), alone)
    jm.compress_mode(coder='fused', num_lanes='auto', portable=True)
    for b, body in enumerate(bodies):
        np.testing.assert_allclose(jm.decompress(body)[0], dec[b], atol=1e-3)


def test_chunked_batch(models, images):
    """max_program_batch splits a request into balanced chunks (cases of
    tests/test_batch_codec.py); B = 3 at cap 2 runs as [2, 1], and its
    streams round-trip against the same chunks' reconstruction."""
    _, tm = models
    tm.compress_mode(num_lanes='auto', portable=True, max_program_batch=2)
    codec = tm._get_fused(128)
    assert codec.max_program_batch == 2
    cases = {(3, 2): [2, 1], (8, 4): [4, 4], (7, 4): [4, 3], (2, 2): [2],
             (5, 6): [5], (6, None): [6], (6, 4): [3, 3]}
    for (B, cap), want in cases.items():
        assert codec._chunk_sizes(B, cap) == want
    calls = []
    orig = codec._encode
    codec._encode = lambda im, *a, **k: calls.append(im.shape[0]) or orig(
        im, *a, **k)
    try:
        bodies = tm.compress_batch(images, lmb=LMBS)
    finally:
        codec._encode = orig
    assert calls == [2, 1]
    bodies2, recon = codec.encode_check_batch(_nchw(images),
                                              _lmb_tensor(LMBS))
    assert [b[10:] for b in bodies] == bodies2
    assert np.array_equal(tm.decompress_batch(bodies), recon)


def test_pipelined_async_loop_gives_the_same_bytes(models, images):
    """The serving loop of bench.py:444-466: dispatch batch k+1 before
    finishing batch k; every batch's streams equal compress_batch's."""
    _, tm = models
    tm.compress_mode(num_lanes='auto', portable=True)
    want = tm.compress_batch(images, lmb=LMBS)
    got = []
    h = tm.compress_batch_async(images, lmb=LMBS)
    for _ in range(2):
        h_next = tm.compress_batch_async(images, lmb=LMBS)
        got.append(tm.compress_batch_finish(h))
        h = h_next
    got.append(tm.compress_batch_finish(h))
    assert got == [want] * 3


def test_batch_refusals(models, images):
    """Mixed shapes, lane counts or trunk kinds, and a lambda count that
    is not the batch's, raise ValueError; B = 1 is a batch too."""
    _, tm = models
    tm.compress_mode(num_lanes='auto', portable=True)
    small = tm.compress_batch(images[:1], lmb=[2048.0])
    assert len(small) == 1
    tall = tm.compress_batch(np.concatenate([images[:1]] * 2, axis=1),
                             lmb=[2048.0])
    with pytest.raises(ValueError, match='one image shape'):
        tm.decompress_batch(small + tall)
    low = tm.compress(images[:1], lmb=64.0)             # 32 lanes
    with pytest.raises(ValueError, match='mixed lane counts'):
        tm.decompress_batch(small + [low])
    legacy = tm.compress(images[:1], lmb=2048.0, portable=False)
    with pytest.raises(ValueError, match='mixed lane counts / trunk kinds'):
        tm.decompress_batch(small + [legacy])
    with pytest.raises(ValueError, match='2 lambdas for 3 images'):
        tm.compress_batch(images, lmb=[64.0, 512.0])
