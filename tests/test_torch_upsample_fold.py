"""upsample_finish and upsample_head (lvae_tpu_torch/ops/trunk.py): the
synthesis tail's last 1x1 conv with the pixel shuffle and finish, and the
lossless head's two 1x1 convs with their shuffles, each one launch on the
card. On the CPU their wrappers run the plain versions, which are held here

- against the JAX chains they fold, Pallas in interpret mode: conv1x1 ->
  pixel_shuffle -> finish_image for the tail
  (lvae_tpu/models/qarv/fused.py:178-191; the float16 images within one
  float16 ulp of [0.5, 1), 2^-11: XLA:CPU and ATen sum the product in
  different orders), two conv1x1 -> pixel_shuffle for the head
  (lvae_tpu/models/qresvae/fused.py:116-122; atol 1e-5, rtol 1e-4);
- bitwise against the port's own chain of plain functions, the calls the
  portable codec made before the fold (dense or conv1x1, pixel_shuffle_nhwc
  and finish_image), and through the codec: qarv_tiny and
  qres_tiny_lossless streams and reconstructions equal those of the
  codec's former tail and head.

Rates 2 and 4, B = 1 and 2, W = 19 (no multiple of any tile width); tiny
widths. Also the portable codec's refusal of a tail (or a head) that does
not end in a patch_upsample to 3 channels.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lvae_tpu.models import common as jcommon
from lvae_tpu.ops.pallas import trunk as jtrunk

import lvae_tpu_torch
from lvae_tpu_torch.models import common as tcommon
from lvae_tpu_torch.models.fused_base import PortableTrunk
from lvae_tpu_torch.models.qresvae.fused import PortableQresCodec
from lvae_tpu_torch.ops import trunk
from lvae_tpu_torch.ops.trunk import pixel_shuffle_nhwc

# (B, H, W, rate): JAX's finish_image needs (rH * rW * 3) % 128 == 0
CASES = [(1, 8, 19, 4), (2, 8, 19, 4), (1, 32, 19, 2), (2, 32, 19, 2)]
C = 16
HALF_ULP = 2.0 ** -11


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv(rng, rate, scale):
    """A 1x1 conv C -> 3 rate^2 in the JAX layout: (w (C, N), b (N,))."""
    N = 3 * rate * rate
    return ((rng.normal(size=(C, N)) * scale).astype(np.float32),
            (rng.normal(size=N) * 0.1).astype(np.float32))


def _jax_conv_shuffle(x, w, b, rate):
    y = jtrunk.conv1x1(jnp.asarray(x), {'kernel': w.reshape(1, 1, C, -1),
                                        'bias': b}, interpret=True)
    return jcommon.pixel_shuffle(y, rate)


def _port_conv_shuffle(x, w, b, rate):
    """The portable codec's patch_upsample before the fold: dense on the
    (B, HW, C) rows, then pixel_shuffle_nhwc(...).contiguous()."""
    B, H, W, _ = x.shape
    y = trunk.dense(x.reshape(B, H * W, C), w, b).reshape(B, H, W, -1)
    return pixel_shuffle_nhwc(y, rate).contiguous()


@pytest.mark.parametrize('B,H,W,rate', CASES)
def test_upsample_finish_plain_matches_jax_and_port_chain(B, H, W, rate):
    rng = np.random.default_rng(B * 10 + rate)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w, b = _conv(rng, rate, 0.6)
    want = np.asarray(jtrunk.finish_image(
        _jax_conv_shuffle(x, w, b, rate), interpret=True))
    launches = trunk.upsample_finish.launches
    got = trunk.upsample_finish(_t(x), _t(w), _t(b), rate)
    assert trunk.upsample_finish.launches == launches   # the plain path
    assert got.dtype == torch.float16 and got.is_contiguous()
    assert got.shape == (B, rate * H, rate * W, 3) == want.shape
    d = np.abs(got.numpy().astype(np.float32) - want.astype(np.float32))
    assert d.max() <= HALF_ULP
    # clipped values on both sides, so that the clamp is exercised
    assert (got == 0).any() and (got == 1).any()
    chain = trunk.finish_image(_port_conv_shuffle(_t(x), _t(w), _t(b), rate))
    assert torch.equal(got.view(torch.int16), chain.view(torch.int16))
    assert torch.equal(trunk.upsample_finish_plain(_t(x), _t(w), _t(b), rate),
                       got)


@pytest.mark.parametrize('B,H,W,rate', CASES)
def test_upsample_head_plain_matches_jax_and_port_chain(B, H, W, rate):
    rng = np.random.default_rng(B * 10 + rate + 100)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    (wm, bm), (ws, bs) = _conv(rng, rate, 0.25), _conv(rng, rate, 0.25)
    launches = trunk.upsample_head.launches
    got = trunk.upsample_head(_t(x), _t(wm), _t(bm), _t(ws), _t(bs), rate)
    assert trunk.upsample_head.launches == launches
    for g, (w, b) in zip(got, ((wm, bm), (ws, bs))):
        want = np.asarray(_jax_conv_shuffle(x, w, b, rate))
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert g.shape == (B, rate * H, rate * W, 3) == want.shape
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=1e-4)
        chain = _port_conv_shuffle(_t(x), _t(w), _t(b), rate)
        assert torch.equal(g.view(torch.int32), chain.view(torch.int32))


def test_adapters_equal_the_codecs_former_calls():
    """patch_upsample_finish and head_upsample on nn.Modules (weights as
    `.t()` views of the conv weights) give the bits of the codec's former
    tail and head calls: conv1x1 + pixel_shuffle_nhwc (+ finish_image)."""
    torch.manual_seed(0)
    x = torch.randn(2, 8, 19, C)
    up = tcommon.patch_upsample(C, 3, rate=4)
    head = [tcommon.patch_upsample(C, 3, rate=4) for _ in range(2)]
    with torch.no_grad():
        got = trunk.patch_upsample_finish(x, up)
        want = trunk.finish_image(pixel_shuffle_nhwc(
            trunk.conv1x1(x, up.conv), up.rate).contiguous())
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        got = trunk.head_upsample(x, *head)
        for g, u in zip(got, head):
            want = pixel_shuffle_nhwc(trunk.conv1x1(x, u.conv),
                                      u.rate).contiguous()
            assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def _former_tail(self, feature, tctx):
    """PortableTrunk's tail before the fold: every block through _plain,
    then finish_image."""
    for blk in list(self.net.dec_blocks)[self.tail_start:]:
        feature = self._plain(blk, feature, *tctx)
    return trunk.finish_image(feature)


def _former_head(self, feature):
    """PortableQresCodec's head before the fold: two conv1x1 and shuffle
    copies, then nll_head."""
    onet = self.net.out_net
    m, r = (pixel_shuffle_nhwc(trunk.conv1x1(feature, up.conv),
                               up.rate).contiguous()
            for up in (onet.conv_mean, onet.conv_scale))
    return trunk.nll_head(m, r, self.head_table, onet.bin_size)


def _round_trip(model, im, **kw):
    model._fused_codecs.clear()
    obj, recon = model.compress_check(im, **kw)
    return obj, recon, model.decompress(obj)


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny_lossless'])
def test_portable_codec_bits_equal_the_former_tail_and_head(name,
                                                            monkeypatch):
    """A portable round trip through the folded tail (qarv_tiny) or head
    (qres_tiny_lossless) gives the stream and the reconstruction that the
    codec's former calls give, bit for bit."""
    torch.manual_seed(1)
    model = lvae_tpu_torch.get_model(name, device='cpu')
    kw = {'lmb': 512.0} if name == 'qarv_tiny' else {}
    model.compress_mode(num_lanes=16, portable=True, esc_cap=1 << 16)
    im = np.random.default_rng(1).uniform(0, 1, (1, 64, 128, 3))
    if name == 'qres_tiny_lossless':
        im = np.round(im * 255).astype(np.float32) / 255
    obj, recon, dec = _round_trip(model, im, **kw)
    assert np.array_equal(dec, recon)
    if name == 'qres_tiny_lossless':
        assert np.array_equal(dec, im)
        monkeypatch.setattr(PortableQresCodec, '_head_tensors', _former_head)
    else:
        monkeypatch.setattr(PortableTrunk, '_tail', _former_tail)
    old_obj, old_recon, old_dec = _round_trip(model, im, **kw)
    assert old_obj == obj
    assert np.array_equal(old_recon, recon) and np.array_equal(old_dec, dec)


def _qarv_tail_nearest(net):
    net.dec_blocks.append(tcommon.upsample_nearest(2))


def _qarv_tail_four_channels(net):
    net.dec_blocks[-1] = tcommon.patch_upsample(16, 4, rate=4)


def _lossless_head_two_rates(net):
    net.out_net.conv_scale = tcommon.patch_upsample(16, 3, rate=2)


@pytest.mark.parametrize('name,change', [
    ('qarv_tiny', _qarv_tail_nearest),
    ('qarv_tiny', _qarv_tail_four_channels),
    ('qres_tiny_lossless', _lossless_head_two_rates)])
def test_portable_codec_refuses_a_tail_without_the_fold(name, change):
    """The portable codec is built only where the tail ends in a
    patch_upsample to 3 channels (the lossless head: both convs so, at one
    rate); the legacy codec takes any."""
    model = lvae_tpu_torch.get_model(name, device='cpu')
    change(model.net)
    with pytest.raises(NotImplementedError, match='patch_upsample to 3'):
        model.compress_mode(num_lanes=16, portable=True)
        model._get_fused(16, portable=True)
    model.compress_mode(num_lanes=16, portable=False)
    model._get_fused(16, portable=False)
