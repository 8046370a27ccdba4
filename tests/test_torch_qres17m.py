"""qres17m in the port against the JAX package: its transposed-conv
upsampler (common.deconv) and the flax kernel's loading rule, a narrow net
of qres17m's shape (a deconv at in = out and one at in != out, the x4
nearest upsample, latent kernel sizes 1/3/5/7) built from each package's
classes (forward stats, and the port's legacy fused, host and device round
trips), qres17m's parameter shapes, and the portable trunk's refusal in
both packages (no deconv kernel: qres17m codes legacy streams only)."""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
import lvae_tpu_torch
from lvae_tpu.models import base as jbase
from lvae_tpu.models import common as jcommon
from lvae_tpu.models.qresvae import model as jqres
from lvae_tpu_torch.models import common as tcommon
from lvae_tpu_torch.models.qresvae import model as tqres
from lvae_tpu_torch.models.qresvae import zoo as tzoo
from lvae_tpu_torch.models.weights import params_from_flax

COLLIE = 'images/collie64.png'
SHIFT, SCALE = tzoo.CELEBA_SHIFT, tzoo.CELEBA_SCALE


def _jax_deconv(in_ch, out_ch, k, x, seed):
    mod = jcommon.deconv(out_ch, kernel_size=k)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))['params']
    params = jax.tree.map(np.asarray, params)
    # a nonzero bias, so that the bias's layout is held too
    params['conv']['bias'] = np.linspace(-1, 1, out_ch).astype(np.float32)
    return np.asarray(mod.apply({'params': params}, jnp.asarray(x))), params


@pytest.mark.parametrize('k', [3, 5])
@pytest.mark.parametrize('in_ch,out_ch', [(12, 12), (12, 7)])
@pytest.mark.parametrize('hw', [(5, 7)])
def test_deconv_matches_jax(k, in_ch, out_ch, hw):
    x = np.random.default_rng(k + out_ch).normal(
        size=(2, *hw, in_ch)).astype(np.float32)
    want, params = _jax_deconv(in_ch, out_ch, k, x, seed=k)
    assert want.shape == (2, 2 * hw[0], 2 * hw[1], out_ch)
    mod = tcommon.deconv(in_ch, out_ch, kernel_size=k)
    mod.load_state_dict(params_from_flax(params, mod), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_deconv_kernel_rule_needs_the_module():
    """With in == out a conv's transpose of the deconv kernel loads under
    strict=True with no error, and gives other outputs: the rule is chosen
    by the module the net has there, not by the path or the shape."""
    x = np.random.default_rng(0).normal(size=(1, 6, 6, 9)).astype(np.float32)
    want, params = _jax_deconv(9, 9, 3, x, seed=1)
    mod = tcommon.deconv(9, 9, kernel_size=3)
    wrong = params_from_flax(params)                   # no net given
    mod.load_state_dict(wrong, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        bad = mod(xt).permute(0, 2, 3, 1).numpy()
    assert np.abs(bad - want).max() > 1e-2
    mod.load_state_dict(params_from_flax(params, mod), strict=True)
    with torch.no_grad():
        good = mod(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(good, want, atol=1e-5, rtol=0)


def _narrow_blocks(pkg, ch=8):
    """qres17m's block list (lvae_tpu/models/qresvae/zoo.py:111-150) at
    width ch (qres17m: 72), one latent block a stage."""
    c, q = (jcommon, jqres) if pkg == 'jax' else (tcommon, tqres)
    jax_pkg = pkg == 'jax'

    def conv_block(w, k):
        return c.MyConvNeXtBlock(w, kernel_size=k)

    def down(a, b, rate=2):
        return c.MyConvNeXtPatchDown(a, b, down_rate=rate)

    def latent(w, z, k):
        return q.QLatentBlock(w, z, kernel_size=k, rescale_z=2.0)

    enc = [c.patch_downsample(ch * 2, rate=4) if jax_pkg
           else c.patch_downsample(3, ch * 2, rate=4),
           conv_block(ch * 2, 7), down(ch * 2, ch * 4), conv_block(ch * 4, 5),
           down(ch * 4, ch * 4), conv_block(ch * 4, 3),
           down(ch * 4, ch * 4, rate=4), conv_block(ch * 4, 1)]
    dec = [latent(ch * 4, 4, 1), c.upsample_nearest(rate=4),
           latent(ch * 4, 3, 3),
           (c.deconv(ch * 4, kernel_size=3) if jax_pkg
            else c.deconv(ch * 4, ch * 4, kernel_size=3)),
           latent(ch * 4, 3, 5),
           c.deconv(ch * 2) if jax_pkg else c.deconv(ch * 4, ch * 2),
           latent(ch * 2, 2, 7),
           (c.patch_upsample(3, rate=4) if jax_pkg
            else c.patch_upsample(ch * 2, 3, rate=4))]
    return enc, dec


def _redraw(params, rng, posterior_scale):
    """Each prior's last conv re-drawn at the lecun-normal scale (flax
    zero-initialises it), each posterior's last conv scaled."""
    for name, blk in params.items():
        if name.startswith('dec_blocks_') and 'prior' in blk:
            c4 = blk['prior']['c4']
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape)
                            / np.sqrt(c4['kernel'].shape[2])).astype(
                                np.float32)
            post = blk['posterior']['c4']
            post['kernel'] = np.asarray(post['kernel']) * posterior_scale
    return params


def _jit_init(self, net, seed=0, example_hw=64):
    """The JAX handle's init (lvae_tpu/models/base.py:46-50), jitted: one
    compile, not an op-by-op trace of the whole forward."""
    self.net = net
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    self.params = jax.jit(net.init)({'params': jax.random.PRNGKey(seed)},
                                    dummy)['params']


@pytest.fixture(scope='module')
def narrow():
    enc, dec = _narrow_blocks('jax')
    jnet = jqres.HierarchicalVAENet(
        enc_blocks=tuple(enc), dec_blocks=tuple(dec),
        out_net=jqres.MSEOutputNet(mse_lmb=8.0), im_shift=SHIFT,
        im_scale=SCALE, max_stride=64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase.VAEModelBase, '__init__', _jit_init)
        jm = jqres.QresModel(jnet)
    params = _redraw(jax.device_get(jm.params), np.random.default_rng(0), 1)
    jm.params = jax.tree.map(jnp.asarray, params)
    enc, dec = _narrow_blocks('torch')
    tnet = tqres.HierarchicalVAENet(enc, dec, tqres.MSEOutputNet(8.0),
                                    im_shift=SHIFT, im_scale=SCALE,
                                    max_stride=64)
    tm = tzoo.build(tnet, False, 'cpu')
    tm.net.load_state_dict(params_from_flax(params, tm.net), strict=True)
    return jm, tm, params


@pytest.fixture(scope='module')
def images():
    """Two smooth 128 x 128 images of 8-bit pixels."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(5)
    ims = [gaussian_filter(rng.uniform(0, 1, (128, 128, 3)), (3, 3, 0))
           for _ in range(2)]
    ims = [(im - im.min()) / (im.max() - im.min()) for im in ims]
    return np.round(np.stack(ims) * 255).astype(np.float32) / 255


def test_narrow_net_forward_matches_jax(narrow, images):
    jm, tm, _ = narrow
    want = jm.forward(images)
    got = tm.forward(images)
    assert set(got) == set(want)
    for key in ('loss', 'kl', 'mse', 'bppix'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6)
    assert abs(got['psnr'] - want['psnr']) < 1e-3
    rec = tm.reconstruct(images)
    assert rec.shape == images.shape


def test_narrow_net_round_trips_exact(narrow, images):
    """The legacy fused codec (B = 1 and B = 2), the host coder (B = 1 and
    B = 2, coded image by image) and the device coder: exact, and host =
    device = legacy fused reconstructions bitwise at B = 1; the posteriors
    x300 for escapes."""
    _, tm, params = narrow
    tm.net.load_state_dict(params_from_flax(
        _redraw(copy.deepcopy(params), np.random.default_rng(0), 300),
        tm.net), strict=True)
    try:
        tm.compress_mode(num_lanes=16, esc_cap=1 << 15)
        obj, legacy = tm.compress_check(images[:1], portable=False)
        assert np.array_equal(tm.decompress(obj), legacy)
        objs = tm.compress_batch(images)
        assert np.array_equal(tm.decompress_batch(objs).shape, images.shape)
        assert np.array_equal(tm.decompress_batch(objs),
                              tm._fused.encode_check_batch(
                                  torch.from_numpy(images).permute(
                                      0, 3, 1, 2).contiguous())[1])
        for coder in ('device', 'host'):
            tm.compress_mode(coder=coder)
            obj, recon = tm.compress_check(images[:1])
            assert np.array_equal(tm.decompress(obj), recon)
            assert np.array_equal(recon, legacy)
        # the host coder's batch: the trunk at B = 2, the strings image by
        # image (a legacy trunk's floats may depend on the batch size)
        obj, recon = tm.compress_check(images)
        assert obj[-1][0] == 2 and all(len(s) == 2 for s in obj[:-1])
        assert np.array_equal(tm.decompress(obj), recon)
    finally:
        tm.net.load_state_dict(params_from_flax(params, tm.net))


def test_portable_is_refused_in_both_packages(narrow, tmp_path):
    jm, tm, _ = narrow
    for m in (jm, tm):
        with pytest.raises(NotImplementedError, match='deconv'):
            m.compress_mode(coder='fused', portable=True)
        m.compress_mode(coder='fused')
        with pytest.raises(NotImplementedError, match='deconv'):
            m.compress_file(COLLIE, str(tmp_path / 'x.bits'))
    tm.compress_file(COLLIE, tmp_path / 'x.bits', portable=False)
    assert tm.decompress_file(tmp_path / 'x.bits').shape == (1, 64, 64, 3)


def test_qres17m_registered_with_the_jax_package_shapes(monkeypatch):
    """qres17m()'s parameters in the port have the JAX package's names and
    shapes (the JAX tree's shapes traced, not computed), 16,678,842 of
    them; pretrained=True and portable=True raise."""
    def shapes_only(self, net, seed=0, example_hw=64):
        self.net = net
        dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
        self.params = jax.eval_shape(
            lambda: net.init({'params': jax.random.PRNGKey(seed)},
                             dummy))['params']
    monkeypatch.setattr(jbase.VAEModelBase, '__init__', shapes_only)
    jm = lvae_tpu.get_model('qres17m')
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jm.params)
    tm = lvae_tpu_torch.get_model('qres17m', device='cpu')
    sd = params_from_flax(tree, tm.net)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tm.net.state_dict().items()}
    assert tm.num_params() == 16_678_842
    assert sum(v.numel() for v in sd.values()) == tm.num_params()
    with pytest.raises(RuntimeError, match='pretrained'):
        lvae_tpu_torch.get_model('qres17m', pretrained=True, device='cpu')
    with pytest.raises(NotImplementedError, match='deconv'):
        tm.compress_mode(portable=True)
