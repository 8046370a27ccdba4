"""The port's portable-trunk functions (lvae_tpu_torch/ops/trunk.py) against
the JAX package's Pallas kernels (lvae_tpu/ops/pallas/trunk.py) run in
interpret mode, on the same numpy inputs. On the CPU each wrapper runs its
plain PyTorch version; the CUDA kernels are held against those plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance atol=1e-5, rtol=1e-4 on floats (XLA:CPU and ATen sum the products
and the LayerNorm statistics in different orders). Scale indexes and every
other integer must be identical; the index tests print the flips they count.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lvae_tpu.models import common as jcommon
from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.ops.pallas import trunk as jtrunk

from lvae_tpu_torch.models import common as tcommon
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.ops import trunk

ATOL, RTOL = 1e-5, 1e-4
TABLE = jcdf.default_gaussian_scale_table().astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize('E0,E', [(32, 32), (256, 256)])
def test_emb_mlp_matches_jax(E0, E):
    rng = np.random.default_rng(E0)
    lmb = np.array([512.0, 37.5, 2048.0], np.float32)
    freqs = trunk.emb_freqs(E0, 64)
    w0, b0 = _normal(rng, (E0, E), E0 ** -0.5), _normal(rng, (E,), 0.1)
    w1, b1 = _normal(rng, (E, E), E ** -0.5), _normal(rng, (E,), 0.1)
    want = jtrunk.emb_mlp(jnp.asarray(lmb), jnp.asarray(freqs), w0, b0, w1,
                          b1, 64, interpret=True)
    got = trunk.emb_mlp(_t(lmb), _t(freqs), _t(w0), _t(b0), _t(w1), _t(b1),
                        64)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


# (H, W, C, K): ragged H*W, every kernel size of the main path's extremes;
# H or W below K at K = 7 with C = 40, no multiple of 32 (taps off the
# image on both sides of every pixel)
@pytest.mark.parametrize('H,W,C,K', [(8, 12, 32, 1), (9, 7, 16, 3),
                                     (16, 24, 32, 5), (64, 64, 16, 7),
                                     (3, 13, 40, 7), (13, 5, 40, 7),
                                     (1, 6, 40, 7)])
def test_dw_ln_mod_matches_jax(H, W, C, K):
    rng = np.random.default_rng(H * W + K)
    B, E = 2, 32
    x = _normal(rng, (B, H, W, C))
    dwk, dwb = _normal(rng, (K, K, C), 0.3), _normal(rng, (C,), 0.1)
    ew, eb = _normal(rng, (E, 2 * C), 0.2), _normal(rng, (2 * C,), 0.1)
    gemb = _normal(rng, (B, E))
    want = jtrunk.dw_ln_mod(x, dwk, dwb, ew, eb, gemb, K, interpret=True)
    got = trunk.dw_ln_mod(_t(x), _t(dwk), _t(dwb), _t(ew), _t(eb), _t(gemb),
                          K)
    _close(got, want)


@pytest.mark.parametrize('HW,C,HID', [(96, 32, 128), (4095, 16, 24)])
def test_mlp_res_matches_jax(HW, C, HID):
    rng = np.random.default_rng(HW)
    B = 2
    t, s = _normal(rng, (B, HW, C)), _normal(rng, (B, HW, C))
    w1, b1 = _normal(rng, (C, HID), C ** -0.5), _normal(rng, (HID,), 0.1)
    w2, b2 = _normal(rng, (HID, C), HID ** -0.5), _normal(rng, (C,), 0.1)
    gamma = _normal(rng, (C,), 0.5)
    want = jtrunk.mlp_res(t, w1, b1, w2, b2, gamma, s, interpret=True)
    got = trunk.mlp_res(_t(t), _t(w1), _t(b1), _t(w2), _t(b2), _t(gamma),
                        _t(s))
    _close(got, want)


@pytest.mark.parametrize('HW,C,CO', [(96, 32, 128), (4095, 16, 48)])
def test_dense_matches_jax(HW, C, CO):
    rng = np.random.default_rng(CO)
    x = _normal(rng, (1, HW, C))
    w, b = _normal(rng, (C, CO), C ** -0.5), _normal(rng, (CO,), 0.1)
    want = jtrunk.dense(x, w, b, interpret=True)
    _close(trunk.dense(_t(x), _t(w), _t(b)), want)


@pytest.mark.parametrize('act', [False, True])
@pytest.mark.parametrize('HW,C,Z', [(96, 32, 4), (4095, 16, 8)])
def test_prior_head_matches_jax(HW, C, Z, act):
    rng = np.random.default_rng(HW + Z + act)
    B = 2
    x = _normal(rng, (B, HW, C))
    # log-variances spread over the whole scale table (0.11 .. 20)
    w = _normal(rng, (C, 2 * Z), 1.5 * C ** -0.5)
    b = np.concatenate([_normal(rng, (Z,), 0.1),
                        rng.uniform(-4, 5, Z).astype(np.float32)])
    want_pm, want_idx = jtrunk.prior_head(x, w, b, jnp.asarray(TABLE),
                                          act=act, interpret=True)
    pm, idx = trunk.prior_head(_t(x), _t(w), _t(b), _t(TABLE), act=act)
    assert idx.dtype == torch.int32 and idx.shape == (B, HW, Z)
    _close(pm, want_pm)
    want_idx = np.asarray(want_idx)
    flips = int((idx.numpy() != want_idx).sum())
    print(f'prior_head act={act}: {flips} of {want_idx.size} scale indexes '
          f'differ; {len(np.unique(want_idx))} distinct indexes')
    assert len(np.unique(want_idx)) > 32      # the table is exercised
    assert flips == 0


@pytest.mark.parametrize('HW,C,Z', [(96, 32, 4), (4095, 16, 8)])
def test_fuse_zproj_matches_jax(HW, C, Z):
    rng = np.random.default_rng(HW + C)
    B = 2
    f = _normal(rng, (B, HW, C))
    syms = rng.integers(-3, 4, (B, HW, Z)).astype(np.int32)
    # escape-sized values, as a decoded stream's escapes patch them in
    esc = rng.random((B, HW, Z)) < 0.05
    syms[esc] = rng.integers(-1000, 1000, int(esc.sum()))
    pm = _normal(rng, (B, HW, Z))
    w, b = _normal(rng, (Z, C), 0.01), _normal(rng, (C,), 0.1)
    want = jtrunk.fuse_zproj(f, syms, pm, w, b, interpret=True)
    got = trunk.fuse_zproj(_t(f), _t(syms), _t(pm), _t(w), _t(b))
    _close(got, want)


def test_finish_image_matches_jax():
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 64, 48, 3), 1.5)
    want = jtrunk.finish_image(x, interpret=True)
    got = trunk.finish_image(_t(x))
    assert got.dtype == torch.float16
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('K,mlp_ratio', [(1, 4), (3, 3), (7, 1.75)])
def test_convnext_adaln_adapter_matches_jax(K, mlp_ratio):
    """The adapter on the port's nn.Module against the JAX adapter on the
    same flax weights."""
    rng = np.random.default_rng(K)
    B, H, W, C, E = 2, 9, 11, 16, 32
    x = _normal(rng, (B, H, W, C))
    gemb = _normal(rng, (B, E))
    fm = jcommon.ConvNeXtBlockAdaLN(C, E, kernel_size=K, mlp_ratio=mlp_ratio)
    params = fm.init(jax.random.PRNGKey(0), x, gemb)['params']
    params = jax.tree.map(lambda a: _normal(rng, a.shape, 0.3), params)
    want = jtrunk.convnext_adaln(x, params, gemb, K, interpret=True)
    tm = tcommon.ConvNeXtBlockAdaLN(C, E, kernel_size=K, mlp_ratio=mlp_ratio)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        _close(trunk.convnext_adaln(_t(x), tm, _t(gemb)), want)


def test_conv1x1_adapter_matches_jax():
    rng = np.random.default_rng(11)
    x = _normal(rng, (1, 5, 7, 16))
    cp = {'kernel': _normal(rng, (1, 1, 16, 48), 0.25),
          'bias': _normal(rng, (48,), 0.1)}
    want = jtrunk.conv1x1(x, cp, interpret=True)
    conv = torch.nn.Conv2d(16, 48, 1)
    conv.load_state_dict(params_from_flax(cp), strict=True)
    with torch.no_grad():
        got = trunk.conv1x1(_t(x), conv)
    assert got.shape == (1, 5, 7, 48)
    _close(got, want)


def test_pixel_shuffle_nhwc_matches_jax():
    from lvae_tpu_torch.models.fused_base import pixel_shuffle_nhwc
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    want = jcommon.pixel_shuffle(jnp.asarray(x), 2)
    assert np.array_equal(pixel_shuffle_nhwc(_t(x), 2).numpy(),
                          np.asarray(want))


def test_wrappers_refuse_other_devices_and_mixed_inputs():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match='unsupported device'):
        trunk.dense(x.to('meta'), torch.zeros(8, 8, device='meta'),
                    torch.zeros(8, device='meta'))
    with pytest.raises(ValueError, match='different devices'):
        trunk.dense(x, torch.zeros(8, 8, device='meta'), torch.zeros(8))
