"""The port's QRes-VAE trunk functions (lvae_tpu_torch/ops/trunk.py, kernels
12-17 of the table in PERF.md) against the JAX package's Pallas kernels
(lvae_tpu/ops/pallas/trunk.py:446-748) run in interpret mode, on the same
seeded numpy inputs. On the CPU each wrapper runs its plain PyTorch version;
the CUDA kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerance atol=1e-5, rtol=1e-4 on floats (XLA:CPU and ATen sum the products
and the LayerNorm statistics in different orders); scale indexes must be
identical.
"""
import numpy as np
import pytest
import torch
import jax

from lvae_tpu.models import common as jcommon
from lvae_tpu.models.qresvae import model as jqres
from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.ops.pallas import trunk as jtrunk

from lvae_tpu_torch.models import common as tcommon
from lvae_tpu_torch.models.qresvae import model as tqres
from lvae_tpu_torch.models.weights import params_from_flax
from lvae_tpu_torch.ops import trunk

ATOL, RTOL = 1e-5, 1e-4
TABLE = jcdf.qres_latent_scale_table().astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_scale_table_matches_jax():
    from lvae_tpu_torch.ops import cdf
    want = jcdf.qres_latent_scale_table()
    assert np.array_equal(cdf.qres_latent_scale_table(), want)
    assert want[0] == pytest.approx(0.1) and want.size == 64


# (H, W, C, K): ragged H*W, the kernel sizes of qres34m's stages; H or W
# below K at K = 7 with C = 40
@pytest.mark.parametrize('H,W,C,K', [(8, 12, 48, 1), (9, 7, 16, 3),
                                     (16, 24, 32, 5), (13, 11, 24, 7),
                                     (5, 3, 40, 7), (2, 9, 40, 7),
                                     (4, 1, 40, 7)])
def test_dw_ln_affine_matches_jax(H, W, C, K):
    rng = np.random.default_rng(H * W + K)
    x = _normal(rng, (2, H, W, C))
    dwk, dwb = _normal(rng, (K, K, C), 0.3), _normal(rng, (C,), 0.1)
    scale, bias = _normal(rng, (C,), 0.5) + 1, _normal(rng, (C,), 0.1)
    want = jtrunk.dw_ln_affine(x, dwk, dwb, scale, bias, K, interpret=True)
    got = trunk.dw_ln_affine(_t(x), _t(dwk), _t(dwb), _t(scale), _t(bias), K)
    _close(got, want)


@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('HW,C,CO', [(96, 96, 96), (4095, 32, 8)])
def test_dense_act_matches_jax(HW, C, CO, act):
    rng = np.random.default_rng(HW + C + act)
    x = _normal(rng, (2, HW, C))
    w, b = _normal(rng, (C, CO), C ** -0.5), _normal(rng, (CO,), 0.1)
    want = jtrunk.dense_act(x, w, b, act=act, interpret=True)
    _close(trunk.dense_act(_t(x), _t(w), _t(b), act=act), want)


# the 9x7 grid: every pixel of a row or column is an edge or next to one
@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('H,W,Ci,Co', [(9, 7, 12, 8), (16, 20, 4, 24)])
def test_conv_kxk_act_matches_jax(H, W, Ci, Co, act):
    rng = np.random.default_rng(H * Ci + act)
    x = _normal(rng, (2, H, W, Ci))
    wk = _normal(rng, (3, 3, Ci, Co), (9 * Ci) ** -0.5)
    b = _normal(rng, (Co,), 0.1)
    want = jtrunk.conv_kxk_act(x, wk, b, act=act, interpret=True)
    _close(trunk.conv_kxk_act(_t(x), _t(wk), _t(b), act=act), want)


def _syms(rng, shape):
    syms = rng.integers(-3, 4, shape).astype(np.int32)
    # escape-sized values, as a decoded stream's escapes patch them in
    esc = rng.random(shape) < 0.05
    syms[esc] = rng.integers(-1000, 1000, int(esc.sum()))
    return syms


@pytest.mark.parametrize('HW,Z,CO', [(96, 16, 48), (4095, 4, 2)])
def test_zadd_dense_matches_jax(HW, Z, CO):
    rng = np.random.default_rng(HW + Z)
    syms, pm = _syms(rng, (2, HW, Z)), _normal(rng, (2, HW, Z))
    w, b = _normal(rng, (Z, CO), 0.05), _normal(rng, (CO,), 0.1)
    want = jtrunk.zadd_dense(syms, pm, w, b, interpret=True)
    _close(trunk.zadd_dense(_t(syms), _t(pm), _t(w), _t(b)), want)


@pytest.mark.parametrize('HW,Z', [(384, 14), (4095, 8)])
def test_zadd_matches_jax(HW, Z):
    rng = np.random.default_rng(HW * Z)
    syms, pm = _syms(rng, (2, HW, Z)), _normal(rng, (2, HW, Z))
    want = jtrunk.zadd(syms, pm, interpret=True)
    got = trunk.zadd(_t(syms), _t(pm))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))    # one rounding


@pytest.mark.parametrize('HW,Ci,C', [(96, 48, 384), (4095, 2, 16)])
def test_res_dense_act_matches_jax(HW, Ci, C):
    rng = np.random.default_rng(HW + Ci)
    f, t = _normal(rng, (2, HW, C)), _normal(rng, (2, HW, Ci))
    w, b = _normal(rng, (Ci, C), Ci ** -0.5), _normal(rng, (C,), 0.1)
    want = jtrunk.res_dense_act(f, t, w, b, interpret=True)
    _close(trunk.res_dense_act(_t(f), _t(t), _t(w), _t(b)), want)


def _randomize(rng, params, scale=0.3):
    return jax.tree.map(lambda a: _normal(rng, a.shape, scale), params)


@pytest.mark.parametrize('K', [1, 3])
def test_convnext_plain_adapter_matches_jax(K):
    """The adapter on the port's MyConvNeXtBlock against the JAX adapter on
    the same flax weights."""
    rng = np.random.default_rng(10 + K)
    x = _normal(rng, (2, 9, 11, 16))
    fm = jcommon.MyConvNeXtBlock(16, kernel_size=K)
    params = _randomize(rng, fm.init(jax.random.PRNGKey(0), x)['params'])
    want = jtrunk.convnext_plain(x, params, K, interpret=True)
    tm = tcommon.MyConvNeXtBlock(16, kernel_size=K)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        _close(trunk.convnext_plain(_t(x), tm), want)
        # and the module itself (the legacy trunk) computes the same block
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _close(got, want)


def _latent_block(rng, K, H=8, W=9):
    """A QLatentBlock (C 16, Z 4) with random flax weights in both packages,
    its prior's last conv scaled and biased so that the prior's log-scales
    spread over the scale table."""
    C, Z = 16, 4
    jb = jqres.QLatentBlock(C, Z, kernel_size=K)
    x = _normal(rng, (1, H, W, C), 2.0)
    params = _randomize(rng, jb.init(jax.random.PRNGKey(0), x, x)['params'],
                        0.2)
    c4 = params['prior']['c4']
    c4['kernel'] *= 100
    c4['bias'][Z:] = rng.uniform(-4, 4, Z)
    tb = tqres.QLatentBlock(C, Z, kernel_size=K)
    tb.load_state_dict(params_from_flax(params), strict=True)
    return jb, params, tb, x


@pytest.mark.parametrize('K', [1, 3])
def test_qres_prior_head_adapter_matches_jax(K):
    rng = np.random.default_rng(20 + K)
    _, params, tb, x = _latent_block(rng, K)
    f_mid = np.asarray(jtrunk.convnext_plain(x, params['resnet_front'], K,
                                             interpret=True))
    want_pm, want_idx = jtrunk.qres_prior_head(
        f_mid, params['prior'], K >= 3, TABLE, interpret=True)
    with torch.no_grad():
        pm, idx = trunk.qres_prior_head(_t(f_mid), tb.prior, K >= 3,
                                        _t(TABLE))
    _close(pm, want_pm)
    want_idx = np.asarray(want_idx)
    flips = int((idx.numpy() != want_idx).sum())
    print(f'qres_prior_head K={K}: {flips} of {want_idx.size} scale indexes '
          f'differ; {len(np.unique(want_idx))} distinct')
    assert idx.dtype == torch.int32 and flips == 0
    assert len(np.unique(want_idx)) > 16       # the table is exercised


@pytest.mark.parametrize('K', [1, 3])
def test_qres_fuse_adapter_matches_jax(K):
    rng = np.random.default_rng(30 + K)
    _, params, tb, x = _latent_block(rng, K)
    syms = _syms(rng, (1, 8, 9, 4))
    pm = _normal(rng, (1, 8, 9, 4))
    want = jtrunk.qres_fuse(x, syms, pm, params, K, interpret=True)
    with torch.no_grad():
        got = trunk.qres_fuse(_t(x), _t(syms), _t(pm), tb)
        _close(got, want)
        # the legacy trunk's fuse_stage on the same block agrees too
        legacy = tb.fuse_stage(_t(x).permute(0, 3, 1, 2), _t(pm).permute(
            0, 3, 1, 2), _t(syms).permute(0, 3, 1, 2))
        _close(legacy.permute(0, 2, 3, 1), want)
