"""im2col_tapmajor (lvae_tpu_torch/ops/trunk.py), the data movement behind
the card's bitwise oracle for conv_kxk_act: dense_act_oldcore on its output
runs the conv on the old product core, so the kernel's bits can be held
against it (tests/test_torch_cuda.py, chip_smoke.py).

On the CPU: the columns are exactly the JAX kernel's tap stack
(lvae_tpu/ops/pallas/trunk.py:575-577) with the taps moved next to the
channels, and the plain product on them is the JAX conv_kxk_act (Pallas in
interpret mode) within atol 1e-5 / rtol 1e-4 (XLA:CPU and ATen sum in other
orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.ops.pallas import trunk as jtrunk

from lvae_tpu_torch.ops import trunk

ATOL, RTOL = 1e-5, 1e-4

# (H, W, Ci, K): ragged grids whose every pixel is near an edge at K = 7,
# the z_proj_0 widths (8, 10, 14) and a kernel size of each of qres34m's
# stages
CASES = [(9, 7, 12, 1), (9, 7, 12, 3), (16, 20, 4, 3), (6, 5, 14, 5),
         (5, 6, 10, 5), (13, 11, 8, 7)]


def _inputs(H, W, Ci, K, Co=8, seed=0):
    rng = np.random.default_rng(seed + H * W * Ci + K)
    x = rng.normal(size=(2, H, W, Ci)).astype(np.float32)
    wk = (rng.normal(size=(K, K, Ci, Co)) * (K * K * Ci) ** -0.5).astype(
        np.float32)
    b = (rng.normal(size=(Co,)) * 0.1).astype(np.float32)
    return x, wk, b


@pytest.mark.parametrize('H,W,Ci,K', CASES)
def test_im2col_is_the_jax_tap_stack(H, W, Ci, K):
    x, _, _ = _inputs(H, W, Ci, K)
    B, p = x.shape[0], (K - 1) // 2
    # as the JAX kernel stacks its taps: (B, K*K, H*W, Ci)
    xp = jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    taps = jnp.stack(
        [xp[:, di:di + H, dj:dj + W, :].reshape(B, H * W, Ci)
         for di in range(K) for dj in range(K)], axis=1)
    want = np.asarray(taps).transpose(0, 2, 1, 3).reshape(B, H * W, -1)
    got = trunk.im2col_tapmajor(torch.from_numpy(x), K)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('H,W,Ci,K', CASES)
def test_dense_on_im2col_is_the_jax_conv(H, W, Ci, K, act):
    x, wk, b = _inputs(H, W, Ci, K)
    want = jtrunk.conv_kxk_act(x, wk, b, act=act, interpret=True)
    Co = wk.shape[-1]
    got = trunk.dense_act_plain(trunk.im2col_tapmajor(torch.from_numpy(x), K),
                                torch.from_numpy(wk).reshape(-1, Co),
                                torch.from_numpy(b), act)
    np.testing.assert_allclose(got.reshape(x.shape[:3] + (Co,)).numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)
