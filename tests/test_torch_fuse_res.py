"""fuse_zproj and res_dense_act, the two kernels that moved onto the tiled
product core with the staged residual epilogue, on the CPU.

On the card (chip_smoke.py's tiled_core line, tests/test_torch_cuda.py) the
tiled kernels are held bitwise against their old-core oracles
(trunk.fuse_zproj_oldcore, trunk.res_dense_act_oldcore) at
chip_smoke.check_junction_synthetic's shapes. Here, where every wrapper runs
its plain version, the plain versions are held against the JAX Pallas
kernels (interpret mode) at small copies of those shapes: rows 1, 95 and
385; Z or Ci of 1, 8, 10, 14, 24 and 48; symbols up to +-(2^24 - 1) and
escape-sized ones; -0 in the feature. atol 1e-5, rtol 1e-4 (XLA:CPU and
ATen sum the products in different orders). The oracles' wrappers and
res_dense_act_prepass on CPU tensors return the plain result and count no
launch.
"""
import numpy as np
import pytest
import torch

from lvae_tpu.ops.pallas import trunk as jtrunk

import chip_smoke
from lvae_tpu_torch.ops import trunk

ATOL, RTOL = 1e-5, 1e-4

# (M, K, N): every row count and every depth of the list above, each depth
# once per kernel; qarv_base's junctions (Z 8-96 into 256-512) and qres34m's
# z_proj_1 (Ci 24 or 48 into 192 or 384) at a reduced width
_SHAPES = [(1, 1, 24), (95, 8, 192), (385, 10, 64), (95, 14, 24),
           (385, 24, 192), (1, 48, 64)]


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _symbols(rng, shape):
    """Mostly small symbols, one in 16 escape-sized (up to 2^16), and the
    first two at +-(2^24 - 1), the largest that convert to float exactly."""
    big = (1 << 24) - 1
    s = rng.integers(-40, 41, shape)
    esc = rng.random(shape) < 1 / 16
    s[esc] = rng.integers(-(1 << 16), (1 << 16) + 1, int(esc.sum()))
    flat = s.reshape(-1)
    flat[:2] = [big, -big][:flat.size]
    return s.astype(np.int32)


def _feature(rng, M, N):
    f = _normal(rng, (2, M, N))
    f[:, 0, ::5] = -0.0
    return f


def _fuse_args(M, Z, C):
    rng = np.random.default_rng(M + 7 * Z + C)
    return (_feature(rng, M, C), _symbols(rng, (2, M, Z)),
            _normal(rng, (2, M, Z)), _normal(rng, (Z, C), Z ** -0.5),
            _normal(rng, (C,), 0.1))


def _res_args(M, Ci, C):
    rng = np.random.default_rng(M + 5 * Ci + C)
    return (_feature(rng, M, C), _normal(rng, (2, M, Ci), 2.0),
            _normal(rng, (Ci, C), Ci ** -0.5), _normal(rng, (C,), 0.1))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('M,Z,C', _SHAPES)
def test_fuse_zproj_plain_matches_jax(M, Z, C):
    args = _fuse_args(M, Z, C)
    want = np.asarray(jtrunk.fuse_zproj(*args, interpret=True))
    got = trunk.fuse_zproj(*_t(*args))
    assert got.shape == want.shape == (2, M, C)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert torch.equal(trunk.fuse_zproj_plain(*_t(*args)), got)
    # the escape-sized and extreme symbols reach the outputs
    assert np.abs(want).max() > 1e5


@pytest.mark.parametrize('M,Ci,C', _SHAPES)
def test_res_dense_act_plain_matches_jax(M, Ci, C):
    args = _res_args(M, Ci, C)
    want = np.asarray(jtrunk.res_dense_act(*args, interpret=True))
    got = trunk.res_dense_act(*_t(*args))
    assert got.shape == want.shape == (2, M, C)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert torch.equal(trunk.res_dense_act_plain(*_t(*args)), got)


def test_negative_zero_feature_plus_zero_product_is_plus_zero():
    """A -0 feature plus a +0 product and bias is +0, as in the kernels'
    order of additions (f + (acc + b) for fuse_zproj, (f + acc) + b for
    res_dense_act)."""
    f = torch.full((1, 1, 4), -0.0)
    z = torch.zeros(1, 1, 2)
    w, b = torch.ones(2, 4), torch.zeros(4)
    for out in (trunk.fuse_zproj(f, z.to(torch.int32), z, w, b),
                trunk.res_dense_act(f, z, w, b)):
        assert torch.equal(out, torch.zeros(1, 1, 4))
        assert not torch.signbit(out).any()


@pytest.mark.parametrize('name,side', [
    ('fuse_zproj', 'fuse_zproj_oldcore'),
    ('res_dense_act', 'res_dense_act_oldcore'),
    ('res_dense_act', 'res_dense_act_prepass')])
def test_oldcore_wrappers_on_cpu_return_plain_and_count_nothing(name, side):
    """fuse_zproj_oldcore, res_dense_act_oldcore and res_dense_act_prepass on
    CPU tensors return the plain version's result bit for bit, as
    chip_smoke.core_oracle does, and leave every wrapper's launch count as
    it was (the main wrappers count only kernel launches)."""
    args = _t(*(_fuse_args(95, 10, 24) if name == 'fuse_zproj'
                else _res_args(95, 14, 24)))
    fn = getattr(trunk, name)
    counts = {k.__name__: k.launches for k in trunk.KERNELS}
    want = trunk.PLAIN[fn](*args)
    for got in (getattr(trunk, side)(*args),
                chip_smoke.core_oracle(torch, name, args), fn(*args)):
        assert torch.equal(got, want)
    assert chip_smoke.core_bitwise(torch, name, args)
    assert {k.__name__: k.launches for k in trunk.KERNELS} == counts


def test_junction_symbols_cover_the_range():
    """chip_smoke.junction_symbols (the card check's symbols) holds both
    ends of +-(2^24 - 1), escape-sized and small symbols, all int32."""
    g = torch.Generator().manual_seed(chip_smoke.JUNCTION_SEED)
    s = chip_smoke.junction_symbols(torch, g, 6144 * 8, torch.device('cpu'))
    big = (1 << 24) - 1
    assert s.dtype == torch.int32
    assert int(s.max()) == big and int(s.min()) == -big
    assert (s.abs() > 1 << 10).sum() > 100
    assert (s.abs() <= 40).float().mean() > 0.9
    # every symbol converts to float32 exactly
    assert torch.equal(s.float().to(torch.int32), s)
