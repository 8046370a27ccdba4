"""dense_act and prior_head, the two kernels that moved onto the tiled
product core, on the CPU.

On the card (chip_smoke.py's tiled_core line, tests/test_torch_cuda.py) the
tiled kernels are held bitwise against their old-core oracles
(trunk.dense_act_oldcore, trunk.prior_head_oldcore) at
chip_smoke.check_prior_dense_act_synthetic's shapes and tables. Here, where
every wrapper runs its plain version, the plain versions are held against
the JAX Pallas kernels (interpret mode) at those shapes the JAX kernels take,
with those tables (the codecs' 64 entries, ties, one entry, 65, shuffled,
one past the kernel's shared-memory stage): atol 1e-5, rtol 1e-4 on floats
(XLA:CPU and ATen sum the products in different orders) and no scale-index
flip. The oracles' wrappers and dense_act_staged on CPU tensors return the
plain result and count no launch.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lvae_tpu.ops.pallas import trunk as jtrunk

import chip_smoke
from lvae_tpu_torch.ops import trunk

ATOL, RTOL = 1e-5, 1e-4
TABLES = chip_smoke.prior_tables(np)

# (M, C, N, act): every row count, depth and width of the card's synthetic
# check (chip_smoke.DA_M, DA_C, DA_N), the main path's VDBlock convs among
# them (96 x 384 -> 96, 24576 x 192 -> 48 at a quarter of the rows)
_DENSE_ACT = [(1, 10, 24, True), (95, 48, 48, False), (385, 96, 96, True),
              (96, 384, 96, True), (385, 512, 2048, False),
              (6144, 256, 48, True), (1, 512, 96, False),
              (6144, 192, 48, True), (95, 10, 2048, True)]

# (M, C, Z, act, table): every Z of chip_smoke.PRIOR_Z and every table of
# prior_tables; qarv's heads (C 256-512, Z 16-192) and qres34m's
# pre-activated ones (C 48-96, Z 16-32)
_PRIOR = [(95, 512, 64, False, 'codec'), (385, 384, 192, False, 'codec'),
          (6144, 256, 16, False, 'codec'), (96, 96, 32, True, 'codec'),
          (385, 96, 28, True, 'codec'), (1, 48, 16, True, 'codec'),
          (385, 96, 20, True, 'ties'), (95, 10, 20, False, 'one'),
          (385, 48, 64, True, 's65'), (95, 96, 1, False, 'shuffled'),
          (95, 10, 16, True, 'past_smem')]


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _dense_act_args(M, C, N):
    rng = np.random.default_rng(M + C + N)
    return (_normal(rng, (2, M, C)), _normal(rng, (C, N), C ** -0.5),
            _normal(rng, (N,), 0.1))


def _prior_args(M, C, Z):
    """Inputs whose scales spread over the whole table and past both of its
    ends, as the card check draws them: weights at 1.5 C^-1/2, the index
    columns' biases over -4 .. 5."""
    rng = np.random.default_rng(M + C + Z)
    b = np.concatenate([_normal(rng, (Z,), 0.1),
                        rng.uniform(-4, 5, Z).astype(np.float32)])
    return (_normal(rng, (2, M, C)), _normal(rng, (C, 2 * Z), 1.5 * C ** -0.5),
            b)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('M,C,N,act', _DENSE_ACT)
def test_dense_act_plain_matches_jax(M, C, N, act):
    x, w, b = _dense_act_args(M, C, N)
    want = np.asarray(jtrunk.dense_act(x, w, b, act=act, interpret=True))
    got = trunk.dense_act(*_t(x, w, b), act)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert torch.equal(trunk.dense_act_plain(*_t(x, w, b), act), got)


@pytest.mark.parametrize('M,C,Z,act,table', _PRIOR)
def test_prior_head_plain_matches_jax(M, C, Z, act, table):
    x, w, b = _prior_args(M, C, Z)
    tb = TABLES[table]
    want_pm, want_idx = (np.asarray(a) for a in jtrunk.prior_head(
        x, w, b, jnp.asarray(tb), act=act, interpret=True))
    pm, idx = trunk.prior_head(*_t(x, w, b, tb), act)
    assert idx.dtype == torch.int32 and idx.shape == (2, M, Z)
    np.testing.assert_allclose(pm.numpy(), want_pm, atol=ATOL, rtol=RTOL)
    flips = int((idx.numpy() != want_idx).sum())
    print(f'prior_head {table} (S = {len(tb)}): {flips} of {want_idx.size} '
          f'scale indexes differ; range {want_idx.min()}..{want_idx.max()}')
    assert flips == 0
    if M * Z >= 95 and len(tb) > 1:
        # the scales pass both ends: the least index is that of the clamp
        # at table[0] (0 for an ascending table), the largest the cap
        assert want_idx.min() == (tb < tb[0]).sum()
        assert want_idx.max() == len(tb) - 1


def test_prior_tables_cover_the_kernel_paths():
    """The tables reach each count of the tiled kernel's epilogue: the
    codecs' 64 entries (the unrolled count), ties and a shuffled order of
    it, one and 65 entries (the run-time count from shared memory) and one
    past PRIOR_TABLE_SMEM (the count from global memory)."""
    smem = chip_smoke.prior_table_smem()
    sizes = {k: len(v) for k, v in TABLES.items()}
    assert sizes == dict(codec=64, ties=64, one=1, s65=65, shuffled=64,
                         past_smem=smem + 1)
    assert len(np.unique(TABLES['ties'])) == 32
    assert not np.all(np.diff(TABLES['shuffled']) > 0)
    assert np.array_equal(np.sort(TABLES['shuffled']), TABLES['codec'])


@pytest.mark.parametrize('name,side', [('dense_act', 'dense_act_oldcore'),
                                       ('dense_act', 'dense_act_staged'),
                                       ('prior_head', 'prior_head_oldcore')])
def test_oldcore_wrappers_on_cpu_return_plain_and_count_nothing(name, side):
    """dense_act_oldcore, dense_act_staged and prior_head_oldcore on CPU
    tensors return the plain version's result bit for bit, as
    chip_smoke.core_oracle does, and leave the main wrappers' launch counts
    as they were."""
    if name == 'dense_act':
        args = [*_t(*_dense_act_args(95, 48, 24)), True]
    else:
        args = [*_t(*_prior_args(95, 48, 20), TABLES['codec']), True]
    fn, other = getattr(trunk, name), getattr(trunk, side)
    counts = {k.__name__: k.launches for k in trunk.KERNELS}
    want = trunk.PLAIN[fn](*args)
    for got in (other(*args), chip_smoke.core_oracle(torch, name, args)):
        got, w = ((got, want) if isinstance(got, tuple)
                  else ((got,), (want,)))
        assert all(torch.equal(g, v) for g, v in zip(got, w))
    assert chip_smoke.core_bitwise(torch, name, args)
    assert {k.__name__: k.launches for k in trunk.KERNELS} == counts
