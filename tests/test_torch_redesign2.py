"""The second redesign's plain references against the JAX package, on the CPU.

The rANS decode kernel (csrc/rans.cu) now keeps its table in shared memory
and its stream in a ring; chip_smoke.py's `rans_corner_cases` holds it at its
corners on the card against the plain versions. Here those plain versions
are held byte for byte against the JAX Pallas decode kernels (interpret
mode) on the same corner cases. mlp_res moved onto the tiled product core,
whose card oracle is `chip_smoke.core_oracle` (two dense_act_oldcore calls
on the old core and the residual); here that oracle's form, run on CPU tensors
(the plain versions), is held bitwise against `mlp_res_plain`, and both
against the JAX `mlp_res` in interpret mode.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lvae_tpu.ops.pallas import rans_decode as jrd
from lvae_tpu.ops.pallas import trunk as jtrunk

import chip_smoke
from lvae_tpu_torch.ops import cdf, rans_decode as rd, trunk

_TABLES = chip_smoke.corner_scale_tables()
_CASES = ('every_lane_renormalises', 'no_lane_renormalises',
          'stream_cut_short', 'ends_mid_row', 'ring_wraps')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _corners(table, N):
    cdfs, offs = rd.prepare_device_cdf(cdf.build_cdf_table(_TABLES[table]))
    return cdfs, offs, dict(chip_smoke.rans_corner_cases(np, cdfs, offs, N))


def _corner(table, N, name):
    cdfs, offs, cases = _corners(table, N)
    assert tuple(cases) == _CASES
    return cdfs, offs, cases[name]


@pytest.mark.parametrize('name', _CASES)
@pytest.mark.parametrize('N', [16, 128])
@pytest.mark.parametrize('table', sorted(_TABLES))
def test_plain_decode_corner_cases_match_jax(table, N, name):
    """rans_decode_block_plain on each image and rans_decode_block_multi_plain
    on both: values, states and pointers identical to the Pallas kernels'."""
    cdfs, offs, c = _corner(table, N, name)
    nsym = c['nsym']
    for b in range(2):
        want = jrd.rans_decode_block(
            jnp.asarray(c['indexes'][b]), jnp.asarray(c['states'][b][None]),
            int(c['ptrs'][b]), jnp.asarray(c['streams'][b]),
            jnp.asarray(cdfs), jnp.asarray(offs), nsym, num_lanes=N,
            interpret=True)
        got = rd.rans_decode_block_plain(
            torch.from_numpy(c['indexes'][b]),
            torch.from_numpy(c['states'][b][None]),
            torch.tensor(int(c['ptrs'][b]), dtype=torch.int32),
            torch.from_numpy(c['streams'][b]), torch.from_numpy(cdfs),
            torch.from_numpy(offs), nsym)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (b, g, w)
    want = jrd.rans_decode_block_multi(
        *(jnp.asarray(c[k]) for k in ('indexes', 'states', 'ptrs',
                                      'streams')),
        jnp.asarray(cdfs), jnp.asarray(offs), nsym, num_lanes=N,
        interpret=True)
    got = rd.rans_decode_block_multi_plain(
        *(torch.from_numpy(c[k]) for k in ('indexes', 'states', 'ptrs',
                                           'streams')),
        torch.from_numpy(cdfs), torch.from_numpy(offs), nsym)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# (rows, C, HID, CO): ragged rows, the trunk's widths, hidden ratios 1.5-4,
# one output width unlike the input's, one hidden width no multiple of 4
_MLP_SHAPES = [(1, 128, 192, 128), (95, 192, 384, 192), (37, 384, 1536, 384),
               (96, 512, 2048, 512), (95, 384, 1536, 192),
               (95, 128, 190, 128)]


def _mlp_args(M, C, HID, CO, B=2):
    rng = np.random.default_rng(M + C + HID + CO)

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (f(B, M, C), f(C, HID, scale=C ** -0.5), f(HID, scale=0.1),
            f(HID, CO, scale=HID ** -0.5), f(CO, scale=0.1), f(CO, scale=0.5),
            f(B, M, CO))


@pytest.mark.parametrize('M,C,HID,CO', _MLP_SHAPES)
def test_core_oracle_mlp_res_equals_plain_bitwise(M, C, HID, CO):
    """The card's old-core oracle form (fc1 without a GELU, fc2 with the
    GELU on its input, then shortcut + y * gamma), run on CPU tensors where
    dense_act_oldcore is its plain version, equals mlp_res_plain bit for
    bit: the two run the same operations in the same order."""
    args = tuple(torch.from_numpy(a) for a in _mlp_args(M, C, HID, CO))
    want = trunk.mlp_res_plain(*args)
    assert torch.equal(chip_smoke.core_oracle(torch, 'mlp_res', args), want)
    assert torch.equal(trunk.mlp_res(*args), want)


@pytest.mark.parametrize('M,C,HID,CO', _MLP_SHAPES)
def test_mlp_res_oracle_matches_jax(M, C, HID, CO):
    """The oracle within atol 1e-5 / rtol 1e-4 of the JAX mlp_res (Pallas,
    interpret mode): the products sum in another order there."""
    args = _mlp_args(M, C, HID, CO)
    want = np.asarray(jtrunk.mlp_res(*(jnp.asarray(a) for a in args),
                                     interpret=True))
    got = chip_smoke.core_oracle(torch, 'mlp_res',
                                 tuple(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
