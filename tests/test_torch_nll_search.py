"""nll_head's scale-index search (csrc/trunk.cu nll_head_kernel) on the CPU:
a transcription of the kernel's branchless lower-bound search against the
count it replaced, min(#(table < scale), S - 1), on non-decreasing tables
with ties and on the edge scales; the head's table as the codec builds it;
and the order check that guards the search's contract. The kernel itself
runs only on the card (tests/test_torch_cuda.py
test_nll_head_search_equals_linear_and_plain)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from lvae_tpu_torch.ops import cdf, trunk


def search_count(table, pv):
    """nll_head_kernel's search, vectorised over the scales pv: pos = 0;
    for step = the largest power of two <= S - 1 down to 1: where pos +
    step <= S - 1 and table[pos + step - 1] < pv, pos += step."""
    cap = len(table) - 1
    pos = np.zeros(np.shape(pv), np.int64)
    step = 1 << (cap.bit_length() - 1) if cap else 0
    while step:
        j = pos + step
        ok = j <= cap
        probe = table[np.where(ok, j - 1, 0)]
        pos = np.where(ok & (probe < pv), j, pos)
        step >>= 1
    return pos


def linear_count(table, pv):
    """The replaced loop: #(table < pv) over all S entries, capped."""
    return np.minimum((table[None] < np.asarray(pv)[:, None]).sum(1),
                      len(table) - 1)


def edge_scales(table):
    """Every entry, one ulp either side of it, below the first, above the
    last, +-inf and NaN (a scale the kernel never sees: fmaxf with the
    first entry drops it)."""
    up = np.nextafter(table, np.float32(np.inf))
    down = np.nextafter(table, np.float32(-np.inf))
    extra = np.array([table[0] / 2 if table[0] > 0 else table[0] - 1,
                      table[-1] * 2 if table[-1] > 0 else table[-1] + 1,
                      np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)
    return np.concatenate([table, up, down, extra]).astype(np.float32)


def tables(rng, S):
    """Non-decreasing float32 tables of S entries: exp of a linspace (the
    head's kind), sorted normals, sorted small integers (many ties), one
    value repeated, and a run of ties at the top (the cap)."""
    lin = np.exp(np.linspace(np.log(0.11), np.log(20.0), S)).astype(
        np.float32)
    top = lin.copy()
    top[S // 2:] = top[-1]
    return {'linspace': lin,
            'normal': np.sort(rng.normal(size=S)).astype(np.float32),
            'ties': np.sort(rng.integers(0, max(S // 4, 1), S)).astype(
                np.float32),
            'constant': np.full(S, 1.5, np.float32),
            'ties_at_top': top}


SIZES = [1, 2, 3, 4, 5, 7, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 255,
         256, 257, 500, 1000, 1023, 1024]


@pytest.mark.parametrize('S', SIZES)
def test_search_equals_capped_count_on_edge_scales(S):
    """At every table size of SIZES (not only powers of two), on every
    table of `tables` and every edge scale, the search gives the capped
    count, ties included."""
    rng = np.random.default_rng(S)
    for label, table in tables(rng, S).items():
        trunk.require_nondecreasing(table)
        pv = np.concatenate([edge_scales(table),
                             rng.normal(size=256).astype(np.float32)])
        got = search_count(table, pv)
        want = linear_count(table, pv)
        assert np.array_equal(got, want), (S, label)
        assert got.max() <= S - 1


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 1024), st.integers(0, 2 ** 32 - 1))
def test_search_equals_capped_count_random(S, seed):
    """Random non-decreasing tables (values drawn from a few levels, so
    ties are common) and scales drawn from the entries and between them."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(size=rng.integers(1, S + 1)).astype(np.float32)
    table = np.sort(rng.choice(levels, S))
    pv = np.concatenate([edge_scales(table), rng.choice(table, 64),
                         rng.uniform(table[0] - 1, table[-1] + 1,
                                     64).astype(np.float32)])
    assert np.array_equal(search_count(table, pv), linear_count(table, pv))


def test_head_table_strictly_ascending_as_the_codec_builds_it():
    """The lossless head's 128-entry table, float32 as
    models/qresvae/fused.py builds it, is strictly ascending (the search's
    contract with room to spare), and the codec holds that table."""
    table = cdf.lossless_head_scale_table().astype('float32')
    assert table.shape == (128,) and (np.diff(table) > 0).all()
    trunk.require_nondecreasing(table)
    torch.manual_seed(0)
    import lvae_tpu_torch
    model = lvae_tpu_torch.get_model('qres_tiny_lossless', device='cpu')
    model.compress_mode(num_lanes=16)
    held = model._fused.head_table.numpy()
    assert held.dtype == np.float32 and np.array_equal(held, table)


@pytest.mark.parametrize('table', [
    [2.0, 1.0], [0.1, 0.2, 0.15, 0.3], [0.1, np.nan, 0.3], [np.nan], [],
    [1.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0))]])
def test_order_check_refuses_unordered_tables(table):
    """require_nondecreasing refuses a table that is not non-decreasing,
    one holding a NaN, and an empty one."""
    with pytest.raises(ValueError, match='non-decreasing'):
        trunk.require_nondecreasing(np.asarray(table, np.float32))


@pytest.mark.parametrize('table', [[1.0], [1.0, 1.0], [-0.0, 0.0, 2.0],
                                   [0.5, 0.5, 3.0, np.inf]])
def test_order_check_accepts_ties(table):
    trunk.require_nondecreasing(np.asarray(table, np.float32))
    trunk.require_nondecreasing(torch.tensor(table))


def test_oracle_wrappers_run_the_plain_versions_on_cpu():
    """nll_head_linear and zadd_dense_oldcore, the oracles of the two
    kernels, take the plain path on CPU tensors, as their kernels' wrappers
    do."""
    rng = np.random.default_rng(0)
    m = torch.as_tensor(rng.uniform(-1, 1, (1, 4, 8, 3)).astype(np.float32))
    r = torch.as_tensor(rng.uniform(-12, 3, (1, 4, 8, 3)).astype(np.float32))
    table = torch.as_tensor(cdf.lossless_head_scale_table().astype('float32'))
    for a, b in zip(trunk.nll_head_linear(m, r, table, 1 / 127.5),
                    trunk.nll_head(m, r, table, 1 / 127.5)):
        assert torch.equal(a, b)
    syms = torch.as_tensor(rng.integers(-40, 41, (2, 6, 16)),
                           dtype=torch.int32)
    pm = torch.as_tensor(rng.normal(size=(2, 6, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(16, 48)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=48).astype(np.float32))
    assert torch.equal(trunk.zadd_dense_oldcore(syms, pm, w, b),
                       trunk.zadd_dense(syms, pm, w, b))
