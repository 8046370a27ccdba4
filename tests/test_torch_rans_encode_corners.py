"""The rANS encode at its corners, on the CPU.

`chip_smoke.rans_encode_corner_cases` draws the inputs the card checks hold
the CUDA encode on (every lane renormalising on every row, none, empty and
tail rows, one row, out-of-range indexes and symbols, the word capacity cut
inside a row, at 1 and at T * N, many rows at N = 1); here they are drawn
small. The port's plain versions are held against the JAX package's Pallas
kernels in interpret mode, and against a numpy mirror of the CUDA encode's
four phases (csrc/rans.cu: lookup, lane chains, scan, placement). The
mirror's division (`coding_params`: a reciprocal and one correction in
place of u32 / and %) is held against // and % for every 16-bit frequency.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.ops.pallas import rans_decode as jrd
from lvae_tpu.ops.pallas import rans_encode as jre

from lvae_tpu_torch.ops import cdf as tcdf
from lvae_tpu_torch.ops import rans_decode as trd
from lvae_tpu_torch.ops import rans_encode as tre

ROWS = 24
LANES = (1, 16, 31, 32, 33, 48, 64, 100, 128)
NAMES = ('every_lane_renormalises', 'no_lane_renormalises',
         'empty_and_tail_rows', 'one_row', 'out_of_range',
         'w_cap_inside_row', 'w_cap_one', 'w_cap_all')
CASES = [(N, name) for N in LANES for name in NAMES] + [(1, 'long_scan')]
M32 = (1 << 32) - 1


@functools.lru_cache(maxsize=None)
def _table():
    """The latent table, sentinel-padded, as the JAX package builds it
    (the same as the port's: tests/test_torch_rans.py)."""
    jtab = jcdf.build_cdf_table(jcdf.default_gaussian_scale_table())
    cdfs, _ = jrd.prepare_device_cdf(jtab)
    ttab = tcdf.build_cdf_table(tcdf.default_gaussian_scale_table())
    assert np.array_equal(cdfs, trd.prepare_device_cdf(ttab)[0])
    return cdfs


@functools.lru_cache(maxsize=None)
def _cases(N):
    return dict(chip_smoke.rans_encode_corner_cases(
        np, _table(), N, rows=ROWS, long_rows=2 * ROWS))


def _plain(case, b):
    return tre.rans_encode_all_plain(
        torch.from_numpy(case['syms'][b]),
        torch.from_numpy(case['indexes'][b]), case['row_n'],
        torch.from_numpy(_table()), case['w_cap'])


def _words(pairs, n):
    return tre.pairs_to_words(np.asarray(pairs), n)


# ---- the numpy mirror of csrc/rans.cu's encode -----------------------------

def coding_params(start, freq):
    """csrc/rans.cu coding_params: (start, freq, rcp, k), uint64 arrays of
    u32 values."""
    freq = np.asarray(freq, np.uint64)
    rcp = np.where(freq == 0, 0, M32 // np.maximum(freq, 1))
    k = np.where(freq == 0, 0xFFFF0000, ((1 << 16) - freq) & M32)
    return (np.asarray(start, np.uint64) & M32, freq, rcp.astype(np.uint64),
            k.astype(np.uint64))


def chain_update(xs, params):
    """The chain's state update of csrc/rans.cu rans_encode_chain_kernel
    (after the flag): q0 = umulhi(xs, rcp), one correction, q * k + xs +
    start (mod 2^32). -> (new state, q)."""
    start, freq, rcp, k = params
    xs = np.asarray(xs, np.uint64)
    q0 = (xs * rcp) >> 32
    q = q0 + (((xs - q0 * freq) & M32) >= freq)
    return (q * k + xs + start) & M32, q


def four_phase_mirror(syms, indexes, row_n, cdfs, w_cap):
    """The CUDA encode's four phases for one image, in numpy: lookup,
    lane chains (ballots of 32 lanes, words where flagged), the push-order
    scan of the rows' counts, the placement. -> (u16 words below w_cap, in
    a zero-filled buffer of w_cap, n_words, states u32)."""
    T, N = syms.shape
    S, L = cdfs.shape
    ix = np.clip(indexes, 0, S - 1)
    sy = np.clip(syms, 0, L - 2)
    c = cdfs.astype(np.int64)
    start = c[ix, sy].astype(np.uint64) & M32
    freq = (c[ix, sy + 1] - c[ix, sy]).astype(np.uint64) & M32
    active = np.arange(N)[None] < np.asarray(row_n)[:, None]
    params = coding_params(start, freq)
    params = tuple(np.where(active, p, inactive)
                   for p, inactive in zip(params, (0, M32, 0, 0)))
    nw = -(-N // 32)
    x = np.full(N, 1 << 16, np.uint64)
    dense = np.zeros((T, N), np.uint64)
    ballots = np.zeros((T, nw), np.uint64)
    for t in range(T - 1, -1, -1):
        p = tuple(q[t] for q in params)
        flag = (x >> 16) >= p[1]
        dense[t] = np.where(flag, x & 0xFFFF, 0)
        bits = np.zeros(nw * 32, np.uint64)
        bits[:N] = flag
        ballots[t] = (bits.reshape(nw, 32)
                      << np.arange(32, dtype=np.uint64)).sum(1)
        x, _ = chain_update(np.where(flag, x >> 16, x), p)
    counts = np.array([sum(bin(int(b)).count('1') for b in row)
                       for row in ballots])
    base = np.zeros(T, np.int64)
    base[::-1] = np.concatenate([[0], np.cumsum(counts[::-1])[:-1]])
    out = np.zeros(w_cap, np.uint16)
    for t in range(T):
        for lane in range(N):
            w, bit = divmod(lane, 32)
            if not (int(ballots[t, w]) >> bit) & 1:
                continue
            pos = base[t] + bin(int(ballots[t, w]) >> (bit + 1)).count('1')
            pos += sum(bin(int(b)).count('1') for b in ballots[t, w + 1:])
            if pos < w_cap:
                out[pos] = dense[t, lane]
    return out, int(counts.sum()), x.astype(np.uint32)


# ---- the corners -------------------------------------------------------------

@pytest.mark.parametrize('N,name', CASES)
def test_plain_matches_jax_kernel(N, name):
    """Each image of the case through rans_encode_all_plain and the JAX
    kernel in interpret mode: pairs, n_words and states alike. The JAX
    kernel packs (index, symbol) into one int32, so it takes the clamped
    values (the port clamps inside). Every JAX call has w_cap = T * N (one
    compile a shape): past a smaller w_cap the JAX kernel piles the words
    into its last window where the port stores none, so there the first
    w_cap words are compared and the port's later ones must be zero, as in
    tests/test_torch_rans.py::test_encode_word_cap_overflow_counts_exactly."""
    case = _cases(N)[name]
    cdfs = _table()
    S, L = cdfs.shape
    T = len(case['row_n'])
    w_cap = case['w_cap']
    for b in range(len(case['syms'])):
        sy = np.clip(case['syms'][b], 0, L - 2)
        ix = np.clip(case['indexes'][b], 0, S - 1)
        jbuf, jn, jst = jre.rans_encode_all(
            jnp.asarray(sy), jnp.asarray(ix), case['row_n'],
            jnp.asarray(cdfs), num_lanes=N, w_cap=T * N, interpret=True)
        tbuf, tn, tst = _plain(case, b)
        assert int(tn) == int(jn)
        assert np.array_equal(tst.numpy(), np.asarray(jst))
        if w_cap == T * N:
            assert np.array_equal(tbuf.numpy(), np.asarray(jbuf))
        else:
            stored = min(w_cap, int(tn))
            assert np.array_equal(_words(tbuf, stored),
                                  _words(jbuf, stored))
            assert not _words(tbuf, 2 * tbuf.numel())[stored:].any()


@pytest.mark.parametrize('N,name', CASES)
def test_plain_matches_four_phase_mirror(N, name):
    """The numpy mirror of the CUDA encode's four phases gives each image's
    words, count and states as rans_encode_all_plain."""
    case = _cases(N)[name]
    for b in range(len(case['syms'])):
        words, n, states = four_phase_mirror(
            case['syms'][b], case['indexes'][b], case['row_n'], _table(),
            case['w_cap'])
        tbuf, tn, tst = _plain(case, b)
        assert n == int(tn)
        assert np.array_equal(words, _words(tbuf, case['w_cap']))
        assert np.array_equal(states.view(np.int32), tst.numpy()[0])


@pytest.mark.parametrize('N,name', CASES)
def test_multi_plain_matches_single_plain(N, name):
    """rans_encode_all_multi_plain on the first B images (B = 1, 2, 3, 6)
    equals B rans_encode_all_plain calls."""
    case = _cases(N)[name]
    alone = [_plain(case, b) for b in range(len(case['syms']))]
    for B in chip_smoke.ENCODE_CORNER_BATCHES:
        pairs, n, st = tre.rans_encode_all_multi_plain(
            torch.from_numpy(case['syms'][:B]),
            torch.from_numpy(case['indexes'][:B]), case['row_n'],
            torch.from_numpy(_table()), case['w_cap'])
        for b, (p1, n1, st1) in enumerate(alone[:B]):
            assert torch.equal(pairs[b], p1) and torch.equal(n[b], n1)
            assert torch.equal(st[b], st1[0])


@pytest.mark.parametrize('B', [2, 3, 6])
def test_multi_plain_matches_jax_multi_kernel(B):
    """rans_encode_all_multi_plain against the JAX multi-image kernel in
    interpret mode, on the first B images of the empty_and_tail_rows case
    at N = 33 (a ragged second warp)."""
    case = _cases(33)['empty_and_tail_rows']
    cdfs = _table()
    jout = jre.rans_encode_all_multi(
        jnp.asarray(case['syms'][:B]), jnp.asarray(case['indexes'][:B]),
        case['row_n'], jnp.asarray(cdfs), num_lanes=33, interpret=True)
    tout = tre.rans_encode_all_multi_plain(
        torch.from_numpy(case['syms'][:B]),
        torch.from_numpy(case['indexes'][:B]), case['row_n'],
        torch.from_numpy(cdfs))
    for j, t in zip(jout, tout):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_corner_names_are_chip_smokes():
    """The names above are those chip_smoke draws."""
    assert tuple(_cases(16)) == NAMES
    assert tuple(_cases(1)) == NAMES + ('long_scan',)
    assert LANES == chip_smoke.ENCODE_CORNER_LANES


# ---- the chain's division ------------------------------------------------------

_FREQ = np.arange(1, 1 << 16, dtype=np.uint64)
_X = {'zero': lambda f, rng: np.zeros_like(f),
      'freq_minus_one': lambda f, rng: f - 1,
      'freq': lambda f, rng: f,
      'freq_shl16_minus_one': lambda f, rng: (f << 16) - 1,
      'all_ones': lambda f, rng: np.full_like(f, M32),
      'random': lambda f, rng: rng.integers(0, 1 << 32, f.size,
                                            dtype=np.uint64)}


@pytest.mark.parametrize('x', list(_X))
def test_chain_division_exact_for_every_16_bit_freq(x):
    """coding_params' reciprocal and one correction give xs // freq, and
    the update ((xs // freq) << 16) + xs % freq + start (mod 2^32), for
    every freq in [1, 65535] at xs = 0, freq - 1, freq, (freq << 16) - 1,
    2^32 - 1 and random (20 draws)."""
    rng = np.random.default_rng(7)
    for _ in range(20 if x == 'random' else 1):
        xs = _X[x](_FREQ, rng)
        start = rng.integers(0, 1 << 16, _FREQ.size, dtype=np.uint64)
        new, q = chain_update(xs, coding_params(start, _FREQ))
        assert np.array_equal(q, xs // _FREQ)
        assert np.array_equal(
            new, (((xs // _FREQ) << 16) + xs % _FREQ + start) & M32)


@pytest.mark.parametrize('freq', ['zero', 'above_16_bits', 'inactive'])
def test_chain_division_outside_16_bits(freq):
    """freq 0 takes the native u32 division's result (xs / 0 = 2^32 - 1,
    xs % 0 = xs); freq in [2^16, 2^32) is exact too; an inactive lane's
    parameters leave every state unchanged."""
    rng = np.random.default_rng(8)
    xs = np.concatenate([np.array([0, 1, 0xFFFF, 1 << 16, M32], np.uint64),
                         rng.integers(0, 1 << 32, 10 ** 5, dtype=np.uint64)])
    start = rng.integers(0, 1 << 32, xs.size, dtype=np.uint64)
    if freq == 'zero':
        new, _ = chain_update(xs, coding_params(start, np.zeros_like(xs)))
        assert np.array_equal(new, ((M32 << 16) + xs + start) & M32)
    elif freq == 'above_16_bits':
        f = rng.integers(1 << 16, 1 << 32, xs.size, dtype=np.uint64)
        new, q = chain_update(xs, coding_params(start, f))
        assert np.array_equal(q, xs // f)
        assert np.array_equal(new, ((q << 16) + xs % f + start) & M32)
    else:
        params = tuple(np.full_like(xs, v) for v in (0, M32, 0, 0))
        assert np.array_equal(chain_update(xs, params)[0], xs)
