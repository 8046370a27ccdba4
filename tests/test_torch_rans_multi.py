"""The port's multi-image rANS kernels' plain versions against the JAX
package's (run in interpret mode) and against B calls of the port's single
plain versions: values, states and pointers on decode, pairs, word counts
and states on encode, all byte-identical. The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.

Every image of a batch shares one block layout (the batch has one image
shape), with ragged tail rows and 2% escapes; the symbols differ per image.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.ops.pallas import rans_decode as jrd
from lvae_tpu.ops.pallas import rans_encode as jre

from lvae_tpu_torch.models import fused_base as tfb
from lvae_tpu_torch.ops import cdf as tcdf
from lvae_tpu_torch.ops import rans_decode as trd
from lvae_tpu_torch.ops import rans_encode as tre

# block sizes with tail rows at both lane counts
_SIZES = (300, 7, 129, 1000)


@pytest.fixture(scope='module')
def table():
    return tcdf.build_cdf_table(tcdf.default_gaussian_scale_table())


def _blocks(B, N, seed, esc_rate=0.02):
    """B images' symbols in rows: (vals per image per block, syms (B,T,N),
    idx (B,T,N), row_n (T,)) as numpy."""
    scales = jcdf.default_gaussian_scale_table()
    per_image = []
    for b in range(B):
        rng = np.random.default_rng(1000 * seed + 10 * N + b)
        vals, idxs = [], []
        for sz in _SIZES:
            idx = rng.integers(0, 64, sz).astype(np.int32)
            v = np.round(rng.normal(0, scales[idx] * 1.5)).astype(np.int32)
            esc = rng.random(sz) < esc_rate
            v[esc] = rng.integers(-500, 500, int(esc.sum()))
            vals.append(v)
            idxs.append(idx)
        per_image.append((vals, idxs) + tre.blocks_to_rows(vals, idxs, N))
    row_n = per_image[0][4]
    assert (row_n < N).any()
    return (per_image, np.stack([p[2] for p in per_image]),
            np.stack([p[3] for p in per_image]), row_n)


def _inband(table, syms, idx):
    inband, esc = tre.prepare_inband(torch.from_numpy(syms),
                                     torch.from_numpy(idx), table.offsets,
                                     table.cdf_lengths)
    assert bool(esc.any())
    return inband


def _cdfs(table):
    cdfs, offs = trd.prepare_device_cdf(table)
    return torch.from_numpy(cdfs), torch.from_numpy(offs)


@pytest.mark.parametrize('B,N', [(2, 16), (3, 128)])
def test_encode_multi_plain_matches_jax_and_single(table, B, N):
    _, syms, idx, row_n = _blocks(B, N, seed=1)
    inband = _inband(table, syms, idx)
    cdfs, _ = _cdfs(table)
    idx_t = torch.from_numpy(idx)
    pairs, n_words, states = tre.rans_encode_all_multi(
        inband, idx_t, row_n, cdfs, num_lanes=N)
    assert pairs.dtype == n_words.dtype == states.dtype == torch.int32
    assert pairs.shape == (B, tre.pair_capacity(inband.shape[1] * N))
    assert n_words.shape == (B,) and states.shape == (B, N)
    jp, jn, js = jre.rans_encode_all_multi(
        jnp.asarray(inband.numpy()), jnp.asarray(idx), row_n,
        jnp.asarray(cdfs.numpy()), num_lanes=N, interpret=True)
    assert np.array_equal(np.asarray(jp), pairs.numpy())
    assert np.array_equal(np.asarray(jn), n_words.numpy())
    assert np.array_equal(np.asarray(js), states.numpy())
    for b in range(B):
        p1, n1, s1 = tre.rans_encode_all_plain(inband[b], idx_t[b], row_n,
                                               cdfs)
        assert torch.equal(pairs[b], p1) and int(n_words[b]) == int(n1)
        assert torch.equal(states[b], s1.reshape(N))


def test_encode_multi_word_cap_counts_exactly(table):
    """Below the streams' length, words past w_cap are counted but not
    stored: n_words equals the uncapped count, the stored words are the
    uncapped stream's first w_cap, and the payload assembly refuses the
    stream with OverflowError."""
    B, N, w_cap = 2, 16, 300
    per_image, syms, idx, row_n = _blocks(B, N, seed=2)
    inband = _inband(table, syms, idx)
    cdfs, _ = _cdfs(table)
    idx_t = torch.from_numpy(idx)
    full = tre.rans_encode_all_multi(inband, idx_t, row_n, cdfs, num_lanes=N)
    capped = tre.rans_encode_all_multi(inband, idx_t, row_n, cdfs,
                                       num_lanes=N, w_cap=w_cap)
    assert capped[0].shape == (B, tre.pair_capacity(w_cap))
    assert torch.equal(capped[1], full[1]) and bool((full[1] > w_cap).all())
    assert torch.equal(capped[2], full[2])
    for b in range(B):
        single = tre.rans_encode_all_plain(inband[b], idx_t[b], row_n, cdfs,
                                           w_cap)
        assert torch.equal(capped[0][b], single[0])
        words = tre.pairs_to_words(capped[0][b].numpy(),
                                   2 * capped[0].shape[1])
        assert np.array_equal(words[:w_cap], tre.pairs_to_words(
            full[0][b].numpy(), w_cap))
        assert not words[w_cap:].any()
    codec = tfb.FusedCodecBase(None, table, num_lanes=N, word_cap=w_cap,
                               device='cpu')
    # per latent block, the (B, size) values and indexes
    vals = [torch.from_numpy(np.stack(v))
            for v in zip(*[p[0] for p in per_image])]
    idxs = [torch.from_numpy(np.stack(i))
            for i in zip(*[p[1] for p in per_image])]
    with pytest.raises(OverflowError, match='coded words exceed'):
        codec._payloads_to_bytes(codec.pack_payload_batch(vals, idxs))


def _streams(table, B, N, seed):
    """B images encoded by the single plain encoder: (per_image, idx
    (B,T,N), streams (B,W) zero-padded, states (B,N), n_words)."""
    per_image, syms, idx, row_n = _blocks(B, N, seed)
    inband = _inband(table, syms, idx)
    cdfs, _ = _cdfs(table)
    words, states, n_words = [], [], []
    for b in range(B):
        p, n, s = tre.rans_encode_all_plain(inband[b], torch.from_numpy(
            idx[b]), row_n, cdfs)
        words.append(tre.pairs_to_words(p.numpy(), int(n))[::-1])
        states.append(s.reshape(N))
        n_words.append(int(n))
    streams = np.zeros((B, max(n_words) + 5), np.int32)   # ragged + padding
    for b, w in enumerate(words):
        streams[b, :w.size] = w
    return per_image, idx, streams, torch.stack(states), n_words


@pytest.mark.parametrize('B,N', [(3, 16), (2, 128)])
def test_decode_multi_plain_matches_jax_and_single(table, B, N):
    per_image, idx, streams, states, n_words = _streams(table, B, N, seed=3)
    assert len(set(n_words)) == B                 # streams of other lengths
    cdfs, offs = _cdfs(table)
    jcdfs, joffs = jnp.asarray(cdfs.numpy()), jnp.asarray(offs.numpy())
    st_m, pt_m = states, torch.zeros(B, dtype=torch.int32)
    j_st, j_pt = jnp.asarray(states.numpy()), jnp.zeros((B,), jnp.int32)
    st_1 = [states[b:b + 1] for b in range(B)]
    pt_1 = [torch.zeros((), dtype=torch.int32) for _ in range(B)]
    streams_t = torch.from_numpy(streams)
    row0 = 0
    for bi, size in enumerate(_SIZES):
        T = -(-size // N)
        rows = torch.from_numpy(np.ascontiguousarray(idx[:, row0:row0 + T]))
        vals, st_m, pt_m = trd.rans_decode_block_multi(
            rows, st_m, pt_m, streams_t, cdfs, offs, size, num_lanes=N)
        assert vals.shape == (B, T, N) and vals.dtype == torch.int32
        assert st_m.shape == (B, N) and pt_m.shape == (B,)
        jv, j_st, j_pt = jrd.rans_decode_block_multi(
            jnp.asarray(rows.numpy()), j_st, j_pt, jnp.asarray(streams),
            jcdfs, joffs, jnp.int32(size), num_lanes=N, interpret=True)
        assert np.array_equal(np.asarray(jv), vals.numpy())
        assert np.array_equal(np.asarray(j_st), st_m.numpy())
        assert np.array_equal(np.asarray(j_pt), pt_m.numpy())
        for b in range(B):
            v1, st_1[b], pt_1[b] = trd.rans_decode_block_plain(
                rows[b], st_1[b], pt_1[b], streams_t[b], cdfs, offs, size)
            assert torch.equal(vals[b], v1)
            assert torch.equal(st_m[b], st_1[b].reshape(N))
            assert int(pt_m[b]) == int(pt_1[b])
            # in-band values decode as coded, escapes as the escape bin
            v = per_image[b][0][bi]
            off = table.offsets[per_image[b][1][bi]]
            max_sym = table.cdf_lengths[per_image[b][1][bi]] - 2
            esc = (v - off < 0) | (v - off >= max_sym)
            got = vals[b].numpy().reshape(-1)[:size]
            assert np.array_equal(got[~esc], v[~esc])
        row0 += T
    assert pt_m.tolist() == n_words


def test_multi_wrappers_take_plain_path_on_cpu(table):
    """On CPU tensors the multi wrappers launch nothing; other devices and
    wrong lane counts are refused."""
    before = (tre.rans_encode_all_multi.launches,
              trd.rans_decode_block_multi.launches)
    _, idx, streams, states, _ = _streams(table, 2, 16, seed=4)
    _, syms, _, row_n = _blocks(2, 16, seed=4)
    cdfs, offs = _cdfs(table)
    idx_t = torch.from_numpy(idx)
    tre.rans_encode_all_multi(_inband(table, syms, idx), idx_t, row_n, cdfs,
                              num_lanes=16)
    T = -(-_SIZES[0] // 16)
    trd.rans_decode_block_multi(idx_t[:, :T].contiguous(), states,
                                torch.zeros(2, dtype=torch.int32),
                                torch.from_numpy(streams), cdfs, offs,
                                _SIZES[0], num_lanes=16)
    assert (tre.rans_encode_all_multi.launches,
            trd.rans_decode_block_multi.launches) == before
    x = torch.zeros((2, 3, 16), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tre.rans_encode_all_multi(x, x, np.full(3, 16), x, num_lanes=16)
    with pytest.raises(ValueError, match='unsupported device'):
        trd.rans_decode_block_multi(x, x[:, 0], x[:, 0, 0], x[:, 0], x,
                                    x[0, 0], 48, num_lanes=16)
    with pytest.raises(ValueError, match='lanes'):
        trd.rans_decode_block_multi(torch.zeros((2, 3, 16), dtype=torch.int32),
                                    None, None, None, None, None, 48,
                                    num_lanes=32)
