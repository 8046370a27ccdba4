"""The port's host coders byte for byte against the JAX package's: the
native per-block coder (ops/crans.py over csrc/crans.cpp, built by g++ into
_build/) and its numpy plain version (ops/rans_numpy.py), the native N-lane
interleaved encoder and its numpy oracle (ops/rans_interleaved.py), on the
QARV, the QRes latent and the lossless head's tables, with escapes far
outside the tables, empty blocks and N = 16 and 128; and the host stream's
container and the host index lookup."""
import numpy as np
import pytest

from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.ops import crans as jcrans
from lvae_tpu.ops import rans_numpy as jnumpy
from lvae_tpu.ops.rans_interleaved import InterleavedEncoder as JEncoder
from lvae_tpu.utils import coding as jcoding

from lvae_tpu_torch.ops import cdf as tcdf
from lvae_tpu_torch.ops import crans as tcrans
from lvae_tpu_torch.ops import rans_numpy as tnumpy
from lvae_tpu_torch.ops import rans_interleaved as tinter
from lvae_tpu_torch.utils import coding as tcoding

TABLES = {'qarv': 'default_gaussian_scale_table',
          'qres_latent': 'qres_latent_scale_table',
          'lossless_head': 'lossless_head_scale_table'}


@pytest.fixture(scope='module', params=sorted(TABLES))
def tables(request):
    name = TABLES[request.param]
    return (jcdf.build_cdf_table(getattr(jcdf, name)()),
            tcdf.build_cdf_table(getattr(tcdf, name)()))


def _symbols(rng, table, n, esc_rate=0.01):
    """Seeded (values, indexes): values drawn at their row's scale, a share
    of them escapes, some far outside any table (up to +-(2^31 - 2^16))."""
    S = table.scale_table.size
    idx = rng.integers(0, S, n).astype(np.int32)
    vals = np.round(rng.normal(0, table.scale_table[idx] * 1.3))
    esc = rng.random(n) < esc_rate
    vals[esc] = rng.integers(-5000, 5000, int(esc.sum()))
    far = rng.random(n) < esc_rate / 4
    vals[far] = rng.integers(-(2 ** 31) + 2 ** 16, 2 ** 31 - 2 ** 16,
                             int(far.sum()))
    return vals.astype(np.int32), idx


def test_tables_and_host_indexes_match(tables):
    jt, tt = tables
    for field in ('cdfs', 'cdf_lengths', 'offsets', 'scale_table'):
        assert np.array_equal(getattr(jt, field), getattr(tt, field))
    assert (jt.num_scales, jt.max_cdf_length) == (tt.num_scales,
                                                   tt.max_cdf_length)
    rng = np.random.default_rng(7)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(40), 3000))
    scales = np.concatenate([scales, tt.scale_table,
                             np.nextafter(tt.scale_table, 0),
                             np.nextafter(tt.scale_table, 1e9)])
    assert np.array_equal(tcdf.build_indexes_np(scales, tt.scale_table),
                          jcdf.build_indexes_np(scales, jt.scale_table))


@pytest.mark.parametrize('n', [0, 1, 2000])
@pytest.mark.parametrize('seed', [0, 1])
def test_per_block_coder_bytes_equal_the_jax_package(tables, n, seed):
    jt, tt = tables
    vals, idx = _symbols(np.random.default_rng(seed * 100 + n), tt, n)
    native = tcrans.encode_with_indexes(vals, idx, tt)
    plain = tnumpy.encode_with_indexes(vals, idx, tt)
    assert native == plain
    assert native == jcrans.encode_with_indexes(vals, idx, jt)
    assert native == jnumpy.encode_with_indexes(vals, idx, jt)
    for got in (tcrans.decode_with_indexes(native, idx, tt),
                tnumpy.decode_with_indexes(native, idx, tt)):
        assert np.array_equal(got, vals)
    assert np.array_equal(jcrans.decode_with_indexes(native, idx, jt), vals)


def test_codec_reuses_its_table_and_escapes_far_out(tables):
    """One RansCodec over many blocks (the host coder's use), every
    value an escape at the int32 extremes' neighbourhood."""
    jt, tt = tables
    codec = tcrans.RansCodec(tt)
    rng = np.random.default_rng(3)
    for n in (0, 5, 300):
        idx = rng.integers(0, tt.scale_table.size, n).astype(np.int32)
        vals = rng.choice(np.array([2 ** 31 - 2 ** 16, -(2 ** 31) + 2 ** 16,
                                    70000, -70000], np.int32), n)
        s = codec.encode_with_indexes(vals, idx)
        assert s == jcrans.RansCodec(jt).encode_with_indexes(vals, idx)
        assert np.array_equal(codec.decode_with_indexes(s, idx), vals)


def _blocks(rng, table, sizes):
    out = [_symbols(rng, table, n, esc_rate=0.02) for n in sizes]
    return [v for v, _ in out], [i for _, i in out]


@pytest.mark.parametrize('N', [16, 128])
@pytest.mark.parametrize('sizes', [(313, 0, 1025, 64, 7), (0,), (129, 128)])
def test_interleaved_encode_equals_jax_and_both_oracles(tables, N, sizes):
    jt, tt = tables
    vals, idxs = _blocks(np.random.default_rng(N + len(sizes)), tt, sizes)
    flat_v = np.concatenate(vals)
    flat_i = np.concatenate(idxs)
    got = tcrans.interleaved_encode(flat_v, flat_i, list(sizes), tt,
                                    num_lanes=N)
    want = jcrans.interleaved_encode(flat_v, flat_i, list(sizes), jt,
                                     num_lanes=N)
    tenc, jenc = tinter.InterleavedEncoder(tt, N), JEncoder(jt, N)
    for v, ix in zip(vals, idxs):
        tenc.append_block(v, ix)
        jenc.append_block(v, ix)
    for other in (want, tenc.finish(), jenc.finish()):
        for a, b in zip(got, other):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    states, words, escapes = got
    if flat_v.size:
        assert len(escapes) > 0
    dec = tinter.decode_interleaved(states, words, idxs, tt, escapes,
                                    num_lanes=N)
    for a, b in zip(dec, vals):
        assert np.array_equal(a, b)


def test_out_of_range_input_is_refused(tables):
    """The native coder reads rows and bytes unchecked: indexes outside
    the table and a string shorter than its state are refused first."""
    _, tt = tables
    codec = tcrans.RansCodec(tt)
    vals = np.zeros(4, np.int32)
    for bad in (np.array([0, 1, tt.num_scales, 2]), np.array([-1, 0, 0, 0])):
        with pytest.raises(ValueError, match='scale indexes'):
            codec.encode_with_indexes(vals, bad)
        with pytest.raises(ValueError, match='scale indexes'):
            codec.decode_with_indexes(b'\0' * 16, bad)
        with pytest.raises(ValueError, match='scale indexes'):
            tcrans.interleaved_encode(vals, bad, [4], tt, num_lanes=16)
    with pytest.raises(ValueError, match='truncated'):
        codec.decode_with_indexes(b'\1' * 7, np.zeros(4, np.int32))


def test_interleaved_capacity_raises(tables):
    _, tt = tables
    vals = np.full(40, 10 ** 6, np.int32)
    idx = np.zeros(40, np.int32)
    with pytest.raises(OverflowError):
        tcrans.interleaved_encode(vals, idx, [40], tt, num_lanes=16,
                                  escapes_capacity=8)


@pytest.mark.parametrize('lengths', [(), (0,), (5, 0, 17), (1000,) * 3])
def test_byte_string_container_equals_jax(lengths):
    rng = np.random.default_rng(len(lengths))
    strings = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in lengths]
    packed = tcoding.pack_byte_strings(strings)
    assert packed == jcoding.pack_byte_strings(strings)
    assert tcoding.unpack_byte_string(packed) == strings
    assert jcoding.unpack_byte_string(packed) == strings


def test_build_raises_without_a_usable_source(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    output (into a library path of the test's own)."""
    bad = tmp_path / 'crans.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(tcrans, 'SOURCE', bad)
    monkeypatch.setattr(tcrans, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(tcrans, 'LIBRARY', tmp_path / 'build' / 'x.so')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        tcrans.build()


def test_library_builds_into_the_package_build_directory():
    info = tcrans.build()
    assert tcrans.LIBRARY.exists()
    assert tcrans.LIBRARY.parent.name == '_build'
    assert tcrans.LIBRARY.parent.parent.name == 'lvae_tpu_torch'
    assert 'march=native' not in info['cmd'] and 'nvcc' not in info['cmd']
