"""The port's fused-codec payload against the JAX package's: for the same
(symbols, indexes), pack_payload -> _assemble_body must give identical
payload arrays and wire bytes with no, sparse and dense escapes, and both
must refuse the same overflows."""
import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lvae_tpu.models import fused_base as jfb
from lvae_tpu.ops import cdf as jcdf
from lvae_tpu.utils import coding as jcoding

from lvae_tpu_torch.models import fused_base as tfb
from lvae_tpu_torch.ops import cdf as tcdf
from lvae_tpu_torch.utils import coding as tcoding


@pytest.fixture(scope='module')
def tables():
    return (jcdf.build_cdf_table(jcdf.default_gaussian_scale_table()),
            tcdf.build_cdf_table(tcdf.default_gaussian_scale_table()))


_SIZES = (700, 2100)


def _symbols(seed, n_escapes_per_chunk=0, dense_first_chunk=0):
    """In-range symbols with escapes injected at chosen positions."""
    rng = np.random.default_rng(seed)
    scales = jcdf.default_gaussian_scale_table()
    total = sum(_SIZES)
    idx = rng.integers(0, 64, total).astype(np.int32)
    vals = np.clip(np.round(rng.normal(0, scales[idx])), -2, 2).astype(np.int32)
    esc_pos = []
    for c in range(0, total, 1024):
        esc_pos += list(rng.choice(np.arange(c, min(c + 1024, total)),
                                   n_escapes_per_chunk, replace=False))
    esc_pos += list(rng.choice(1024, dense_first_chunk, replace=False))
    esc_pos = np.unique(np.asarray(esc_pos, np.int64))
    vals[esc_pos] = rng.integers(300, 5000, esc_pos.size) * rng.choice(
        [-1, 1], esc_pos.size)
    edges = np.cumsum((0,) + _SIZES)
    return ([vals[a:b] for a, b in zip(edges[:-1], edges[1:])],
            [idx[a:b] for a, b in zip(edges[:-1], edges[1:])], esc_pos.size)


def _codecs(tables, N, esc_cap, word_cap):
    jtab, ttab = tables
    jc = jfb.FusedCodecBase(None, jtab, num_lanes=N, esc_cap=esc_cap,
                            interpret=True, word_cap=word_cap)
    tc = tfb.FusedCodecBase(None, ttab, num_lanes=N, esc_cap=esc_cap,
                            word_cap=word_cap, device='cpu')
    return jc, tc


def jax_parse_unpadded(jc, body):
    """The JAX codec's parse_payload with its fixed-size buffers cut back
    to the stream's real lengths: (states, words in stream order, esc_pos,
    esc_val), as the port's parse_payload returns them."""
    n_words, n_esc = struct.unpack('<II', body[:8])
    states, packed, esc_pos, esc_val = jc.parse_payload(body)
    pk = np.asarray(packed).view(np.uint32)
    words = np.stack([pk & 0xFFFF, pk >> 16], 1).reshape(-1)[:n_words]
    return (np.asarray(states), words.astype(np.int32),
            np.asarray(esc_pos)[:n_esc], np.asarray(esc_val)[:n_esc])


def _payloads(jc, tc, vals, idxs):
    jp = jc.pack_payload([jnp.asarray(v) for v in vals],
                         [jnp.asarray(i) for i in idxs])
    tp = tc.pack_payload([torch.from_numpy(v) for v in vals],
                         [torch.from_numpy(i) for i in idxs])
    return np.asarray(jp), tp


@pytest.mark.parametrize('case,N,per_chunk,dense', [
    ('no-escapes', 16, 0, 0),
    ('sparse', 16, 5, 0),          # JAX: chunked compaction branch
    ('dense', 128, 2, 40),         # JAX: full scatter branch
])
def test_payload_bytes_identical(tables, case, N, per_chunk, dense):
    vals, idxs, n_esc = _symbols(11, per_chunk, dense)
    jc, tc = _codecs(tables, N, esc_cap=256, word_cap=None)
    jp, tp = _payloads(jc, tc, vals, idxs)
    assert tp.dtype == torch.int32
    assert np.array_equal(jp, tp.numpy())
    assert int(tp[1]) == n_esc
    jb = jc._payload_to_bytes(jnp.asarray(jp), (64, 64))
    tb = tc._payload_to_bytes(tp)
    assert tb == jb
    # both parsers read the body back identically
    got = tc.parse_payload(tb)
    assert got[1].size == int(tp[0]) and got[2].size == n_esc
    for a, b in zip(jax_parse_unpadded(jc, tb), got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_escape_overflow_raises(tables):
    vals, idxs, n_esc = _symbols(12, 10, 0)
    jc, tc = _codecs(tables, 64, esc_cap=16, word_cap=None)
    assert n_esc > 16
    jp, tp = _payloads(jc, tc, vals, idxs)
    assert np.array_equal(jp, tp.numpy())
    with pytest.raises(OverflowError):
        jc._payload_to_bytes(jnp.asarray(jp), (64, 64))
    with pytest.raises(OverflowError, match='escapes exceed'):
        tc._payload_to_bytes(tp)


def test_word_cap_overflow_raises(tables):
    vals, idxs, _ = _symbols(13, 0, 0)
    jc, tc = _codecs(tables, 64, esc_cap=256, word_cap=64)
    jp, tp = _payloads(jc, tc, vals, idxs)
    assert int(jp[0]) == int(tp[0]) > 64
    with pytest.raises(OverflowError):
        jc._payload_to_bytes(jnp.asarray(jp), (64, 64))
    with pytest.raises(OverflowError, match='coded words exceed'):
        tc._payload_to_bytes(tp)


@pytest.mark.parametrize('per_chunk,esc_cap', [(3, 64), (16, 64), (16, 20)])
def test_chunked_compaction_equals_scatter(per_chunk, esc_cap):
    """The port's one escape extraction (a scatter) against the JAX
    package's scatter-free chunked compaction, on its domain (<= 16
    escapes per 1024-symbol chunk), escapes past esc_cap included."""
    rng = np.random.default_rng(per_chunk + esc_cap)
    S = 3000
    mask = np.zeros(S, bool)
    for c in range(0, S, 1024):
        mask[rng.choice(np.arange(c, min(c + 1024, S)), per_chunk,
                        replace=False)] = True
    vals = rng.integers(-1000, 1000, S).astype(np.int32)
    got = tfb._extract_escapes_scatter(torch.from_numpy(mask),
                                       torch.from_numpy(vals), esc_cap)
    ref = jfb._compact_escapes_chunked(jnp.asarray(mask), jnp.asarray(vals),
                                       esc_cap)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_portable_stream_refused(tables):
    jc, tc = _codecs(tables, 16, esc_cap=256, word_cap=None)
    vals, idxs, _ = _symbols(14)
    _, tp = _payloads(jc, tc, vals, idxs)
    body = bytearray(tc._payload_to_bytes(tp))
    body[9] |= 0x80                                  # portable marker bit
    with pytest.raises(ValueError, match=r'stream trunk kind \(portable\) '
                       r'!= codec \(legacy\)'):
        tc.parse_payload(bytes(body))


@pytest.mark.parametrize('seed', [0, 1])
def test_states_and_escapes_serialization(seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(1 << 16, 1 << 32, 77, dtype=np.uint64).astype(
        np.uint32)
    states[:4] = [1 << 16, (1 << 16) + 255, (1 << 24) + 3, 0xFFFFFFFF]
    packed = tcoding.pack_states(states)
    assert packed == jcoding.pack_states(states)
    got, consumed = tcoding.unpack_states(packed + b'tail', states.size)
    assert np.array_equal(got, states) and consumed == len(packed)

    pos = np.sort(rng.integers(0, 1 << 20, 50))
    val = rng.integers(-(1 << 40), 1 << 40, 50)
    blob = tcoding.pack_escapes(pos, val)
    assert blob == jcoding.pack_escapes(pos, val)
    p2, v2, consumed = tcoding.unpack_escapes(blob + b'\x01', pos.size)
    assert np.array_equal(p2, pos) and np.array_equal(v2, val)
    assert consumed == len(blob)
    vals = rng.integers(0, 1 << 62, 40, dtype=np.uint64)
    assert tcoding.leb128_encode(vals) == jcoding.leb128_encode(vals)


def _write_png(path, arr, filters):
    """Minimal PNG writer that filters row r with filters[r % len]."""
    import struct as st
    import zlib
    h, w, c = arr.shape
    raw, prev = bytearray(), np.zeros(w * c, np.int64)
    for r in range(h):
        cur = arr[r].reshape(-1).astype(np.int64)
        f = filters[r % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][f]
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (st.pack('>I', len(data)) + kind + data
                + st.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = st.pack('>IIBBBBB', w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    path.write_bytes(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
                     + chunk(b'IDAT', zlib.compress(bytes(raw)))
                     + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [3, 4])
def test_read_png_all_filters(tmp_path, channels):
    from PIL import Image
    arr = np.random.default_rng(channels).integers(
        0, 256, (13, 17, channels)).astype(np.uint8)
    path = tmp_path / 'f.png'
    _write_png(path, arr, filters=[0, 1, 2, 3, 4, 4, 3])
    got = tcoding.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
    assert np.array_equal(got, arr[..., :3])
    assert np.array_equal(got, np.asarray(Image.open(path).convert('RGB')))


def _write_png_packed(path, rows, width, depth, color, filters, plte=b'',
                      interlace=0):
    """PNG writer for packed byte rows (H, stride) of any depth: row r
    filtered with filters[r % len] on bytes, bpp = max(1, bytes/pixel)."""
    import struct as st
    import zlib
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, channels * depth // 8)
    raw, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        f = filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][f]
        raw += bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row

    def chunk(kind, data):
        return (st.pack('>I', len(data)) + kind + data
                + st.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = st.pack('>IIBBBBB', width, rows.shape[0], depth, color, 0, 0,
                   interlace)
    path.write_bytes(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
                     + (chunk(b'PLTE', plte) if plte else b'')
                     + chunk(b'IDAT', zlib.compress(bytes(raw)))
                     + chunk(b'IEND', b''))


def _pil_image(kind, rng):
    """A PIL image of `kind` (L, LA, 1 or P<bits>), 37x29 random pixels,
    and the save options that keep its kind."""
    from PIL import Image
    a = rng.integers(0, 256, (37, 29)).astype(np.uint8)
    if kind == 'L':
        return Image.fromarray(a, 'L'), {}
    if kind == 'LA':
        return Image.fromarray(np.stack([a, a[::-1]], -1), 'LA'), {}
    if kind == '1':
        return Image.fromarray(a > 128).convert('1'), {}
    bits = int(kind[1:])
    im = Image.fromarray(a & ((1 << bits) - 1), 'P')
    im.putpalette(rng.integers(0, 256, 3 * (1 << bits)).tolist())
    return im, {'bits': bits}


@pytest.mark.parametrize('kind,depth,color', [
    ('L', 8, 0), ('LA', 8, 4), ('1', 1, 0),
    ('P1', 1, 3), ('P2', 2, 3), ('P4', 4, 3), ('P8', 8, 3)])
def test_read_png_gray_and_palette_like_pil(tmp_path, kind, depth, color):
    """Gray, gray+alpha and palette PNGs written by PIL read as PIL's
    convert('RGB') reads them."""
    import struct as st
    from PIL import Image
    im, opts = _pil_image(kind, np.random.default_rng(depth + color))
    path = tmp_path / f'{kind}.png'
    im.save(path, **opts)
    assert st.unpack('>BB', path.read_bytes()[24:26]) == (depth, color)
    got = tcoding.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (37, 29, 3)
    assert np.array_equal(got, np.asarray(Image.open(path).convert('RGB')))


@pytest.mark.parametrize('depth,color', [(1, 3), (2, 0), (4, 0), (4, 3)])
def test_read_png_sub_byte_filters(tmp_path, depth, color):
    """Sub-byte rows under all five filters (which then work on whole
    bytes, bpp 1), with a width that leaves padding bits in each row."""
    from PIL import Image
    rng = np.random.default_rng(depth)
    width, height = 13, 11
    vals = rng.integers(0, 1 << depth, (height, width))
    bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(height, -1)
    bits = np.pad(bits, ((0, 0), (0, -bits.shape[1] % 8)))
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    plte = rng.integers(0, 256, 3 * (1 << depth)).astype(np.uint8).tobytes()
    path = tmp_path / 'sub.png'
    _write_png_packed(path, rows, width, depth, color, [0, 1, 2, 3, 4, 1],
                      plte=plte if color == 3 else b'')
    got = tcoding.read_png(path)
    assert got.shape == (height, width, 3)
    assert np.array_equal(got, np.asarray(Image.open(path).convert('RGB')))


@pytest.mark.parametrize('depth,color,interlace,what', [
    (16, 2, 0, '16-bit'), (16, 0, 0, '16-bit'), (8, 2, 1, 'interlaced')])
def test_read_png_refuses_16_bit_and_interlaced(tmp_path, depth, color,
                                                interlace, what):
    """16-bit and Adam7-interlaced PNGs are read, not refused: as PIL's
    convert('RGB') reads them (every kind of each, and the 16-bit mapping,
    in tests/test_torch_png.py)."""
    import struct as st
    import zlib
    from PIL import Image
    path = tmp_path / f'{what}.png'
    channels = 3 if color == 2 else 1
    px = np.random.default_rng(depth + color).integers(
        0, 256, (4, 4, channels * depth // 8)).astype(np.uint8)
    if interlace:   # the Adam7 passes of a 4x4 image, each row unfiltered
        passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                  (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
        raw = b''.join(b'\x00' + px[r, c0::dc].tobytes()
                       for r0, c0, dr, dc in passes if c0 < 4
                       for r in range(r0, 4, dr))

        def chunk(kind, data):
            return (st.pack('>I', len(data)) + kind + data
                    + st.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))
        path.write_bytes(
            b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', st.pack('>IIBBBBB', 4, 4, depth, color, 0, 0, 1))
            + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))
    else:
        _write_png_packed(path, px.reshape(4, -1), 4, depth, color, [0])
    got = tcoding.read_png(path)
    assert got.shape == (4, 4, 3) and got.any()
    assert np.array_equal(got, np.asarray(Image.open(path).convert('RGB')))
