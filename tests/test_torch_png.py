"""The port's PNG reader (lvae_tpu_torch/utils/coding.py:read_png) against
Pillow's Image.open(path).convert('RGB'), which the JAX package's
compress_file reads images with (lvae_tpu/models/qarv/model.py:1151,
lvae_tpu/models/qresvae/model.py:922): 8-bit PNGs written by Pillow, 16-bit
and Adam7-interlaced PNGs written by the small numpy/zlib writer below
(Pillow writes neither), and the committed images. A JPEG stays refused:
the port carries no decoder but its PNG reader.
"""
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from lvae_tpu_torch.utils import coding

ROOT = Path(__file__).resolve().parent.parent
SIZES = [(1, 1), (3, 5), (13, 11)]             # (H, W); 13x11 has all 7
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # Adam7 passes non-empty
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _pack(samples, depth):
    """(h, w, channels) integer samples -> (h, row bytes) packed rows:
    big-endian at 16 bits, MSB-first bits below 8, each row padded to a
    byte."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype('>u2').view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(h, -1)
    bits = np.pad(bits, ((0, 0), (0, -bits.shape[1] % 8)))
    return np.packbits(bits.astype(np.uint8), axis=1)


def _filter(rows, bpp, filters):
    """Packed rows -> the filtered stream, row r under filters[r % len]
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth, on bytes)."""
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
    return bytes(raw)


def _write_png(path, samples, depth, color, interlace=0,
               filters=(0, 1, 2, 3, 4), plte=b''):
    """Write samples (H, W, channels) as a PNG of this depth and colour
    type; interlace=1 writes the seven Adam7 passes, each filtered on its
    own."""
    H, W, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b''.join(_filter(_pack(samples[r0::dr, c0::dc], depth), bpp,
                               filters)
                       for r0, c0, dr, dc in ADAM7
                       if samples[r0::dr, c0::dc].size)
    else:
        raw = _filter(_pack(samples, depth), bpp, filters)

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack('>IIBBBBB', W, H, depth, color, 0, 0, interlace)
    path.write_bytes(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
                     + (chunk(b'PLTE', plte) if plte else b'')
                     + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def _samples(rng, H, W, depth, color):
    """Random samples; at 16 bits half of them below 512, where clipping
    at 255 and keeping the high byte part ways."""
    shape = (H, W, CHANNELS[color])
    if depth == 16:
        wide = rng.integers(0, 1 << 16, shape)
        return np.where(rng.random(shape) < 0.5, wide % 512, wide)
    return rng.integers(0, 1 << depth, shape)


def _assert_like_pil(path, H, W):
    got = coding.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert np.array_equal(got, np.asarray(Image.open(path).convert('RGB')))


@pytest.mark.parametrize('H,W', SIZES)
@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA'])
def test_read_png_8bit_written_by_pil(tmp_path, mode, H, W):
    rng = np.random.default_rng(H * W)
    bands = len(mode)
    a = rng.integers(0, 256, (H, W, bands)).astype(np.uint8)
    path = tmp_path / 'pil.png'
    Image.fromarray(a[..., 0] if bands == 1 else a, mode).save(path)
    _assert_like_pil(path, H, W)


@pytest.mark.parametrize('H,W', SIZES)
@pytest.mark.parametrize('color', [0, 2, 4, 6])
def test_read_png_16bit_like_pil(tmp_path, color, H, W):
    """16-bit gray, RGB, gray+alpha and RGBA under all five filters (bpp 2
    to 8): gray clips at 255, the others keep the high byte, as Pillow."""
    samples = _samples(np.random.default_rng(color + H), H, W, 16, color)
    path = tmp_path / 'deep.png'
    _write_png(path, samples, 16, color, filters=(4, 3, 1, 2, 0))
    _assert_like_pil(path, H, W)


@pytest.mark.parametrize('H,W', SIZES)
@pytest.mark.parametrize('depth,color', [
    (8, 0), (8, 2), (8, 4), (8, 6), (16, 0), (16, 2), (16, 4), (16, 6),
    (2, 0), (4, 3), (1, 3)])
def test_read_png_adam7_like_pil(tmp_path, depth, color, H, W):
    """Adam7 at 8 and 16 bits and below a byte (each pass's rows padded to
    a byte), every filter within each pass, the small sizes leaving some
    passes empty."""
    rng = np.random.default_rng(depth * 7 + color + H)
    samples = _samples(rng, H, W, depth, color)
    plte = (rng.integers(0, 256, 3 << depth).astype(np.uint8).tobytes()
            if color == 3 else b'')
    path = tmp_path / 'adam7.png'
    _write_png(path, samples, depth, color, interlace=1,
               filters=(1, 4, 2, 3, 0), plte=plte)
    _assert_like_pil(path, H, W)


def test_read_png_adam7_truncated_raises(tmp_path):
    samples = _samples(np.random.default_rng(0), 13, 11, 8, 2)
    path = tmp_path / 'cut.png'
    _write_png(path, samples[:12], 8, 2, interlace=1)
    data = bytearray(path.read_bytes())
    data[16:20] = struct.pack('>I', 13)       # claim one row more
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29]))
                              & 0xFFFFFFFF)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='truncated'):
        coding.read_png(path)


def test_read_png_refuses_jpeg(tmp_path):
    path = tmp_path / 'photo.jpg'
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match='not a PNG file'):
        coding.read_png(path)


@pytest.mark.parametrize('name', sorted(p.name for p in
                                        (ROOT / 'images').glob('*.png')))
def test_read_png_committed_images_like_pil(name):
    path = ROOT / 'images' / name
    with Image.open(path) as im:
        want = np.asarray(im.convert('RGB'))
    assert np.array_equal(coding.read_png(path), want)
