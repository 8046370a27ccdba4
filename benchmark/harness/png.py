"""A PNG reader of the benchmark's own (zlib and numpy): 8-bit RGB and RGBA,
not interlaced, which is what the benchmark's photographs are."""
import struct
import zlib

import numpy as np


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    out = bytearray(h * stride)
    prev = bytearray(stride)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        cur = bytearray(raw[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:
            cur = bytearray(((np.frombuffer(cur, np.uint8).astype(np.uint16)
                              + np.frombuffer(prev, np.uint8)) & 0xFF)
                            .astype(np.uint8).tobytes())
        elif ftype == 3:
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + p) & 0xFF
        elif ftype != 0:
            raise ValueError(f'bad PNG filter type {ftype}')
        out[y * stride:(y + 1) * stride] = cur
        prev = cur
    return np.frombuffer(bytes(out), np.uint8).reshape(h, stride)


def read_png(path):
    """-> (H, W, 3) uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path}: not a PNG file')
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f'{path}: only 8-bit RGB / RGBA, not interlaced')
    ch = 3 if color == 2 else 4
    px = _unfilter(zlib.decompress(b''.join(idat)), h, w * ch, ch)
    return px.reshape(h, w, ch)[:, :, :3].copy()
