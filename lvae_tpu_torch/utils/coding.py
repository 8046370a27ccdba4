"""Host-side stream glue, image IO and RD bookkeeping, free of PIL.

Copies of the byte formats in ``lvae_tpu/utils/coding.py`` (the host
coder's string container, escape varints, compact lane states, LEB128, edge
padding), which must stay byte-identical
to the JAX package's (tests/test_torch_payload.py), a small PNG reader so
that the port runs on machines without Pillow, and the eval harness's
helpers (shape buckets, BD-rate, RD curves) on numpy HWC arrays.
"""
import json
import math
import struct
import zlib
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# The host coder's container of per-block strings
# ---------------------------------------------------------------------------


def pack_byte_strings(list_of_strings):
    """Pack byte strings into one: [B num][num x I lengths][payload]
    (lvae_tpu/utils/coding.py:28)."""
    lengths = [len(s) for s in list_of_strings]
    return (struct.pack('B', len(lengths))
            + struct.pack(f'{len(lengths)}I', *lengths)
            + b''.join(list_of_strings))


def unpack_byte_string(string):
    """Inverse of pack_byte_strings."""
    num, = struct.unpack('B', string[:1])
    lengths = struct.unpack(f'{num}I', string[1:1 + 4 * num])
    string = string[1 + 4 * num:]
    if sum(lengths) != len(string):
        raise ValueError(f'{sum(lengths)=} != {len(string)=}')
    edges = np.cumsum((0,) + lengths)
    return [string[edges[i]:edges[i + 1]] for i in range(num)]


# ---------------------------------------------------------------------------
# LEB128 varints and escape records (delta-coded positions, zigzag values)
# ---------------------------------------------------------------------------


def leb128_encode(vals: np.ndarray) -> bytes:
    """LEB128-encode a 1-D array of unsigned integers (vectorized)."""
    v = np.asarray(vals).astype(np.uint64)
    if v.size == 0:
        return b''
    nbytes = np.ones(v.size, np.int64)
    t = v >> np.uint64(7)
    while (t > 0).any():
        nbytes[t > 0] += 1
        t >>= np.uint64(7)
    j = np.arange(int(nbytes.max()))
    emit = j[None, :] < nbytes[:, None]
    shifts = (np.uint64(7) * j.astype(np.uint64))[None, :]
    mat = ((v[:, None] >> shifts) & np.uint64(0x7F)).astype(np.uint8)
    mat[(j[None, :] + 1) < nbytes[:, None]] |= 0x80
    return mat[emit].tobytes()


def leb128_decode(buf: bytes, count: int):
    """Decode `count` LEB128 varints. Returns (uint64 array, bytes consumed)."""
    if count == 0:
        return np.zeros(0, np.uint64), 0
    b = np.frombuffer(buf, np.uint8)
    term = np.nonzero((b & 0x80) == 0)[0]
    if len(term) < count:
        raise ValueError('truncated varint stream')
    consumed = int(term[count - 1]) + 1
    b = b[:consumed]
    starts = np.concatenate([[0], term[:count - 1] + 1])
    vid = np.zeros(consumed, np.int64)
    vid[starts[1:]] = 1
    vid = np.cumsum(vid)
    pos_in_val = np.arange(consumed) - starts[vid]
    vals = np.zeros(count, np.uint64)
    np.add.at(vals, vid,
              (b & np.uint8(0x7F)).astype(np.uint64)
              << (np.uint64(7) * pos_in_val.astype(np.uint64)))
    return vals, consumed


def pack_escapes(pos, val) -> bytes:
    """Serialize escape records: delta-coded positions then zigzag values,
    both LEB128. `pos` must be non-decreasing (scan order)."""
    pos = np.asarray(pos, np.int64)
    val = np.asarray(val, np.int64)
    deltas = np.diff(pos, prepend=np.int64(0))
    if (deltas < 0).any():
        raise ValueError('escape positions must be non-decreasing')
    zig = (val << 1) ^ (val >> 63)
    return leb128_encode(deltas) + leb128_encode(zig.astype(np.uint64))


def unpack_escapes(buf: bytes, count: int):
    """Inverse of pack_escapes. Returns (pos int64, val int64, consumed)."""
    deltas, c1 = leb128_decode(buf, count)
    zig, c2 = leb128_decode(buf[c1:], count)
    pos = np.cumsum(deltas.astype(np.int64))
    zig = zig.astype(np.int64)
    return pos, (zig >> 1) ^ -(zig & 1), c1 + c2


# ---------------------------------------------------------------------------
# Compact rANS lane states: a 2-bit length code per lane (4 lanes per byte),
# then the truncated little-endian bytes of (state - 2^16)
# ---------------------------------------------------------------------------

RANS_STATE_MIN = 1 << 16


def pack_states(states) -> bytes:
    """Serialize uint32 rANS lane states (each >= 2^16) compactly."""
    s = np.asarray(states).astype(np.uint64).ravel()
    if not ((s >= RANS_STATE_MIN).all() and (s < (1 << 32)).all()):
        raise ValueError('lane states must lie in [2^16, 2^32)')
    x = s - RANS_STATE_MIN
    nb = (1 + (x >= (1 << 8)).astype(np.int64) +
          (x >= (1 << 16)).astype(np.int64) +
          (x >= (1 << 24)).astype(np.int64))
    codes = (nb - 1).astype(np.uint8)
    cp = np.concatenate([codes, np.zeros((-len(codes)) % 4, np.uint8)])
    cp = cp.reshape(-1, 4)
    prefix = (cp[:, 0] | (cp[:, 1] << 2) | (cp[:, 2] << 4) |
              (cp[:, 3] << 6)).astype(np.uint8)
    j = np.arange(4)
    mat = ((x[:, None] >> (np.uint64(8) * j.astype(np.uint64)))
           & np.uint64(0xFF)).astype(np.uint8)
    return prefix.tobytes() + mat[j[None, :] < nb[:, None]].tobytes()


def unpack_states(buf: bytes, n: int):
    """Inverse of pack_states. Returns (uint32 states, bytes consumed)."""
    npre = (n + 3) // 4
    pre = np.frombuffer(buf[:npre], np.uint8)
    codes = np.stack([pre & 3, (pre >> 2) & 3, (pre >> 4) & 3,
                      (pre >> 6) & 3], axis=1).reshape(-1)[:n]
    nb = codes.astype(np.int64) + 1
    total = int(nb.sum())
    body = np.frombuffer(buf[npre:npre + total], np.uint8).astype(np.uint64)
    starts = np.concatenate([[0], np.cumsum(nb)[:-1]])
    x = np.zeros(n, np.uint64)
    for j in range(4):
        sel = nb > j
        x[sel] |= body[starts[sel] + j] << np.uint64(8 * j)
    return (x + RANS_STATE_MIN).astype(np.uint32), npre + total


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

def pad_divisible_by(arr: np.ndarray, div=64) -> np.ndarray:
    """Edge-pad an (H, W, C) array at bottom/right so H and W divide by
    `div` (the array form of lvae_tpu.utils.coding.pad_divisible_by)."""
    pad_h, pad_w = -arr.shape[0] % div, -arr.shape[1] % div
    if not (pad_h or pad_w):
        return arr
    return np.pad(arr, [(0, pad_h), (0, pad_w)] + [(0, 0)] * (arr.ndim - 2),
                  mode='edge')


def crop_divisible_by(arr: np.ndarray, div=64) -> np.ndarray:
    """Center-crop an (H, W, C) array so H and W divide by `div` (the array
    form of lvae_tpu.utils.coding.crop_divisible_by)."""
    h_old, w_old = arr.shape[0], arr.shape[1]
    h_new, w_new = div * (h_old // div), div * (w_old // div)
    top, left = (h_old - h_new) // 2, (w_old - w_new) // 2
    return arr[top:top + h_new, left:left + w_new]


def pad_to_shape(arr: np.ndarray, h_tgt: int, w_tgt: int) -> np.ndarray:
    """Edge-pad an (H, W, C) array at bottom/right to exactly (h_tgt,
    w_tgt), which must be at least its size: an image's shape bucket."""
    h_old, w_old = arr.shape[0], arr.shape[1]
    if h_tgt < h_old or w_tgt < w_old:
        raise ValueError(f'pad target {(h_tgt, w_tgt)} is smaller than the '
                         f'image {(h_old, w_old)}')
    if (h_tgt, w_tgt) == (h_old, w_old):
        return arr
    return np.pad(arr, [(0, h_tgt - h_old), (0, w_tgt - w_old)]
                  + [(0, 0)] * (arr.ndim - 2), mode='edge')


def choose_shape_buckets(sizes, div=64, max_buckets=3):
    """Pick <= max_buckets padded (H, W) buckets covering all (h, w) sizes.

    Exact /div padding when the dataset has few distinct shapes; otherwise
    contiguous area-sorted groups with element-wise-max buckets, the last
    bucket being the global max (so every image fits somewhere)."""
    padded = sorted({(div * math.ceil(h / div), div * math.ceil(w / div))
                     for h, w in sizes})
    if len(padded) <= max_buckets:
        return padded
    by_area = sorted(padded, key=lambda s: s[0] * s[1])
    n = len(by_area)
    buckets = []
    for g in range(max_buckets):
        grp = by_area[g * n // max_buckets:(g + 1) * n // max_buckets]
        if grp:
            buckets.append((max(h for h, _ in grp), max(w for _, w in grp)))
    gmax = (max(h for h, _ in padded), max(w for _, w in padded))
    if gmax not in buckets:
        buckets[-1] = gmax
    return sorted(set(buckets))


def bucket_for(h, w, buckets):
    """Smallest bucket that fits (h, w); the global-max bucket always does."""
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            return bh, bw
    return buckets[-1]


# the suffixes an eval loop takes from a dataset directory; read_png reads
# the PNGs and raises, naming the file, on any other
IMAGE_SUFFIXES = {'.png', '.jpg', '.jpeg', '.bmp', '.webp', '.ppm', '.tif',
                  '.tiff'}


def image_paths(root):
    """The image files under `root` (recursively), sorted."""
    return sorted(p for p in Path(root).rglob('*.*')
                  if p.suffix.lower() in IMAGE_SUFFIXES)


def _paeth_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _avg_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


# channels per pixel of each PNG colour type: gray, RGB, palette,
# gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# the seven Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _unfilter(raw, height, stride, bpp, path):
    """Undo the five standard row filters (None, Sub, Up, Average, Paeth)
    -> (height, stride) uint8. bpp: bytes per complete pixel, at least 1
    (the filters work on bytes, also for sub-byte depths)."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f'{path}: truncated image data')
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype = raw[r * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, r * (stride + 1) + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: running sum per byte lane, modulo 256
            pad = -stride % bpp
            cur = np.cumsum(np.pad(line, (0, pad)).reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_avg_row if ftype == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f'{path}: bad PNG filter type {ftype}')
        out[r] = cur
        prev = out[r]
    return out


def _row_bytes(width, channels, depth):
    """Bytes of one filtered row, its filter-type byte included."""
    return (width * channels * depth + 7) // 8 + 1


def _samples(raw, height, width, channels, depth, path):
    """The filtered rows of an image (or of one Adam7 pass) -> (height,
    width, channels) samples: uint8 up to 8 bits, uint16 at 16."""
    stride = _row_bytes(width, channels, depth) - 1
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8), path)
    if depth == 16:           # big-endian
        return rows.view('>u2').astype(np.uint16).reshape(height, width,
                                                          channels)
    if depth < 8:             # unpack MSB-first; each row pads to a byte
        rows = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        rows = (rows * weights).sum(-1)[:, :width].astype(np.uint8)
    return rows.reshape(height, width, channels)


def png_size(path):
    """(height, width) of a PNG from its IHDR chunk, which a PNG must start
    with: 24 bytes read, no pixel decoded. Any other file raises
    ValueError, naming it, as read_png does."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if head[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path}: not a PNG file')
    if len(head) < 24 or head[12:16] != b'IHDR':
        raise ValueError(f'{path}: no IHDR chunk')
    width, height = struct.unpack('>II', head[16:24])
    return height, width


def read_png(path) -> np.ndarray:
    """Decode a PNG -> uint8 (H, W, 3), converted to RGB as Pillow's
    convert('RGB') converts it: RGB and RGBA (alpha dropped), gray and
    gray+alpha (gray copied to the three channels, alpha dropped), gray at
    1, 2 or 4 bits (scaled to 0..255), palette images at 1, 2, 4 or 8 bits
    (each index looked up in PLTE; tRNS ignored). 16-bit samples map as
    Pillow maps them: gray (mode I;16) clips at 255; RGB, RGBA and
    gray+alpha keep the high byte. Adam7-interlaced images are
    deinterlaced pass by pass. Any other file (JPEG, BMP, ...) raises
    ValueError: the port carries no other image decoder."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path}: not a PNG file')
    pos, idat, hdr, plte = 8, [], None, b''
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            plte = body
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if hdr is None:
        raise ValueError(f'{path}: no IHDR chunk')
    width, height, depth, color, _, _, interlace = hdr
    if interlace not in (0, 1):
        raise ValueError(f'{path}: unknown PNG interlace method {interlace}')
    if depth not in _PNG_DEPTHS.get(color, ()):
        raise ValueError(f'{path}: unsupported PNG colour type {color} at '
                         f'bit depth {depth}')
    channels = _PNG_CHANNELS[color]
    raw = zlib.decompress(b''.join(idat))
    if interlace == 0:
        px = _samples(raw, height, width, channels, depth, path)
    else:
        # each non-empty pass is a small image of its own, unfiltered alone
        passes = []
        for r0, c0, dr, dc in _ADAM7:
            ph, pw = -(-(height - r0) // dr), -(-(width - c0) // dc)
            if ph > 0 and pw > 0:
                passes.append((r0, c0, dr, dc, ph, pw))
        if len(raw) != sum(ph * _row_bytes(pw, channels, depth)
                           for *_, ph, pw in passes):
            raise ValueError(f'{path}: truncated image data')
        px = np.zeros((height, width, channels),
                      np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for r0, c0, dr, dc, ph, pw in passes:
            n = ph * _row_bytes(pw, channels, depth)
            px[r0::dr, c0::dc] = _samples(raw[pos:pos + n], ph, pw, channels,
                                          depth, path)
            pos += n
    if color == 3:
        if not plte:
            raise ValueError(f'{path}: palette image without PLTE')
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[:768].reshape(-1, 3)
        pal[:len(entries)] = entries
        return pal[px[..., 0]]
    if depth == 16:
        px = (np.minimum(px, 255) if color == 0 else px >> 8).astype(np.uint8)
    if color in (0, 4):
        gray = px[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])


def batch_to_image(batch) -> np.ndarray:
    """(1, H, W, 3) or (H, W, 3) float array in [0, 1] -> uint8 (H, W, 3),
    clip(x * 255 + 0.5) truncated, as the JAX package's batch_to_image
    rounds before Pillow (lvae_tpu/models/base.py:34-40)."""
    arr = np.asarray(batch)
    if arr.ndim == 4:
        arr = arr[0]
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _png_chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, arr):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG, rows unfiltered
    (zlib and struct only: the card's machine has no image library)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f'write_png takes (H, W, 3) uint8, got '
                         f'{arr.dtype} {arr.shape}')
    h, w, _ = arr.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)        # filter byte 0 a row
    raw[:, 1:] = arr.reshape(h, 3 * w)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0,
                                                  0, 0))
                + _png_chunk(b'IDAT', zlib.compress(raw.tobytes()))
                + _png_chunk(b'IEND', b''))


# ---------------------------------------------------------------------------
# BD-rate and RD-curve bookkeeping
# ---------------------------------------------------------------------------

def bd_rate(r1, psnr1, r2, psnr2):
    """Bjontegaard delta-rate of curve 2 vs baseline curve 1, in percent:
    a degree-3 fit of log-rate as a function of PSNR, integrated over the
    overlapping PSNR interval."""
    lr1 = np.log(np.asarray(r1, dtype=np.float64))
    lr2 = np.log(np.asarray(r2, dtype=np.float64))
    psnr1 = np.asarray(psnr1, dtype=np.float64)
    psnr2 = np.asarray(psnr2, dtype=np.float64)
    p_int1 = np.polyint(np.polyfit(psnr1, lr1, deg=3))
    p_int2 = np.polyint(np.polyfit(psnr2, lr2, deg=3))
    min_psnr = max(psnr1.min(), psnr2.min())
    max_psnr = min(psnr1.max(), psnr2.max())
    auc1 = np.polyval(p_int1, max_psnr) - np.polyval(p_int1, min_psnr)
    auc2 = np.polyval(p_int2, max_psnr) - np.polyval(p_int2, min_psnr)
    avg_exp_diff = (auc2 - auc1) / (max_psnr - min_psnr)
    return (np.exp(avg_exp_diff) - 1) * 100


class RDList:
    """RD curves (bpp, PSNR) from result JSONs or data, their BD-rates
    against an anchor curve, and a plot on any matplotlib-like axis."""

    def __init__(self):
        self.stats_all = []
        self.bdrate_anchor = None

    def add_json(self, fpath, label='no label', **kwargs):
        with open(fpath, mode='r') as f:
            stat = json.load(f)
        if 'results' in stat:
            stat = stat['results']
        stat['label'] = label
        stat['kwargs'] = kwargs
        self.stats_all.append(stat)

    def add_data(self, bpp=(), psnr=(), label='no label', **kwargs):
        self.stats_all.append({'bpp': list(bpp), 'psnr': list(psnr),
                               'label': label, 'kwargs': kwargs})

    def set_bdrate_anchor(self, label=None):
        if label is None:
            self.bdrate_anchor = self.stats_all[-1]
            return
        matches = [st for st in self.stats_all if st['label'] == label]
        if len(matches) != 1:
            raise ValueError(f'{len(matches)} curves are labelled {label!r}')
        self.bdrate_anchor = matches[0]

    def compute_bdrate(self):
        """{label: BD-rate in percent against the anchor}, printed; None
        without an anchor."""
        if self.bdrate_anchor is None:
            return None
        anchor = self.bdrate_anchor
        out = {}
        print(f'BD-rate anchor = {anchor["label"]}')
        for method in self.stats_all:
            if len(method['bpp']) == 0:
                continue
            bd = bd_rate(anchor['bpp'], anchor['psnr'], method['bpp'],
                         method['psnr'])
            out[method['label']] = bd
            print(method['label'], f'BD-rate = {bd}')
        print()
        return out

    def plot_all_stats(self, ax):
        """Plot every curve on `ax` (anything with matplotlib's
        ``ax.plot``); the port itself imports no plotting library."""
        for stat in self.stats_all:
            self._plot_stat(stat, ax=ax, **stat['kwargs'])

    @staticmethod
    def _plot_stat(stat, ax, ls='-', **kwargs):
        kwargs['marker'] = kwargs.get('marker', '.')
        kwargs['linewidth'] = kwargs.get('linewidth', 1.2)
        return ax.plot(stat['bpp'], stat['psnr'], label=stat['label'],
                       markersize=8, linestyle=ls, **kwargs)
