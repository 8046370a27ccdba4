"""Weights of the JAX package, read without JAX, flax or msgpack.

`read_flax_msgpack` decodes a ``flax.serialization.to_bytes`` file (msgpack
with flax's ndarray extension) into a nested dict of numpy arrays, and
`params_from_flax` turns such a tree into a state dict of the port's
modules: the inverse of the torch->flax rules of lvae_tpu/models/port.py.
"""
import struct

import numpy as np
import torch

_EXT_NDARRAY = 1    # flax: msgpack of (shape, dtype name, C-order bytes)
_EXT_NPSCALAR = 3   # flax: the same, for a numpy scalar


class _Reader:
    """Minimal msgpack decoder: maps, arrays, str, bin, ints, floats, nil,
    bool and ext (flax's ndarray and numpy-scalar types)."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError('truncated msgpack data')
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack('>' + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), 'utf-8')
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
            return self.take(self.unpack('BHI'[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
            n = self.unpack('BHI'[b - 0xC7])
            return self.read_ext(self.unpack('b'), n)
        if b == 0xCA:
            return self.unpack('f')
        if b == 0xCB:
            return self.unpack('d')
        if 0xCC <= b <= 0xD3:                            # (u)int 8..64
            return self.unpack('BHIQbhiq'[b - 0xCC])
        if 0xD4 <= b <= 0xD8:                            # fixext 1..16
            code = self.unpack('b')
            return self.read_ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
            return str(self.take(self.unpack('BHI'[b - 0xD9])), 'utf-8')
        if b in (0xDC, 0xDD):                            # array 16/32
            return [self.read() for _ in range(self.unpack('HI'[b - 0xDC]))]
        if b in (0xDE, 0xDF):                            # map 16/32
            return self.read_map(self.unpack('HI'[b - 0xDE]))
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def read_map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read_ext(self, code, n):
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f'unsupported msgpack ext type {code}')
        shape, dtype, raw = _Reader(data).read()
        dtype = dtype if isinstance(dtype, str) else str(dtype, 'ascii')
        if dtype == 'bfloat16':
            raise ValueError('bfloat16 leaves are not supported')
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_flax_msgpack(path):
    """Nested dict of numpy arrays from a flax msgpack file. Arrays are
    read-only views of the file's bytes."""
    with open(path, 'rb') as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f'{path}: trailing bytes after the msgpack object')
    return tree


def flatten(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _torch_key(path):
    parts = []
    for p in path:
        for group in ('enc_blocks_', 'dec_blocks_'):
            if p.startswith(group) and p[len(group):].isdigit():
                p = group[:-1] + '.' + p[len(group):]
        parts.append(p)
    if parts[-1] in ('kernel', 'scale'):
        parts[-1] = 'weight'
    return '.'.join(parts)


def params_from_flax(tree, net=None):
    """Flax parameter tree (numpy leaves) -> the port's state dict, as
    float32 tensors (the committed checkpoints store float16).

    conv kernel (kh, kw, in, out) -> (out, in, kh, kw), 1x1 and 3x3 alike;
    depthwise (K, K, 1, C) -> (C, 1, K, K) by the same transpose; dense
    (in, out) -> (out, in); a LayerNorm's scale -> its weight; the
    decoder's NHWC seed bias (1, 1, 1, C) -> (1, C, 1, 1).

    A transposed conv's kernel (a deconv's, flax ConvTranspose: (kh, kw,
    in, out) in conv orientation) -> torch's (in, out, kh, kw), spatially
    flipped: the inverse of lvae_tpu/models/port.py:t_convT. Its path looks
    like any conv's, and with in == out its shape too, so the rule is
    chosen by the module: pass the `net` the state dict is for whenever it
    holds an nn.ConvTranspose2d."""
    transposed = set()
    if net is not None:
        transposed = {f'{name}.weight' for name, m in net.named_modules()
                      if isinstance(m, torch.nn.ConvTranspose2d)}
    sd = {}
    for path, leaf in flatten(tree).items():
        a = np.asarray(leaf)
        key = _torch_key(path)
        if key in transposed:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif path[-1] == 'kernel' and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif path[-1] == 'kernel' and a.ndim == 2:
            a = a.T
        elif path == ('bias',) and a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        sd[key] = torch.from_numpy(np.array(a, dtype=np.float32, order='C'))
    return sd
