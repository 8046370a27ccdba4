"""Weights for the reference nets, read without the program: a flax msgpack
file (``flax.serialization.to_bytes``: msgpack with flax's ndarray
extension) decoded into a state dict keyed as the reference modules name
their parameters, and the seeded flax-style initialisation drawn on the
device for configurations that have no trained weights."""
import math
import struct

import numpy as np
import torch
import torch.nn as nn

_EXT_NDARRAY = 1    # flax: msgpack of (shape, dtype name, C-order bytes)
_EXT_NPSCALAR = 3   # flax: the same, for a numpy scalar


class _Reader:
    """Minimal msgpack decoder: maps, arrays, str, bin, ints, floats, nil,
    bool and flax's two ext types."""

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
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack('BHI'[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack('BHI'[b - 0xC7])
            return self.read_ext(self.unpack('b'), n)
        if b == 0xCA:
            return self.unpack('f')
        if b == 0xCB:
            return self.unpack('d')
        if 0xCC <= b <= 0xD3:
            return self.unpack('BHIQbhiq'[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack('b')
            return self.read_ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack('BHI'[b - 0xD9])), 'utf-8')
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack('HI'[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack('HI'[b - 0xDE]))
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def read_map(self, n):
        return {self.read(): self.read() for _ in range(n)}

    def read_ext(self, code, n):
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f'unsupported msgpack ext type {code}')
        shape, dtype, raw = _Reader(data).read()
        dtype = dtype if isinstance(dtype, str) else str(dtype, 'ascii')
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _key(path):
    """flax path -> the reference modules' parameter name."""
    parts = []
    for p in path:
        for group in ('enc_blocks_', 'dec_blocks_'):
            if p.startswith(group) and p[len(group):].isdigit():
                p = group[:-1] + '.' + p[len(group):]
        parts.append(p)
    if parts[-1] in ('kernel', 'scale'):
        parts[-1] = 'weight'
    return '.'.join(parts)


def read_flax_state(path):
    """State dict (float32 tensors on the CPU) of a flax msgpack file:
    conv kernels (kh, kw, in, out) -> (out, in, kh, kw), dense (in, out) ->
    (out, in), the decoder's NHWC seed bias -> (1, C, 1, 1)."""
    with open(path, 'rb') as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f'{path}: trailing bytes after the msgpack object')
    sd = {}
    for p, leaf in _flatten(tree).items():
        a = np.asarray(leaf)
        if p[-1] == 'kernel' and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif p[-1] == 'kernel' and a.ndim == 2:
            a = a.T
        elif p == ('bias',) and a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        sd[_key(p)] = torch.from_numpy(np.array(a, dtype=np.float32,
                                                order='C'))
    return sd


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the variance is 1 / fan_in
_TRUNC_STD = .87962566103423978


@torch.no_grad()
def seeded_flax_state(net, seed, device, scales=None):
    """A state dict for `net` drawn as flax's default init draws it, on
    `device` from `seed` in one draw: lecun-normal conv and dense kernels
    (fan-in in x k x k) times the module's `init_scale` where it has one,
    zero biases, unit LayerNorm scales; constants (the layer scales) and
    the decoder's seed bias as the module holds them. `scales` {name
    suffix: factor} draws the kernels of the modules whose names end so at
    that factor in place of their init_scale."""
    scales = scales or {}
    kernels = []
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            scale = getattr(m, 'init_scale', 1.0)
            for suffix, factor in scales.items():
                if name.endswith(suffix):
                    scale = factor
            std = 1.0 / math.sqrt(m.weight[0].numel()) / _TRUNC_STD
            kernels.append((name + '.weight', m.weight.shape, std * scale))
    total = sum(math.prod(s) for _, s, _ in kernels)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    sd = {k: v.detach().to(device).clone() for k, v in net.state_dict().items()}
    off = 0
    for key, shape, std in kernels:
        n = math.prod(shape)
        sd[key] = (flat[off:off + n] * std).reshape(shape)
        off += n
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            sd[name + '.bias'] = torch.zeros_like(sd[name + '.bias'])
        elif isinstance(m, nn.LayerNorm):
            sd[name + '.weight'] = torch.ones_like(sd[name + '.weight'])
            sd[name + '.bias'] = torch.zeros_like(sd[name + '.bias'])
    return sd
