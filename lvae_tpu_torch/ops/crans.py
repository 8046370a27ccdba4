"""ctypes bindings of the native host rANS coder (csrc/crans.cpp), the
counterpart of ``lvae_tpu/ops/crans/__init__.py``: the per-block coder of
coder='host' (`RansCodec`) and the N-lane interleaved encoder of
coder='device' (`interleaved_encode`).

The library is host C++, built by ``g++`` (not nvcc, so the coder runs on
machines without a CUDA toolkit) into ``_build/`` beside the package at the
first use, under a file lock, and again whenever the source is newer than
the library. Nothing is built when the module is imported. There is no
fallback: if the build fails, the call raises.
"""
import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

from lvae_tpu_torch.ops.build import BUILD_DIR
from lvae_tpu_torch.ops.cdf import CdfTable

SOURCE = BUILD_DIR.parent / 'csrc' / 'crans.cpp'
LIBRARY = BUILD_DIR / 'libcrans.so'
# no -march=native: the library must run on any x86-64 host the build
# directory is copied to
_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC']

_I64 = ctypes.c_int64
_P = ctypes.c_void_p
_SIGNATURES = {
    'rans_encode_bound': [_I64],
    'rans_encode_with_indexes': [_P, _P, _I64, _P, _P, _P, _I64, _I64, _P,
                                 _I64],
    'rans_decode_with_indexes': [_P, _I64, _P, _I64, _P, _P, _P, _I64, _I64,
                                 _P],
    'rans_interleaved_encode': [_P, _P, _P, _I64, _P, _P, _P, _I64, _I64,
                                _I64, _P, _P, _I64, _P, _I64, _P],
}

_lock = threading.Lock()
_loaded = {}


def build():
    """Compile the library if it is missing or older than the source.
    Returns {'cmd', 'built'}; raises with g++'s output on failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    cmd = ['g++', *_FLAGS, str(SOURCE), '-o', str(LIBRARY) + '.tmp']
    with open(BUILD_DIR / 'crans.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fresh = (LIBRARY.exists()
                 and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime)
        if not fresh:
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f'the native rANS coder needs g++: {e}')
            if res.returncode != 0:
                raise RuntimeError(f'g++ failed ({res.returncode}):\n'
                                   f'{" ".join(cmd)}\n{res.stderr}')
            os.replace(cmd[-1], LIBRARY)  # a loaded library stays intact
        return dict(cmd=' '.join(cmd), built=not fresh)


def library():
    """The loaded native coder (built on first use)."""
    lib = _loaded.get('lib')
    if lib is None:
        with _lock:
            lib = _loaded.get('lib')
            if lib is None:
                _loaded['build'] = build()
                lib = ctypes.CDLL(str(LIBRARY))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int64
                _loaded['lib'] = lib
    return lib


def _as_c(arr, dtype):
    a = np.ascontiguousarray(arr, dtype=dtype)
    return a, a.ctypes.data_as(ctypes.c_void_p)


def _indexes(indexes, table):
    """Flat int32 scale indexes as a C buffer, each checked to name a row
    of the table (the coder reads the row unchecked)."""
    ix, ixp = _as_c(np.ravel(indexes), np.int32)
    if ix.size and not (ix.min() >= 0 and ix.max() < table.num_scales):
        raise ValueError(f'scale indexes outside [0, {table.num_scales})')
    return ix, ixp


def interleaved_encode(values, indexes, block_sizes, table: CdfTable,
                       num_lanes=128, escapes_capacity=None):
    """Native N-lane interleaved encode, byte-identical to
    ops/rans_interleaved.InterleavedEncoder: the blocks' symbols and
    indexes concatenated in decode order, with each block's size ->
    (states uint32[N], words uint16[W], escapes int64[K, 2]), the escapes
    (global position, value), ascending."""
    lib = library()
    v, vp = _as_c(np.ravel(values), np.int32)
    ix, ixp = _indexes(indexes, table)
    bs, bsp = _as_c(np.ravel(block_sizes), np.int64)
    if not v.size == ix.size == int(bs.sum()):
        raise ValueError(f'{v.size} values, {ix.size} indexes, blocks of '
                         f'{int(bs.sum())} symbols')
    _, cp = _as_c(table.cdfs, np.uint32)
    _, lnp = _as_c(table.cdf_lengths, np.int32)
    _, offp = _as_c(table.offsets, np.int32)
    states = np.empty(num_lanes, np.uint32)
    words_cap = int(v.size * 3 + 64)
    words = np.empty(words_cap, np.uint16)
    if escapes_capacity is None:
        escapes_capacity = int(v.size) + 16  # every symbol escaping
    escapes = np.empty((escapes_capacity, 2), np.int64)
    n_esc = np.zeros(1, np.int64)
    n_words = lib.rans_interleaved_encode(
        vp, ixp, bsp, bs.size, cp, lnp, offp, table.num_scales,
        table.max_cdf_length, num_lanes,
        states.ctypes.data_as(ctypes.c_void_p),
        words.ctypes.data_as(ctypes.c_void_p), words_cap,
        escapes.ctypes.data_as(ctypes.c_void_p), escapes_capacity,
        n_esc.ctypes.data_as(ctypes.c_void_p))
    if n_words < 0:
        raise OverflowError('interleaved encode: more escapes than '
                            f'escapes_capacity={escapes_capacity}')
    return states, words[:n_words].copy(), escapes[:int(n_esc[0])].copy()


class RansCodec:
    """Per-block coder bound to one CdfTable: the table's buffers are made
    C-contiguous once, so a call costs its ctypes dispatch. Made once per
    discretized distribution (models/entropy_coding.DiscretizedGaussian
    .update)."""

    def __init__(self, table: CdfTable):
        self._lib = library()
        self.table = table
        self._cdfs, self._cdfs_p = _as_c(table.cdfs, np.uint32)
        self._lens, self._lens_p = _as_c(table.cdf_lengths, np.int32)
        self._offs, self._offs_p = _as_c(table.offsets, np.int32)

    def _args(self):
        t = self.table
        return (self._cdfs_p, self._lens_p, self._offs_p, t.num_scales,
                t.max_cdf_length)

    def encode_with_indexes(self, values, indexes) -> bytes:
        v, vp = _as_c(np.ravel(values), np.int32)
        ix, ixp = _indexes(indexes, self.table)
        if v.size != ix.size:
            raise ValueError(f'{v.size} values, {ix.size} indexes')
        out = np.empty(int(self._lib.rans_encode_bound(v.size)), np.uint8)
        written = self._lib.rans_encode_with_indexes(
            vp, ixp, v.size, *self._args(),
            out.ctypes.data_as(ctypes.c_void_p), out.size)
        if written <= 0:
            raise RuntimeError(f'rans encode failed: {written}')
        return out[:written].tobytes()

    def decode_with_indexes(self, data: bytes, indexes) -> np.ndarray:
        ix, ixp = _indexes(indexes, self.table)
        buf = np.frombuffer(data, dtype=np.uint8)
        if buf.size < 8:           # the coder reads the 8-byte final state
            raise ValueError(f'rANS string of {buf.size} bytes: truncated')
        out = np.empty(ix.size, dtype=np.int32)
        n = self._lib.rans_decode_with_indexes(
            buf.ctypes.data_as(ctypes.c_void_p), buf.size, ixp, ix.size,
            *self._args(), out.ctypes.data_as(ctypes.c_void_p))
        if n != ix.size:
            raise RuntimeError(f'rans decode gave {n} of {ix.size} values')
        return out


def encode_with_indexes(values, indexes, table: CdfTable) -> bytes:
    """One-shot encode (RansCodec for repeated calls)."""
    return RansCodec(table).encode_with_indexes(values, indexes)


def decode_with_indexes(data: bytes, indexes, table: CdfTable) -> np.ndarray:
    """One-shot decode (RansCodec for repeated calls)."""
    return RansCodec(table).decode_with_indexes(data, indexes)
