"""Builds the hand-written CUDA kernels and binds them with ctypes.

Each source of ``csrc/`` (``rans.cu``, ``trunk.cu``) is compiled by its own
``nvcc -c`` call, all started together (a build takes as long as its slowest
source), and one more call links the objects into a plain C shared library
(no PyTorch headers, so the build takes seconds) under ``_build/`` beside the
package. The build runs at the first
kernel launch, under a file lock, and again whenever a source is newer than
the library. Nothing is built when the module is imported: machines without
a CUDA toolkit import it freely.

The flags carry the trunk's bit-exactness contract (csrc/trunk.cu): no
``--use_fast_math`` (expf, logf, sqrtf and division stay the accurate
versions) and ``-fmad=false`` (only the explicit fmaf of the matrix products
fuse; every other multiply-add rounds twice, as in the plain versions).
"""
import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / 'csrc' / 'rans.cu', _PKG / 'csrc' / 'trunk.cu')
BUILD_DIR = _PKG / '_build'
LIBRARY = BUILD_DIR / 'liblvae_cuda.so'

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points of csrc/*.cu (every pointer and the
# stream as c_void_p, or ctypes would cut them to 32-bit ints); each returns
# a CUDA error code (int) unless _RESTYPES says otherwise
_SIGNATURES = {
    'rans_decode_block': [_P, _I, _I, _P, _P, _P, _P, _P, _LL, _P, _I, _I,
                          _P, _LL, _P, _I, _P],
    'rans_decode_block_multi': [_P, _I, _I, _I, _P, _P, _P, _P, _P, _LL, _P,
                                _I, _I, _P, _LL, _P, _I, _P],
    'rans_encode_all': [_P, _P, _P, _I, _I, _P, _I, _I, _P, _LL, _LL, _P,
                        _P, _P, _LL, _I, _P],
    'rans_encode_all_multi': [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _LL,
                              _LL, _P, _P, _P, _LL, _I, _P],
    'rans_encode_scratch_bytes': [_I, _I, _I],
    'rans_encode_chain_multi': [_I, _I, _I, _P, _LL, _P, _I, _I, _P],
    'rans_encode_all_rowsync': [_P, _P, _P, _I, _I, _P, _I, _I, _P, _LL,
                                _LL, _P, _P, _I, _P],
    'rans_encode_all_multi_rowsync': [_P, _P, _P, _I, _I, _I, _P, _I, _I,
                                      _P, _LL, _LL, _P, _P, _I, _P],
    'trunk_emb_mlp': [_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _I,
                      _P],
    'trunk_emb_mlp_cluster8': [_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P,
                               _P, _I, _P],
    'trunk_emb_mlp_oneblock': [_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P,
                               _P, _I, _P],
    'trunk_dw_ln_mod': [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                        _P, _I, _P],
    'trunk_dw_ln_mod_warp': [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                             _P, _P, _I, _P],
    'trunk_mlp_res': [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _P],
    'trunk_dense': [_P, _I, _I, _I, _P, _P, _P, _I, _P],
    'trunk_prior_head': [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I,
                         _P],
    'trunk_prior_head_oldcore': [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P,
                                 _I, _P],
    'trunk_fuse_zproj': [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    'trunk_fuse_zproj_oldcore': [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                                 _P],
    'trunk_finish_image': [_P, _LL, _P, _I, _P],
    'trunk_upsample_finish': [_P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    'trunk_upsample_head': [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    'trunk_dw_ln_affine': [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                           _P],
    'trunk_dw_ln_affine_warp': [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                _I, _P],
    'trunk_dense_act': [_P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P],
    'trunk_dense_act_oldcore': [_P, _I, _I, _I, _P, _P, _I, _P, _I, _P],
    'trunk_conv_kxk_act': [_P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                           _I, _P],
    'trunk_zadd_dense': [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    'trunk_zadd_dense_oldcore': [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    'trunk_zadd': [_P, _P, _LL, _P, _I, _P],
    'trunk_zadd_conv_kxk': [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                            _P],
    'trunk_res_dense_act': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    'trunk_res_dense_act_oldcore': [_P, _P, _I, _I, _I, _P, _P, _P, _I,
                                    _P],
    'trunk_nll_head': [_P, _P, _LL, _P, _I, _F, _F, _P, _P, _I, _P],
    'trunk_nll_head_linear': [_P, _P, _LL, _P, _I, _F, _F, _P, _P, _I, _P],
    'trunk_nll_recon': [_P, _P, _LL, _F, _P, _I, _P],
}

_RESTYPES = {'rans_encode_scratch_bytes': _LL}

_loaded = {}


def nvcc_path():
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (PATH or /usr/local/cuda/bin)')


_FLAGS = ['-O3', '-std=c++17', '-arch=sm_90a', '-fmad=false',
          '-Xcompiler', '-fPIC']


def nvcc_commands():
    """(one compile command per source, the link command); the library is
    linked under a temporary name and moved in whole."""
    objs = [BUILD_DIR / f'{src.stem}.o' for src in SOURCES]
    compiles = [[nvcc_path(), *_FLAGS, '-c', str(src), '-o', str(obj)]
                for src, obj in zip(SOURCES, objs)]
    link = [nvcc_path(), '-arch=sm_90a', '-shared', *map(str, objs), '-o',
            str(LIBRARY) + '.tmp']
    return compiles, link


def _run(cmd):
    """Run one command; -> its seconds. Raises with its output on failure."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                           f'{" ".join(cmd)}\n{res.stderr}')
    return time.perf_counter() - t0


def build():
    """Compile the library if it is missing or older than a source.
    Returns {'cmds', 'seconds', 'compile_seconds' (per source), 'library',
    'built'}."""
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / 'build.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fresh = (LIBRARY.exists()
                 and all(LIBRARY.stat().st_mtime >= src.stat().st_mtime
                         for src in SOURCES))
        compiles, link = nvcc_commands()
        t0 = time.perf_counter()
        compile_s = {}
        if not fresh:
            # the sources compile side by side: the build's wall time is
            # the slowest source's, not their sum
            with ThreadPoolExecutor(len(compiles)) as pool:
                compile_s = dict(zip((s.name for s in SOURCES),
                                     pool.map(_run, compiles)))
            _run(link)
            os.replace(link[-1], LIBRARY)  # a loaded library stays intact
        return dict(cmds=[' '.join(c) for c in compiles + [link]],
                    seconds=time.perf_counter() - t0,
                    compile_seconds=compile_s, library=str(LIBRARY),
                    built=not fresh)


def library():
    """The loaded kernel library (built on first use)."""
    lib = _loaded.get('lib')
    if lib is None:
        _loaded['build'] = build()
        lib = ctypes.CDLL(str(LIBRARY))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _loaded['lib'] = lib
    return lib


def check(err, name):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')
