"""General utilities: ANSI logging, run-dir naming, file IO and the live
stats table of the trainer, a copy of ``lvae_tpu/utils/general.py:53-218``
(its XLA compile cache is JAX tooling and has no counterpart here).
"""
import json
import logging
import re
import statistics
from pathlib import Path


class ANSI:
    _colors = {
        'k': 30, 'r': 31, 'g': 32, 'y': 33, 'b': 34, 'm': 35, 'c': 36, 'w': 37,
        'br_k': 90, 'br_r': 91, 'br_g': 92, 'br_y': 93, 'br_b': 94,
        'br_m': 95, 'br_c': 96, 'br_w': 97,
    }

    @classmethod
    def colorstr(cls, s, c='b', b=False, ul=False):
        codes = [str(cls._colors.get(c, 34))]
        if b:
            codes.append('1')
        if ul:
            codes.append('4')
        return f'[{";".join(codes)}m{s}[0m'

    @classmethod
    def headerstr(cls, s):
        return cls.colorstr(s, c='br_c', b=True)

    @classmethod
    def warningstr(cls, s):
        return cls.colorstr(s, c='br_y')

    @classmethod
    def errorstr(cls, s):
        return cls.colorstr(s, c='br_r', b=True)

    @classmethod
    def sccstr(cls, s):
        return cls.colorstr(s, c='br_g')


class _ColorFormatter(logging.Formatter):
    _level_colors = {
        logging.DEBUG: 'br_k', logging.INFO: 'w',
        logging.WARNING: 'br_y', logging.ERROR: 'br_r', logging.CRITICAL: 'r',
    }

    def format(self, record):
        msg = super().format(record)
        if record.levelno >= logging.WARNING:
            msg = ANSI.colorstr(msg, c=self._level_colors[record.levelno])
        return msg


def my_stream_handler():
    handler = logging.StreamHandler()
    handler.setFormatter(_ColorFormatter('%(message)s'))
    return handler


def increment_dir(parent, name='exp'):
    """Pick the next available run-dir name `{name}_{i}` under `parent`
    (reference: lvae/utils/general.py:248-264)."""
    parent = Path(parent)
    existing = []
    if parent.is_dir():
        for d in parent.iterdir():
            m = re.fullmatch(rf'{re.escape(name)}_(\d+)', d.name)
            if m:
                existing.append(int(m.group(1)))
    idx = max(existing) + 1 if existing else 0
    return f'{name}_{idx}'


def json_dump(obj, fpath, indent=4):
    with open(fpath, 'w') as f:
        json.dump(obj, f, indent=indent, default=str)


def json_load(fpath):
    with open(fpath, 'r') as f:
        return json.load(f)


def read_file(fpath):
    with open(fpath, 'r') as f:
        return f.read()


def print_to_file(s, fpath, mode='w'):
    with open(fpath, mode) as f:
        print(s, file=f)


def print_dict_as_table(d):
    keys = list(d.keys())
    widths = [max(len(str(k)), 10) for k in keys]
    header = ' | '.join(f'{str(k):>{w}}' for k, w in zip(keys, widths))
    vals = []
    for k, w in zip(keys, widths):
        v = d[k]
        s = f'{v:.5g}' if isinstance(v, float) else str(v)
        vals.append(f'{s:>{w}}')
    print(header)
    print('-' * len(header))
    print(' | '.join(vals))


class SimpleTable:
    """Fixed-width live stats table rendered into a progress-bar description
    (reference: lvae/utils/general.py:315-398)."""

    def __init__(self, init_keys=()):
        self._data = {k: 0.0 for k in init_keys}
        self._width = {k: max(len(str(k)), 8) for k in init_keys}

    def keys(self):
        return self._data.keys()

    def get(self, key, default=None):
        return self._data.get(key, default)

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        self._data[key] = value
        self._width.setdefault(key, max(len(str(key)), 8))

    def _fmt(self, v, w):
        if isinstance(v, float):
            s = f'{v:.4g}'
        else:
            s = str(v)
        return f'{s:>{w}}'

    def get_header(self, border=False):
        cells = [f'{str(k):>{self._width[k]}}' for k in self._data]
        line = '  '.join(cells)
        return ('| ' + line + ' |') if border else line

    def get_body(self, border=False):
        cells = [self._fmt(v, self._width[k]) for k, v in self._data.items()]
        line = '  '.join(cells)
        return ('| ' + line + ' |') if border else line

    def update(self, border=False):
        return self.get_header(border), self.get_body(border)


class MaxLengthList:
    """Ring buffer used for the moving gradient-norm median
    (reference: lvae/utils/general.py:417-443)."""

    def __init__(self, max_len=100):
        self._max_len = max_len
        self._data = []

    def add(self, v):
        self._data.append(float(v))
        if len(self._data) > self._max_len:
            self._data.pop(0)

    def current(self):
        return self._data[-1] if self._data else 0.0

    def median(self):
        return statistics.median(self._data) if self._data else 0.0

    def max(self):
        return max(self._data) if self._data else 0.0

    def __len__(self):
        return len(self._data)
