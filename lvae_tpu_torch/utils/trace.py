"""The program's host spans and its launch counters.

A span marks one layer boundary of a batch request or a training step (the
table of spans is in PERF.md, section 3). Recording is off unless start()
turns it on, and off, `span(name)` costs one check of a module global and
returns a shared no-op context. On, each span opened takes one entry of an
in-memory list,

    (name, t0_ns, t1_ns, parent)

with t0_ns / t1_ns from time.time_ns(), the wall clock that torch.profiler
stamps the device's activity with, and `parent` the index in the list of
the span that was open around it (None for a root span). stop() turns
recording off and returns the list, in the order the spans were opened.
Spans are recorded from one thread.

counters() reads the launch counters that the kernel wrappers keep
(`<wrapper>.launches`: one count a wrapper call on the card, none on the
CPU, where the plain versions run).
"""
import time

from lvae_tpu_torch.ops import rans_decode, rans_encode, trunk

_spans = None          # the list being recorded into; None while off
_open = []             # indexes of the spans open now, innermost last


class _Off:
    """The no-op span that recording off hands out."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('spans', 'index')

    def __init__(self, name):
        self.spans, self.index = _spans, len(_spans)
        _spans.append([name, time.time_ns(), None,
                       _open[-1] if _open else None])
        _open.append(self.index)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.spans[self.index][2] = time.time_ns()
        if self.spans is _spans and _open and _open[-1] == self.index:
            _open.pop()
        return False


def span(name):
    """A context manager around one layer's work: recorded while recording
    is on, a no-op otherwise."""
    if _spans is None:
        return _OFF
    return _Span(name)


def start():
    """Turn recording on, with an empty list."""
    global _spans
    _spans = []
    _open.clear()


def stop():
    """Turn recording off -> the spans recorded since start(), as tuples
    (name, t0_ns, t1_ns, parent); a span still open has t1_ns None."""
    global _spans
    out = [tuple(s) for s in (_spans or [])]
    _spans = None
    _open.clear()
    return out


def counters():
    """{wrapper name: its launches so far}: the trunk wrappers of
    ops/trunk.KERNELS and the four rANS wrappers."""
    wrappers = trunk.KERNELS + (
        rans_decode.rans_decode_block, rans_decode.rans_decode_block_multi,
        rans_encode.rans_encode_all, rans_encode.rans_encode_all_multi)
    return {w.__name__: w.launches for w in wrappers}
