"""A run with the timed path broken underneath reads `correct` false: the
rest of a run (no look for a card) on the tiny cells, the program's
methods wrapped to plant each fault the cell can have: an altered image
or stream, half a batch, a longer stream; a train step that leaves the
state unchanged, takes half the batch, alters the update or feeds the EMA
stale parameters. One chip, so no exchange between chips to leave out."""
import argparse
import time

import pytest

from harness import system
from harness.main import report
from harness.spec import Spec

_build = system.build_model


def _run(tiny_bench, cell):
    root, bench = tiny_bench
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 9, seconds=0.3,
                              trace=0)
    return report(Spec(cell, root, bench), args, 'cpu',
                  time.perf_counter())[0]


def _wrapping(monkeypatch, method, wrap):
    def build(*a, **kw):
        model = _build(*a, **kw)
        setattr(model, method, wrap(getattr(model, method)))
        return model
    monkeypatch.setattr(system, 'build_model', build)


def _altered_image(f):
    def g(*a):
        out = f(*a).clone()
        out[0] = out[0] * 0.5
        return out
    return g


def _half_images(f):
    def g(*a):
        out = f(*a)
        return out[:out.shape[0] // 2]
    return g


def _swapped_streams(f):
    def g(*a):
        streams = list(f(*a))
        streams[0] = streams[1]
        return streams
    return g


def _bloated_streams(f):
    """A container that grew: each stream eight times as long (a tiny
    image's stream is mostly container, so the excess of the sound ones,
    4.4-22.4, spans more than twice)."""
    def g(*a):
        return [s + bytes(7 * len(s)) for s in f(*a)]
    return g


def _half_streams(f):
    def g(*a):
        streams = f(*a)
        return streams[:len(streams) // 2]
    return g


@pytest.mark.parametrize('cell', ['qarv_tiny.dec', 'qres_tiny.dec'])
def test_sound_runs_are_correct(tiny_bench, cell):
    assert _run(tiny_bench, cell)['correct'] is True


@pytest.mark.parametrize('cell,method,fault', [
    ('qarv_tiny.dec', 'decompress_batch_to_device', _altered_image),
    ('qarv_tiny.dec', 'decompress_batch_to_device', _half_images),
    ('qres_tiny.dec', 'decompress_batch_to_device', _altered_image),
    ('qres_tiny.dec', 'decompress_batch_to_device', _half_images),
    ('qarv_tiny.enc', 'compress_batch_finish', _swapped_streams),
    ('qarv_tiny.enc', 'compress_batch_finish', _half_streams),
], ids=['qarv-dec-altered', 'qarv-dec-half', 'qres-dec-altered',
        'qres-dec-half', 'qarv-enc-altered', 'qarv-enc-half'])
def test_serving_faults_read_incorrect(tiny_bench, monkeypatch, cell, method,
                                       fault):
    _wrapping(monkeypatch, method, fault)
    result = _run(tiny_bench, cell)
    assert result['correct'] is False


def _train_fault(monkeypatch, kind):
    """control.plant's fault, undone after the test."""
    import control
    from lvae_tpu_torch.training import optim
    monkeypatch.setattr(optim, 'make_train_step', optim.make_train_step)
    control.plant(kind)


def test_sound_training_is_correct(tiny_bench):
    assert _run(tiny_bench, 'qarv_tiny.train')['correct'] is True


@pytest.mark.parametrize('cell', ['qarv_tiny.enc', 'qarv_tiny.dec'])
def test_a_longer_stream_reads_incorrect(tiny_bench, monkeypatch, cell):
    # the images stay the same, the rate check alone catches it
    _wrapping(monkeypatch, 'compress_batch_finish', _bloated_streams)
    result = _run(tiny_bench, cell)
    assert result['correct'] is False
    rate = result['checks']['rate_excess']
    assert rate['value'] > rate['limit']


@pytest.mark.parametrize('kind', ['unchanged', 'half', 'altered', 'ema'])
def test_training_faults_read_incorrect(tiny_bench, monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    result = _run(tiny_bench, 'qarv_tiny.train')
    assert result['correct'] is False
    print(kind, result['checks'])
