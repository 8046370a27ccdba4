"""The program's span recorder and launch counters (lvae_tpu_torch/utils/
trace.py) on the tiny models of models/dev_zoo.py, on the CPU: off, a batch
encode and decode record nothing; on, each request gives the span tree of
PERF.md's section 3, and a training step its three parts in order."""
import numpy as np
import pytest
import torch

import lvae_tpu_torch
from lvae_tpu_torch.ops import rans_decode, rans_encode, trunk
from lvae_tpu_torch.training.optim import TrainState, make_train_step
from lvae_tpu_torch.utils import trace

LMBS = [64.0, 512.0, 2048.0]
# latent blocks of the tiny models' streams (the lossless head adds one)
LATENT_BLOCKS = {'qarv_tiny': 2, 'qres_tiny': 3, 'qres_tiny_lossless': 3}


@pytest.fixture(autouse=True)
def recording_off():
    trace.stop()
    yield
    trace.stop()


@pytest.fixture(scope='module')
def images():
    return np.random.default_rng(3).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)


def _model(name, max_program_batch=2):
    torch.manual_seed(0)
    m = lvae_tpu_torch.get_model(name, device='cpu')
    if name == 'qarv_tiny':
        m.compress_mode(num_lanes='auto', portable=True,
                        max_program_batch=max_program_batch)
    else:
        m.compress_mode(num_lanes=16, esc_cap=1 << 16, portable=True,
                        max_program_batch=max_program_batch)
    return m


def _encode_async(m, ims):
    if m.__class__.__name__ == 'QarvModel':
        return m.compress_batch_async(ims, lmb=LMBS)
    return m.compress_batch_async(ims)


def _children(spans, parent):
    return [i for i, s in enumerate(spans) if s[3] == parent]


def _names(spans, idx):
    return [spans[i][0] for i in idx]


def test_recording_off_records_nothing(images):
    m = _model('qarv_tiny')
    assert trace.span('dec.request') is trace.span('enc.request')
    handle = _encode_async(m, images)
    assert len(handle) == 4                   # fused, handle, lambdas, grid
    m.decompress_batch_to_device(m.compress_batch_finish(handle))
    trace.start()
    assert trace.stop() == []


@pytest.mark.parametrize('name', sorted(LATENT_BLOCKS))
def test_each_request_gives_its_span_tree(name, images):
    m = _model(name)
    bodies = m.compress_batch_finish(_encode_async(m, images))  # warm
    trace.start()
    handle = _encode_async(m, images)
    got = m.compress_batch_finish(handle)
    m.decompress_batch_to_device(got)
    spans = trace.stop()
    assert got == bodies
    assert all(s[2] is not None and s[2] >= s[1] for s in spans)
    roots = _children(spans, None)
    assert _names(spans, roots) == ['enc.request', 'enc.finish',
                                    'dec.request']
    enc, fin, dec = roots
    # two chunks ([2, 1] by max_program_batch=2): the trunk, then the
    # payload's pack, a chunk; the decode pushes and decodes a chunk
    assert _names(spans, _children(spans, enc)) == ['enc.trunk',
                                                    'enc.pack'] * 2
    # on the CPU the payload is already on the host: no copy to wait for
    assert _children(spans, fin) == []
    dec_kids = _children(spans, dec)
    assert _names(spans, dec_kids) == ['dec.push', 'dec.trunk'] * 2
    blocks = LATENT_BLOCKS[name] + name.endswith('lossless')
    for k in dec_kids[1::2]:
        assert _names(spans, _children(spans, k)) == ['dec.rans'] * blocks
    for s in spans:
        if s[3] is not None:                  # inside its parent
            p = spans[s[3]]
            assert p[1] <= s[1] <= s[2] <= p[2]


@pytest.mark.parametrize('accum_num', [1, 2])
def test_a_training_step_gives_its_three_parts(accum_num):
    torch.manual_seed(0)
    model = lvae_tpu_torch.get_model('qarv_tiny', device='cpu')
    state = TrainState(model.net, optimizer='adam', ema=True)

    def loss_fn(batch, generator):
        return model.loss_and_stats(batch, training=True,
                                    generator=generator)

    step = make_train_step(loss_fn, state, accum_num=accum_num)
    batch = torch.rand(2, 3, 64, 64,
                       generator=torch.Generator().manual_seed(1))
    trace.start()
    for _ in range(2):
        step(batch, torch.Generator().manual_seed(2), 1e-4, 1e9, 0.99)
    spans = trace.stop()
    roots = _children(spans, None)
    assert _names(spans, roots) == ['train.step'] * 2
    for k, root in enumerate(roots):
        # an update on each step at accum_num 1, on the second at 2
        update = ['train.update'] if (k + 1) % accum_num == 0 else []
        assert _names(spans, _children(spans, root)) == [
            'train.forward', 'train.backward'] + update


def test_spans_nest_by_parent():
    trace.start()
    with trace.span('a'):
        with trace.span('b'):
            pass
    with trace.span('c'):
        with trace.span('d'):
            with trace.span('e'):
                pass
        with trace.span('f'):
            pass
    spans = trace.stop()
    assert [s[0] for s in spans] == list('abcdef')
    assert [s[3] for s in spans] == [None, 0, None, 2, 3, 2]
    with trace.span('g'):                 # off again
        pass
    assert trace.stop() == []


def test_a_span_closes_when_its_work_raises():
    trace.start()
    with pytest.raises(ValueError):
        with trace.span('a'):
            with trace.span('b'):
                raise ValueError('stop')
    with trace.span('c'):
        pass
    spans = trace.stop()
    # both closed, and 'c' is a root again
    assert [(s[0], s[3]) for s in spans] == [('a', None), ('b', 0),
                                             ('c', None)]
    assert all(s[2] is not None and s[2] >= s[1] for s in spans)


def test_counters_read_the_wrappers_launches():
    wrappers = trunk.KERNELS + (
        rans_decode.rans_decode_block, rans_decode.rans_decode_block_multi,
        rans_encode.rans_encode_all, rans_encode.rans_encode_all_multi)
    before = trace.counters()
    assert before == {w.__name__: w.launches for w in wrappers}
    try:
        trunk.mlp_res.launches += 3
        rans_decode.rans_decode_block_multi.launches += 2
        after = trace.counters()
    finally:
        trunk.mlp_res.launches -= 3
        rans_decode.rans_decode_block_multi.launches -= 2
    assert sum(after.values()) - sum(before.values()) == 5
    assert after['mlp_res'] - before['mlp_res'] == 3
    assert trace.counters() == before
