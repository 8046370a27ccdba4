"""The harness's own arithmetic and its data-driven layout, on the CPU."""
import argparse
import json
import time

import numpy as np
import pytest
import torch

from conftest import QARV_TINY, QRES_TINY
from harness import inputs, roofline, serve
from harness.main import LayerView, report
from harness.outcome import Outcome
from harness.spec import Spec, layer_patterns, metric_reader
from harness.trace import Trace


def test_new_files_are_found_by_name(tiny_bench):
    root, bench = tiny_bench
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    (bench / 'configs' / 'added.json').write_text(json.dumps(
        dict(name='added', port_model='qarv_tiny', net=QARV_TINY)))
    spec['configs'].append(dict(name='added', source='t', reduced=[],
                                why='t', file='benchmark/configs/added.json'))
    (bench / 'traffic' / 'dec.added.json').write_text(json.dumps(
        dict(kind='dec', batch=3)))
    spec['workloads'].append(dict(name='added.dec', config='added',
                                  traffic='dec.added', chips=1, why='t'))
    (bench / 'limits' / 'added.dec.json').write_text('{"rms_gap": 0.5}')
    (bench / 'metrics' / 'added_ms.dec.py').write_text(
        'def read(run):\n    return 42.0\n')
    spec['per_layer'].append(dict(name='added_ms.dec', unit='ms',
                                  better='lower', source='device_trace',
                                  layer='added', moves='dec_mpix_s',
                                  workloads=['added.dec']))
    (bench / 'layers' / 'added').mkdir()
    (bench / 'layers' / 'added' / 'k.json').write_text(
        '{"kernels": ["added_kernel"]}')
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))

    s = Spec('added.dec', root, bench)
    assert s.config['name'] == 'added' and s.traffic['batch'] == 3
    assert s.limits == {'rms_gap': 0.5}
    assert 'added_ms.dec' in [m['name'] for m in s.per_layer]
    assert metric_reader('added_ms.dec', bench)(None) == 42.0
    pats = layer_patterns('added', bench=bench)
    assert any(p.search('void (anonymous namespace)::added_kernel<4>(int)')
               for p in pats)
    assert not any(p.search('void added_kernel_impl(int)') for p in pats)


def test_the_seed_fixes_the_requests(tiny_bench):
    tr = dict(batch=3, lambdas=[16.0, 100.0, 2048.0], per_lambda=2)
    a = inputs.request_pool(tr, 2 ** 31 + 5, 12)
    b = inputs.request_pool(tr, 2 ** 31 + 5, 12)
    c = inputs.request_pool(tr, 7, 12)
    assert [(q.variants, q.lmb) for q in a] == [(q.variants, q.lmb)
                                                for q in b]
    assert [q.variants for q in a] != [q.variants for q in c]
    # every seed gets the same lambdas and sizes
    assert sorted(q.lmb for q in a) == sorted(q.lmb for q in c)
    oa, ob = inputs.order(a, 11), inputs.order(b, 11)
    assert [next(oa).index for _ in range(30)] == [next(ob).index
                                                   for _ in range(30)]
    # a cycle serves every request of the pool once
    o = inputs.order(a, 3)
    assert sorted(next(o).index for _ in range(len(a))) == list(range(6))


def _fake_loop(seconds, service_s, outstanding=2):
    """closed_loop on a fake system that takes service_s a request."""
    state = {'free_at': 0.0}

    def dispatch(q):
        start = max(time.perf_counter(), state['free_at'])
        state['free_at'] = start + service_s[q.index % len(service_s)]
        return state['free_at']

    def wait(done_at):
        while time.perf_counter() < done_at:
            time.sleep(0.0005)
        return done_at

    pool = [inputs.Request(i, [0], None) for i in range(4)]
    out, seen = Outcome('dec'), []
    lat = serve.closed_loop(dispatch, wait, inputs.order(pool, 1), seconds,
                            outstanding, out, seen.append)
    return out, lat, seen


def test_the_rate_is_all_the_work_over_all_the_time():
    out, lat, seen = _fake_loop(0.3, [0.01])
    # every request dispatched is waited for: the window closes at the
    # last result, after the deadline
    assert out.completed == out.attempted == len(lat) == len(seen)
    assert out.window_s >= 0.3
    # served back to back: the work fills the whole window
    assert out.completed * 0.01 == pytest.approx(out.window_s, rel=0.1)


def test_the_tail_is_over_all_requests():
    out, lat, _ = _fake_loop(0.4, [0.002, 0.002, 0.002, 0.03])
    assert len(lat) == out.completed
    slow = sorted(lat)[-max(1, out.completed // 4):]
    # the slow quarter of the requests is what the 95th percentile reads
    assert np.percentile(lat, 95) >= min(slow)


def test_idle_share_from_a_synthetic_timeline():
    # the idle window opens at the first wait, when the loop is full, and
    # closes at the end of the last span
    tr = Trace([('warmup', -1.0, -0.5), ('k1', 0.5, 1.5), ('k2', 1.2, 2.0),
                ('k3', 3.0, 4.0), ('outside', 6.0, 7.0)],
               [('warm', -1.0, -0.4), ('dispatch', 0.0, 1.0),
                ('wait', 1.0, 2.5), ('dispatch', 2.5, 5.0)])
    assert tr.window_s == 4.0
    assert [e[0] for e in tr.events] == ['k1', 'k2', 'k3']
    # busy 1.0-2.0 (k1 clipped to the window, k2 overlapping) and 3.0-4.0
    assert tr.busy_s() == pytest.approx(2.0)
    out = Outcome('dec')
    out.trace, out.traced_items = tr, 2
    view = LayerView(out, None)
    from harness.spec import BENCH
    assert metric_reader('idle_pct.dec', BENCH)(view) == pytest.approx(50.0)
    assert metric_reader('idle_pct.enc', BENCH)(view) is None
    bd = tr.breakdown()
    assert bd['idle_gaps'] == [['wait', 1.0], ['dispatch', 1.0]]
    assert bd['device_ops'][0] == ['k1', 1.0]


def test_host_spans_share_the_profilers_clock():
    # the spans are the harness's, on the wall clock that the profiler
    # stamps its events with
    from harness.trace import Profiler, span
    prof = Profiler('cpu')
    prof.start()
    with span('wait'):
        torch.ones(64).sum()
    prof.stop()
    (name, a, b), = prof.spans
    events = [e for e in prof.prof.profiler.kineto_results.events()
              if e.name() == 'aten::sum']
    assert name == 'wait' and events
    assert a <= events[0].start_ns() * 1e-9 <= b
    with span('dispatch'):        # no profiler: nothing recorded
        pass
    assert len(prof.spans) == 1


def test_trunk_roofline_arithmetic():
    m = roofline._m
    nbytes, ops = roofline.work('dense', (m(2, 10, 4), m(4, 6), m(6)))
    assert nbytes == 4 * (80 + 2 * 10 * 6 + 24 + 6)
    assert ops == 2 * 20 * 24
    calls = [('dense', (m(2, 10, 4), m(4, 6), m(6)))]
    assert roofline.least_seconds(calls) == max(
        nbytes / roofline.PEAK_BYTES_PER_S, ops / roofline.PEAK_F32_PER_S)
    # qarv_tiny: the embedding, per latent block two AdaLN blocks, prior
    # and fuse; the tail's two AdaLN blocks and its upsamples on decode
    dec = [n for n, _ in roofline.trunk_calls(QARV_TINY, 'dec', 2, 64, 64)]
    enc = [n for n, _ in roofline.trunk_calls(QARV_TINY, 'enc', 2, 64, 64)]
    assert enc == ['emb_mlp'] + ['dw_ln_mod', 'mlp_res', 'prior_head',
                                 'fuse_zproj', 'dw_ln_mod', 'mlp_res',
                                 'dense'] + ['dw_ln_mod', 'mlp_res',
                                             'prior_head', 'fuse_zproj',
                                             'dw_ln_mod', 'mlp_res']
    assert dec == enc + ['dw_ln_mod', 'mlp_res', 'dense', 'dw_ln_mod',
                         'mlp_res', 'upsample_finish']
    # the reader: trunk kernels taking twice the least time read 50 %
    out = Outcome('dec')
    out.trunk_least_s = 0.001
    out.traced_items = 2
    out.trace = Trace([('void (anonymous namespace)::tiled_kernel<1>(int)',
                        0.0, 0.004), ('cudnn_conv', 0.004, 0.005)],
                      [('wait', 0.0, 0.005)])
    from harness.spec import BENCH
    view = LayerView(out, BENCH)
    assert metric_reader('trunk_roofline.dec', BENCH)(view) == \
        pytest.approx(50.0)


def _hand_flops(net, run):
    """2 x multiply-adds of every conv and linear, from forward hooks."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight[0].numel()
            total[0] += 2 * out.numel() * k
        else:
            total[0] += 2 * out.numel() * mod.in_features
    for mod in net.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        run()
    return total[0]


@pytest.mark.parametrize('cfg', [QARV_TINY, QRES_TINY],
                         ids=['qarv_tiny', 'qres_tiny'])
def test_flop_count_at_a_tiny_size(cfg):
    from reference.nets import CodecNet
    torch.manual_seed(0)
    net = CodecNet(cfg)
    im = torch.rand(2, 3, 64, 64)
    lmb = torch.tensor([16.0, 512.0]) if net.qarv else None
    enc = _hand_flops(net, lambda: net.encode(im, lmb))
    assert roofline.reference_flops(cfg, 'enc', 2, 64, 64) == enc
    syms, _ = net.encode(im, lmb)
    net2 = CodecNet(cfg)
    dec = _hand_flops(net2, lambda: net2.decode(syms, lmb, (1, 1)))
    assert roofline.reference_flops(cfg, 'dec', 2, 64, 64) == dec


def _report(tiny_bench, cell, trace):
    root, bench = tiny_bench
    spec = Spec(cell, root, bench)
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 77, seconds=0.5,
                              trace=trace)
    return report(spec, args, 'cpu', time.perf_counter())


@pytest.mark.parametrize('trace', [0, 1])
def test_result_line_keys(tiny_bench, trace):
    result, _ = _report(tiny_bench, 'qarv_tiny.dec', trace)
    keys = ['correct', 'attempted', 'failed', 'metrics', 'device']
    keys += ['breakdown'] if trace else []
    # the numbers compared, beside their limits, come last
    assert list(result) == keys + ['checks']
    assert result['correct'] is True and result['failed'] == 0
    assert set(result['checks']) == {'differ_gap', 'rate_excess'}
    names = set(result['metrics'])
    if trace:
        assert {'issue_ms.dec', 'mfu.dec'} <= names
        assert {'busy_s', 'window_s'} <= set(result['device'])
    else:
        assert names == {'dec_mpix_s', 'req_p95_ms', 'setup_s'}
    json.dumps(result)
