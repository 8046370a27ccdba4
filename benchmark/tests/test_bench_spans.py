"""The program's spans read beside the harness's (harness/spans.py) and the
traced run that records them (run_spans.py): gap names, the attribution of
device activities, the span metrics' formulas on synthetic runs, and the
tiny cells run with the recorder on, on the CPU."""
import argparse
import math
import time

import pytest

from harness import spans
from harness.main import LayerView
from harness.outcome import Outcome
from harness.spec import BENCH, Spec, metric_reader
from harness.trace import Trace

# the traced window opens at the first wait (-0.5, the loop full); a decode
# request: dispatch 0-10 (dec.request 0.5-9.5: push 1-3, trunk 3-9 with two
# rANS blocks), its wait 10-14; a second request's dispatch 14-20 with no
# program span (a program without the recorder)
PROGRAM = [('dec.request', 0.5, 9.5, None), ('dec.push', 1.0, 3.0, 0),
           ('dec.trunk', 3.0, 9.0, 0), ('dec.rans', 4.0, 5.0, 2),
           ('dec.rans', 7.0, 8.0, 2)]
HARNESS = [('warm', -2.0, -1.0), ('wait', -0.5, 0.0), ('dispatch', 0.0, 10.0),
           ('wait', 10.0, 14.0), ('dispatch', 14.0, 20.0)]


def _trace(events):
    return Trace(events, HARNESS)


def test_the_innermost_span_open_at_a_moment():
    sp = spans.Spans(PROGRAM)
    assert sp.innermost(0.2) is None
    assert sp.innermost(1.0) == 1
    assert sp.innermost(3.5) == 2
    assert sp.innermost(4.5) == 3
    assert sp.innermost(6.0) == 2          # after a child, its parent
    assert sp.innermost(9.2) == 0
    assert sp.innermost(12.0) is None
    assert sp.inside(4, 'dec.trunk') and sp.inside(4, 'dec.request')
    assert not sp.inside(1, 'dec.trunk')


def test_gaps_join_the_harness_span_and_the_innermost_program_span():
    # busy 0-1.5, 3.5-4.2, 9.6-12, 16-20: gaps begin at -0.5 (the first
    # wait), 1.5 (push), 4.2 (a rANS block), 12 (the wait, no program span)
    tr = _trace([('k', 0.0, 1.5), ('k', 3.5, 4.2), ('k', 9.6, 12.0),
                 ('k', 16.0, 20.0)])
    bd = spans.named_breakdown(tr, spans.Spans(PROGRAM), top=None)
    assert bd['idle_gaps'] == [['dispatch/dec.rans', pytest.approx(5.4)],
                               ['wait', 4.0], ['dispatch/dec.push', 2.0],
                               ['wait', 0.5]]
    # the harness's own breakdown names the same gaps by its span alone,
    # and is left as it was
    assert [s for _, s in tr.breakdown()['idle_gaps']] == [
        s for _, s in bd['idle_gaps']]
    assert '_host_at' not in vars(tr)
    bd = spans.named_breakdown(tr, spans.Spans(PROGRAM), top=2)
    assert bd['idle_gaps'] == [['dispatch/dec.rans', pytest.approx(5.4)],
                               ['wait', 4.0]]
    assert bd['idle_by_span'] == [['dispatch/dec.rans', pytest.approx(5.4)],
                                  ['wait', 4.5], ['dispatch/dec.push', 2.0]]
    # no program spans: the harness's names
    assert spans.named_breakdown(tr, spans.Spans([]), top=None)[
        'idle_gaps'] == tr.breakdown()['idle_gaps']


def test_each_activity_goes_to_the_innermost_span_that_launched_it():
    device = [('copy', 2.5, 2.6, 11), ('rans', 5.0, 5.5, 12),
              ('gemm', 6.0, 7.0, 13), ('tail', 9.7, 9.8, 14),
              ('unmatched', 9.9, 10.0, 99)]
    launches = {11: 2.0, 12: 4.5, 13: 5.5, 14: 9.2, 15: 12.0}
    out = spans.attribute(device, launches, spans.Spans(PROGRAM))
    # by the host call's time, not by the activity's: 'rans' ran after its
    # block closed, 'gemm' was launched between the two blocks
    assert [e[3] for e in out] == [1, 3, 2, 0, None]


def _run(**kw):
    base = dict(direction='dec', completed=2, spans=spans.Spans(PROGRAM),
                window=(0.0, 20.0), calls={'mlp_res': 30, 'dense': 4},
                traced_items=2)
    base.update(kw)
    return spans.ProgramRun(**base)


def test_the_span_metrics_formulas():
    run = _run(attributed=spans.attribute(
        [('rans', 5.0, 5.5, 12), ('gemm', 6.0, 7.0, 13)],
        {12: 4.5, 13: 5.5}, spans.Spans(PROGRAM)))
    got = spans.read_all(run)
    # host ms a completed request; calls a request
    assert got == {'push_ms.dec': 1e3 * 2.0 / 2,
                   'trunk_issue_ms.dec': 1e3 * 6.0 / 2,
                   'calls.dec': 17.0}
    # device ms a traced item launched inside a span or its children
    assert spans.device_ms_inside(run, 'dec.trunk') == pytest.approx(750.0)
    assert spans.device_ms_inside(run, 'dec.rans') == pytest.approx(250.0)
    assert spans.device_ms_by_span(run) == [['dec.trunk', 500.0],
                                            ['dec.rans', 250.0]]
    # host time in runtime calls, by the span they were made in
    run.host_calls = [('cudaMemcpyAsync', 2.0, 2.9),
                      ('cudaLaunchKernel', 4.5, 4.6),
                      ('cudaLaunchKernel', 5.5, 5.6),
                      ('cudaEventSynchronize', 10.0, 14.0)]
    assert spans.host_call_ms_by_span(run, top=3) == [
        ['-:cudaEventSynchronize', 2000.0],
        ['dec.push:cudaMemcpyAsync', pytest.approx(450.0)],
        ['dec.rans:cudaLaunchKernel', pytest.approx(50.0)]]
    # spans outside the unprofiled window are not read
    assert spans.span_ms(_run(window=(9.8, 20.0)), 'dec.push') is None


def test_the_encode_and_training_formulas():
    prog = [('enc.request', 0.0, 4.0, None), ('enc.trunk', 0.5, 2.0, 0),
            ('enc.pack', 2.0, 3.5, 0), ('enc.finish', 5.0, 9.0, None),
            ('enc.pull_wait', 5.5, 8.0, 3),
            ('train.step', 10.0, 15.0, None),
            ('train.update', 13.0, 14.0, 5)]
    sp = spans.Spans(prog)
    dev = spans.attribute([('encode', 3.0, 3.2, 1), ('lookup', 4.0, 4.1, 2),
                           ('adam', 14.0, 14.5, 3)],
                          {1: 2.5, 2: 3.0, 3: 13.5}, sp)
    enc = _run(direction='enc', spans=sp, window=(0.0, 9.0), calls=None,
               attributed=dev)
    got = spans.read_all(enc)
    # the finish less its wait for the copy, a request
    assert got['assemble_ms.enc'] == pytest.approx(1e3 * 1.5 / 2)
    assert got['pack_ms.enc'] == pytest.approx(1e3 * 0.3 / 2)
    assert set(got) == {'assemble_ms.enc', 'pack_ms.enc'}
    train = _run(direction='train', spans=sp, window=None, calls=None,
                 attributed=dev, traced_items=5)
    assert spans.read_all(train) == {
        'update_ms.train': pytest.approx(1e3 * 0.5 / 5)}


def test_the_metrics_read_none_without_their_spans():
    empty = _run(spans=spans.Spans([]), calls=None, attributed=[])
    assert spans.read_all(empty) == {}
    assert spans.read_all(_run(spans=None, calls=None)) == {}
    assert spans.read_all(_run(completed=0)) == {}
    train = _run(direction='train', window=None, calls=None,
                 attributed=[('k', 0.0, 1.0, None)])
    assert spans.read_all(train) == {}
    assert spans.device_ms_by_span(train) == [['-', 500.0]]


def _existing(outcome):
    view = LayerView(outcome, BENCH)
    out = {}
    for name in ('idle_pct.dec', 'issue_ms.dec', 'mfu.dec', 'rans_ms.dec',
                 'trunk_roofline.dec'):
        out[name] = metric_reader(name, BENCH)(view)
    return out


def test_the_existing_readers_read_the_same_with_program_spans():
    out = Outcome('dec')
    out.trace = _trace([('rans_decode_block_kernel<1, true>(int)',
                         0.0, 1.5), ('tiled_kernel<1>(int)', 3.5, 4.2)])
    out.traced_items, out.completed, out.window_s = 2, 5, 1.0
    out.issue_s, out.flops_per_item, out.trunk_least_s = [0.01], 1e9, 1e-4
    before = _existing(out)
    bd = out.trace.breakdown()
    run = _run(attributed=spans.attribute(
        [('k', 0.0, 1.5, 1)], {1: 1.5}, spans.Spans(PROGRAM)))
    spans.read_all(run)
    spans.named_breakdown(out.trace, run.spans)
    assert _existing(out) == before and out.trace.breakdown() == bd
    assert None not in before.values()


@pytest.mark.parametrize('cell', ['qarv_tiny.dec', 'qres_tiny.dec',
                                  'qarv_tiny.enc', 'qarv_tiny.train'])
def test_a_tiny_cell_run_with_the_recorder(tiny_bench, cell):
    import run_spans
    from harness import main as harness_main
    from harness import serve, train
    root, bench = tiny_bench
    saved = (serve.closed_loop, serve.Profiler, train.Profiler,
             harness_main.report)
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 41, seconds=0.5,
                              trace=1)
    with run_spans.instrumented():
        result, outcome = harness_main.report(
            Spec(cell, root, bench), args, 'cpu', time.perf_counter())
    assert (serve.closed_loop, serve.Profiler, train.Profiler,
            harness_main.report) == saved
    assert result['correct'] is True and list(result)[-2:] == ['program',
                                                                'checks']
    m = {k: v['value'] for k, v in result['metrics'].items()}
    kind = cell.split('.')[1]
    assert 'setup_s' in m and 'mfu.' + kind in m
    # host spans and counters read on the CPU too; device time does not
    want = {'dec': {'push_ms.dec', 'trunk_issue_ms.dec', 'calls.dec'},
            'enc': {'assemble_ms.enc'}, 'train': set()}[kind]
    got = {k for k in m if k in spans.METRICS}
    assert got == want
    assert all(math.isfinite(m[k]) for k in got)
    if kind == 'dec':
        # no launch on the CPU; the push and the trunk lie within the
        # dispatch
        assert m['calls.dec'] == 0.0
        assert m['push_ms.dec'] + m['trunk_issue_ms.dec'] <= (
            m['issue_ms.dec'] * 1.001)
    gaps = result['program']['idle_gaps']
    assert gaps and sum(s for _, s in result['program']['idle_by_span']) \
        == pytest.approx(sum(s for _, s in result['breakdown']['idle_gaps']))
