"""Run one cell of BENCHMARK.json traced, as `benchmark/run.py --trace 1`
runs it, with the program's own span recorder (lvae_tpu_torch/utils/
trace.py) on for the whole run:

    python3 benchmark/run_spans.py --workload <name> --seed <n> \
        --seconds <s>

from the root of a checkout. It is run.py's traced run, through
harness.main.main; for this run three module globals of the harness are
wrapped: the closed loop (to note the unprofiled window's bounds and the
launch counters around it), the Profiler (to keep the correlation ids that
tie each device activity to the host call that launched it) and
harness.main.report (to turn the recorder on around the cell and add what
it read). The last line of standard output is run.py's traced result line
with, besides:
- in `metrics`, the end-to-end metrics of the unprofiled window, measured
  with the recorder on (against a `--trace 0` run on the same seed: the
  recorder's cost), and the span metrics of harness/spans.py;
- `program`: the traced idle gaps named by the harness's span and the
  program's innermost span (`dispatch/dec.push`), the idle time summed by
  those names, the traced device time a request or step summed by the
  innermost span that launched it, and how many device activities were
  tied to a launch.
A program without the recorder gives run.py's line and an empty `program`.
Exits with 2 and prints no result without a CUDA card, as run.py does."""
import contextlib
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import main as harness_main  # noqa: E402
from harness import serve, spans, train  # noqa: E402


def program_view(outcome, recorded, windows, prof):
    """The run's spans.ProgramRun: the first closed loop is the unprofiled
    window; the profiler's device activities of the traced sub-window (the
    Trace's: from its first span to its end)."""
    sp = spans.Spans(spans.in_seconds(recorded))
    window = calls = None
    if windows:
        t0, t1, before, after = windows[0]
        window = (t0, t1)
        if before is not None:
            calls = {k: after[k] - before.get(k, 0) for k in after}
    attributed, host_calls = [], []
    tr = outcome.trace
    if prof is not None and tr is not None and tr.spans:
        first = tr.spans[0][1]
        device = [e for e in prof.device if first <= e[1] < tr.t1]
        attributed = spans.attribute(device, prof.launches, sp)
        host_calls = [c for c in prof.calls if first <= c[1] < tr.t1]
    return spans.ProgramRun(outcome.direction, outcome.completed, sp, window,
                            calls, outcome.traced_items, attributed,
                            host_calls)


def program_report(outcome, run, prof):
    """The result line's `program` object."""
    out = {}
    if outcome.trace is not None:
        out.update(spans.named_breakdown(outcome.trace, run.spans))
    out['device_ms_by_span'] = spans.device_ms_by_span(run)
    out['host_call_ms_by_span'] = spans.host_call_ms_by_span(run)
    out['activities'] = len(run.attributed)
    out['activities_tied'] = sum(1 for e in run.attributed
                                 if e[3] is not None)
    out['launch_records'] = len(prof.launches) if prof is not None else 0
    return out


@contextlib.contextmanager
def instrumented():
    """harness.main.report, and the runners' closed loop and Profiler,
    wrapped for the runs inside: each report runs its cell with the
    recorder on and adds to its result line what the recorder read."""
    rec = spans.recorder()
    windows, profilers = [], []
    loop, report = serve.closed_loop, harness_main.report

    def closed_loop(*args, **kwargs):
        before = rec.counters() if rec else None
        t = time.time_ns()
        try:
            return loop(*args, **kwargs)
        finally:
            windows.append((t * 1e-9, time.time_ns() * 1e-9, before,
                            rec.counters() if rec else None))

    def profiler(device):
        profilers.append(spans.SpanProfiler(device))
        return profilers[-1]

    def traced_report(spec, args, device, t0):
        windows.clear()
        profilers.clear()
        if rec is not None:
            rec.start()
        try:
            result, outcome = report(spec, args, device, t0)
        finally:
            recorded = rec.stop() if rec is not None else []
        for m in spec.end_to_end:
            if m['name'] in outcome.end_to_end:
                result['metrics'][m['name']] = {
                    'value': outcome.end_to_end[m['name']],
                    'unit': m['unit']}
        program = {}
        if rec is not None:
            prof = profilers[-1] if profilers else None
            run = program_view(outcome, recorded, windows, prof)
            units = {'calls.dec': 'calls'}
            for name, value in spans.read_all(run).items():
                result['metrics'][name] = {'value': value,
                                           'unit': units.get(name, 'ms')}
            program = program_report(outcome, run, prof)
        checks = result.pop('checks')          # still the last key
        result['program'] = program
        result['checks'] = checks
        return result, outcome

    saved = (serve.closed_loop, serve.Profiler, train.Profiler,
             harness_main.report)
    serve.closed_loop = closed_loop
    serve.Profiler = train.Profiler = profiler
    harness_main.report = traced_report
    try:
        yield
    finally:
        (serve.closed_loop, serve.Profiler, train.Profiler,
         harness_main.report) = saved


def main(argv):
    import run  # noqa: F401  (run.py's build and kernel caches)
    with instrumented():
        return harness_main.main(list(argv) + ['--trace', '1'], T0)


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
