"""The program's own spans and launch counters (lvae_tpu_torch/utils/
trace.py), read beside the harness's spans and the profiler's device
activities, all on the wall clock (seconds since the epoch).

A program span is (name, start_s, end_s, parent): `parent` the index of
the enclosing span. Spans nest within one recording, so the innermost span open at a moment is found from
the last span started before it by walking up its parents.

- A traced idle gap is named by the harness span it began in and the
  innermost program span open at that moment: 'dispatch/dec.push'; with no
  program span open, by the harness span alone, as Trace.breakdown names
  it (its gaps, renamed).
- A device activity belongs to the innermost program span open at the
  host-side call that launched it: the profile's CUDA runtime (or driver)
  record with the activity's correlation id.
- The formulas of the span metrics, each once, as in harness/readers.py:
  each takes a ProgramRun and returns None where the run has nothing for it
  to read (a program without the recorder, a cell without the span)."""
import bisect
import importlib

import torch

from harness.trace import Profiler


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        return importlib.import_module('lvae_tpu_torch.utils.trace')
    except ImportError:
        return None


def in_seconds(spans):
    """The recorder's spans (times in ns; an unclosed span's end None) ->
    the same tuples in seconds, an unclosed span ending at its start."""
    return [(n, a * 1e-9, (a if b is None else b) * 1e-9, p)
            for n, a, b, p in spans]


class Spans:
    """Program spans, in the order they were opened (by start time), with
    the innermost-span lookup."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.starts = [s[1] for s in self.spans]

    def innermost(self, t):
        """The index of the innermost span open at `t` (start <= t < end),
        or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            _, a, b, parent = self.spans[i]
            if a <= t < b:
                return i
            i = parent
        return None

    def name_at(self, t):
        i = self.innermost(t)
        return None if i is None else self.spans[i][0]

    def inside(self, i, name):
        """True where span `i` is named `name` or lies inside one that is."""
        while i is not None:
            if self.spans[i][0] == name:
                return True
            i = self.spans[i][3]
        return False


def named_breakdown(trace, spans, top=10):
    """Trace.breakdown's idle gaps, each renamed by the harness span it
    began in joined by '/' to the innermost program span open then, where
    there is one -> {'idle_gaps': the longest, 'idle_by_span': the idle
    seconds summed by name}, each longest first."""
    host_at = trace._host_at

    def joined(t):
        prog = spans.name_at(t)
        return host_at(t) if prog is None else f'{host_at(t)}/{prog}'

    trace._host_at = joined
    try:
        gaps = trace.breakdown(top=None)['idle_gaps']
    finally:
        del trace._host_at
    total = {}
    for n, s in gaps:
        total[n] = total.get(n, 0.0) + s
    return {'idle_gaps': gaps[:top],
            'idle_by_span': [[n, s] for n, s in
                             sorted(total.items(), key=lambda kv: -kv[1])]}


def attribute(device, launches, spans):
    """Device activities (name, start_s, end_s, correlation id) -> (name,
    start_s, end_s, the index of the innermost program span open at the
    host call with that correlation id, or None)."""
    out = []
    for n, a, b, corr in device:
        t = launches.get(corr)
        out.append((n, a, b, None if t is None else spans.innermost(t)))
    return out


def launch_records(prof):
    """From a finished torch.profiler profile (one more walk over its
    events than harness/trace.py's _device_events, which drops the
    correlation id): (device activities as (name, start_s, end_s,
    correlation id), {correlation id: host start of the
    CUDA runtime or driver call that launched it}, every such host call as
    (name, start_s, end_s))."""
    device, launches, calls = [], {}, []
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), start, end, corr))
        elif corr:
            # a runtime call and a driver call under it may share the id:
            # the outer one starts first
            launches[corr] = min(start, launches.get(corr, start))
            calls.append((e.name(), start, end))
    return device, launches, calls


class SpanProfiler(Profiler):
    """The harness's Profiler, which also keeps, after stop(), the device
    activities with their correlation ids and the host calls that launched
    them (launch_records)."""

    def __init__(self, device):
        super().__init__(device)
        self.device, self.launches, self.calls = [], {}, []

    def stop(self):
        running = self.running
        super().stop()
        if running:
            self.device, self.launches, self.calls = launch_records(
                self.prof)


class ProgramRun:
    """What a span metric reads: the run's `direction`, the unprofiled
    window's `completed` requests or steps, `spans` (Spans of the whole run),
    `window` ((start_s, end_s) of the unprofiled window, None where the
    cell's window is not a closed loop), `calls` (the launch counters'
    growth over that window, None without it), `traced_items`,
    `attributed` (attribute() over the traced sub-window's activities) and
    `host_calls` (the sub-window's CUDA runtime and driver calls as (name,
    start_s, end_s))."""

    def __init__(self, direction, completed, spans, window=None, calls=None,
                 traced_items=0, attributed=(), host_calls=()):
        self.direction, self.completed = direction, completed
        self.spans, self.window, self.calls = spans, window, calls
        self.traced_items, self.attributed = traced_items, list(attributed)
        self.host_calls = list(host_calls)


def span_ms(run, name, less=None):
    """Host milliseconds a request of the spans `name` that start in the
    unprofiled window, less those of their children named `less`."""
    if run.window is None or not run.completed or run.spans is None:
        return None
    t0, t1 = run.window
    sp = run.spans.spans
    hit = [i for i, s in enumerate(sp) if s[0] == name and t0 <= s[1] <= t1]
    if not hit:
        return None
    total = sum(sp[i][2] - sp[i][1] for i in hit)
    if less is not None:
        mine = set(hit)
        total -= sum(s[2] - s[1] for s in sp
                     if s[0] == less and s[3] in mine)
    return 1e3 * total / run.completed


def calls_per_request(run):
    """Kernel wrapper calls (the launch counters' growth over the unprofiled
    window) a completed request."""
    if run.calls is None or not run.completed:
        return None
    return sum(run.calls.values()) / run.completed


def device_ms_inside(run, name):
    """Device milliseconds a traced request or step of the activities
    launched inside a program span `name` (or a span within it)."""
    if not run.traced_items or run.spans is None:
        return None
    hit = [b - a for _, a, b, i in run.attributed
           if i is not None and run.spans.inside(i, name)]
    if not hit:
        return None
    return 1e3 * sum(hit) / run.traced_items


def device_ms_by_span(run):
    """Traced device milliseconds a request or step, summed by the name of
    the innermost program span that launched each activity ('-' for those
    launched outside every program span or not matched to a launch),
    largest first."""
    if not run.traced_items or not run.attributed:
        return []
    total = {}
    for _, a, b, i in run.attributed:
        key = '-' if i is None else run.spans.spans[i][0]
        total[key] = total.get(key, 0.0) + (b - a)
    return _ranked_ms(total, run.traced_items)


def host_call_ms_by_span(run, top=10):
    """Traced host milliseconds a request or step inside CUDA runtime and
    driver calls, summed by the innermost program span open at each call
    and the call's name ('span:call'; '-' outside every span), largest
    first: where the host waits on the device (a copy from pageable
    memory, a synchronize) or pays for launches."""
    if not run.traced_items or not run.host_calls:
        return []
    total = {}
    for n, a, b in run.host_calls:
        i = run.spans.innermost(a)
        key = ('-' if i is None else run.spans.spans[i][0]) + ':' + n
        total[key] = total.get(key, 0.0) + (b - a)
    return _ranked_ms(total, run.traced_items, top)


def _ranked_ms(seconds, items, top=None):
    """{key: seconds} -> [[key, ms an item]], largest first."""
    ranked = sorted(seconds.items(), key=lambda kv: -kv[1])[:top]
    return [[k, 1e3 * v / items] for k, v in ranked]


# the span metrics: name -> (the cell direction it reads, its formula)
METRICS = {
    'push_ms.dec': ('dec', lambda r: span_ms(r, 'dec.push')),
    'trunk_issue_ms.dec': ('dec', lambda r: span_ms(r, 'dec.trunk')),
    'calls.dec': ('dec', calls_per_request),
    'assemble_ms.enc': ('enc', lambda r: span_ms(r, 'enc.finish',
                                                 less='enc.pull_wait')),
    'pack_ms.enc': ('enc', lambda r: device_ms_inside(r, 'enc.pack')),
    'update_ms.train': ('train',
                        lambda r: device_ms_inside(r, 'train.update')),
}


def read_all(run):
    """{metric: value} of every span metric that the run has something
    for."""
    out = {}
    for name, (direction, formula) in METRICS.items():
        if run.direction == direction:
            v = formula(run)
            if v is not None:
                out[name] = float(v)
    return out
