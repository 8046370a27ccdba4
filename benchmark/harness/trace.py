"""The traced run: torch.profiler over a sub-window of whole requests or
steps, recording the device's activity alone (CUDA, no host operators, so
that the profiler adds little to the host's issue), reduced to the
device's busy intervals, kernel time by name, the idle share and the idle
gaps by what the host was doing. The host spans around the harness's calls
into the program are the harness's own, on the wall clock that the
profiler's timestamps use (nanoseconds since the epoch)."""
import time

import torch

_RECORDING = None      # the running Profiler's list of host spans


class span:
    """A host span around a call into the program: (name, start_s, end_s)
    recorded while a Profiler runs, a no-op otherwise."""
    __slots__ = ('name', 't0')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns() if _RECORDING is not None else None
        return self

    def __exit__(self, *exc):
        if _RECORDING is not None and self.t0 is not None:
            _RECORDING.append((self.name, self.t0 * 1e-9,
                               time.time_ns() * 1e-9))


class Trace:
    """Device activities (kernels, copies, sets) as (name, start_s, end_s)
    and the harness's host spans, on one clock.

    `events` are the device activities of the traced requests or steps: from
    the first span to the last ('warm', the profiler's start-up, is before).
    The window opens at the first 'wait' where there is one, when the closed
    loop is full, so that the device's wait for the first dispatch is not
    counted as idle, and closes at the end of the last span."""

    def __init__(self, device_events, spans):
        self.spans = sorted((s for s in spans if s[0] != 'warm'),
                            key=lambda s: s[1])
        if self.spans:
            first = self.spans[0][1]
            self.t1 = max(s[2] for s in self.spans)
            waits = [s[1] for s in self.spans if s[0] == 'wait']
            self.t0 = min(waits) if waits else first
        else:
            first = self.t0 = self.t1 = 0.0
        self.events = [e for e in device_events
                       if e[1] >= first and e[1] < self.t1]

    @property
    def window_s(self):
        return self.t1 - self.t0

    def busy_intervals(self):
        """The union of the device's activities, clipped to the window."""
        out = []
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            elif b > a:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals())

    def _host_at(self, t):
        name = 'host'
        for n, a, b in self.spans:
            if a <= t < b:
                name = n
        return name

    def breakdown(self, top=10):
        """{'device_ops': the activities that took the most device time,
        'idle_gaps': the longest gaps, each named by the host span it
        began in}, each list (name, seconds) longest first."""
        by_name = {}
        for n, a, b in self.events:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                gaps.append((self._host_at(prev), a - prev))
            prev = max(prev, b)
        gaps.sort(key=lambda g: -g[1])
        return {'device_ops': [[n, s] for n, s in ops],
                'idle_gaps': [[n, s] for n, s in gaps[:top]]}


def _device_events(prof):
    """(name, start_s, end_s) of every device activity in the profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


class Profiler:
    """Starts and stops torch.profiler (the device's activity only) and the
    host spans around a sub-window; `trace` holds the reduced Trace after
    stop()."""

    def __init__(self, device):
        cuda = torch.device(device).type == 'cuda'
        acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.spans = []
        self.trace = None
        self.running = False

    def start(self):
        global _RECORDING
        self.prof.__enter__()
        _RECORDING = self.spans
        self.running = True

    def stop(self):
        global _RECORDING
        if self.running:
            _RECORDING = None
            self.prof.__exit__(None, None, None)
            self.running = False
            self.trace = Trace(_device_events(self.prof), self.spans)
