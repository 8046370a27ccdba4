"""What one run of a cell hands to the result line and to the per-layer
metric readers."""
import math


class Outcome:
    """attempted / failed requests or steps, the end-to-end numbers, the
    numbers compared against their limits, and what a per-layer reader may
    read: `direction` ('dec', 'enc', 'train'), `completed` requests or
    steps in `window_s`, `issue_s` (host seconds of each dispatch call),
    `flops_per_item`, `trunk_least_s` (per request), `trace` (the traced
    sub-window's Trace) and `traced_items` (the requests or steps in it)."""

    def __init__(self, direction):
        self.direction = direction
        self.attempted = self.failed = self.completed = 0
        self.window_s = self.setup_s = 0.0
        self.end_to_end = {}
        self.checks = {}            # name -> (value, limit)
        self.issue_s = []
        self.flops_per_item = None
        self.trunk_least_s = None
        self.trace = None
        self.traced_items = 0
        self.memory_peak_bytes = 0
        self.notes = {}             # printed on standard error

    def check(self, name, value, limit):
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self):
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())
