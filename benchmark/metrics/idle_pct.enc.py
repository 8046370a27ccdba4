"""The share of the traced window in which the device runs nothing, in %
(harness/readers.py)."""
from harness.readers import idle_pct


def read(run):
    return idle_pct(run) if run.direction == 'enc' else None
