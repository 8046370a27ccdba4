"""The trunk's least time a request over its kernels' traced device time,
in % (harness/readers.py)."""
from harness.readers import trunk_roofline


def read(run):
    return trunk_roofline(run) if run.direction == 'dec' else None
