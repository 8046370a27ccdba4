"""The window's operations over its seconds, as a share of the card's
float32 peak, in % (harness/readers.py)."""
from harness.readers import mfu


def read(run):
    return mfu(run) if run.direction == 'dec' else None
