"""Traced device milliseconds an encode request of the kernels not compiled
from the port's csrc/ (harness/readers.py)."""
from harness.readers import library_ms


def read(run):
    return library_ms(run) if run.direction == 'enc' else None
