"""Host milliseconds of one dispatch call over the window's requests
(harness/readers.py)."""
from harness.readers import issue_ms


def read(run):
    return issue_ms(run) if run.direction == 'enc' else None
