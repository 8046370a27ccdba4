"""Traced device milliseconds a decode request of the rANS decode kernels
(layers/rans/decode.json)."""
from harness.readers import kernel_ms


def read(run):
    if run.direction != 'dec':
        return None
    return kernel_ms(run, run.layer('rans', 'decode'))
