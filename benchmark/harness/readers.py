"""The formulas of the per-layer metrics, each once; a reader in metrics/
checks its cell's direction and calls one. Each takes the run's
LayerView (harness/main.py) and returns None where the run has nothing
for it to read."""
import re

from harness.roofline import PEAK_F32_PER_S
from harness.spec import matches

COPIES = [re.compile(r'^Mem(cpy|set)')]


def kernel_ms(run, patterns, exclude=None):
    """Device milliseconds a traced request or step of the traced kernels
    matching `patterns` (and not `exclude`); None when the trace shows no
    such kernel."""
    tr = run.trace
    if tr is None or not run.traced_items:
        return None
    hit = [b - a for n, a, b in tr.events if matches(n, patterns)
           and not (exclude and matches(n, exclude))]
    if not hit:
        return None
    return 1e3 * sum(hit) / run.traced_items


def library_ms(run):
    """Every device kernel but the trunk's and rANS's (layers/) and the
    copies and sets: cuDNN, cuBLAS, PyTorch's own kernels."""
    return kernel_ms(run, [re.compile('.')],
                     run.layer('trunk') + run.layer('rans') + COPIES)


def trunk_roofline(run):
    """The trunk's least time a request (harness/roofline.py) over the
    traced device time of the trunk's kernels a request, in %."""
    ms = kernel_ms(run, run.layer('trunk'))
    if run.trunk_least_s is None or not ms:
        return None
    return 100.0 * run.trunk_least_s * 1e3 / ms


def issue_ms(run):
    """Host milliseconds of one dispatch call, over every request or step
    of the unprofiled window."""
    if not run.issue_s:
        return None
    return 1e3 * sum(run.issue_s) / len(run.issue_s)


def mfu(run):
    """The window's operations (the reference's at the cell's shapes times
    the requests or steps completed) over its seconds, as a share of the
    card's float32 peak outside the tensor cores, in %."""
    if not run.flops_per_item or not run.window_s:
        return None
    return 100.0 * run.flops_per_item * run.completed / run.window_s \
        / PEAK_F32_PER_S


def idle_pct(run):
    """The share of the traced window in which the device runs nothing:
    1 minus the union of its activities over the window, in %."""
    tr = run.trace
    if tr is None or not tr.events or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
