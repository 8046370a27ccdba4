"""One run of one cell: parse the arguments, check the card, run the cell's
runner (by its traffic's `kind`), read the per-layer metrics when traced,
refuse to report if JAX or the JAX package was loaded, print the result."""
import argparse
import json
import sys

import torch

from harness import serve, train
from harness.spec import Spec, layer_patterns, metric_reader

RUNNERS = {'dec': serve.run, 'enc': serve.run, 'train': train.run}
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lvae_tpu')


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Top-level names in sys.modules equal, whole, to JAX's or the JAX
    package's (lvae_tpu_torch begins with lvae_tpu and is allowed)."""
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


class LayerView:
    """What a per-layer reader gets: the Outcome's fields, and the layer
    kernel lists of layers/."""

    def __init__(self, outcome, bench):
        self.o, self.bench = outcome, bench

    def __getattr__(self, name):
        return getattr(self.o, name)

    def layer(self, layer, group=None):
        return layer_patterns(layer, group, self.bench)


def device_info(outcome, device, chips):
    cuda = torch.device(device).type == 'cuda'
    info = {'platform': 'gpu' if cuda else 'cpu',
            'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
            'count': chips,
            'memory_peak_bytes': int(outcome.memory_peak_bytes)}
    if outcome.trace is not None:
        info['busy_s'] = outcome.trace.busy_s()
        info['window_s'] = outcome.trace.window_s
    return info


def report(spec, args, device, t0):
    """Run the cell -> (the result line's object, Outcome). The card check
    is the caller's."""
    outcome = RUNNERS[spec.traffic['kind']](spec, args.seed, args.seconds,
                                            bool(args.trace), device, t0)
    metrics = {}
    if args.trace:
        view = LayerView(outcome, spec.bench)
        for m in spec.per_layer:
            value = metric_reader(m['name'], spec.bench)(view)
            if value is not None:
                metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    else:
        for m in spec.end_to_end:
            if m['name'] in outcome.end_to_end:
                metrics[m['name']] = {'value': outcome.end_to_end[m['name']],
                                      'unit': m['unit']}
    result = {'correct': outcome.correct, 'attempted': outcome.attempted,
              'failed': outcome.failed, 'metrics': metrics,
              'device': device_info(outcome, device, spec.chips)}
    if args.trace and outcome.trace is not None:
        result['breakdown'] = outcome.trace.breakdown()
    # the numbers compared, each beside its limit: the last key
    result['checks'] = {k: {'value': v, 'limit': lim}
                        for k, (v, lim) in outcome.checks.items()}
    return result, outcome


def checks_lines(outcome):
    return [f'check {k} {v!r} limit {lim!r}'
            for k, (v, lim) in outcome.checks.items()]


def main(argv, t0):
    args = parse(argv)
    if not torch.cuda.is_available():
        print('no CUDA device: the benchmark measures the card only',
              file=sys.stderr)
        return 2
    spec = Spec(args.workload)
    if torch.cuda.device_count() < spec.chips:
        print(f'{spec.name} needs {spec.chips} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    device = torch.device('cuda:0')
    print(f'card: {torch.cuda.get_device_name(device)}, power limit '
          f'{power_limit()}', file=sys.stderr, flush=True)
    result, outcome = report(spec, args, device, t0)
    bad = forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}; the benchmark '
              f'reports nothing', file=sys.stderr)
        return 3
    for k, v in outcome.notes.items():
        print(f'note {k} {json.dumps(v)}', file=sys.stderr)
    for line in checks_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit():
    """The card's power limit as nvidia-smi reads it (W), or 'unknown'."""
    import subprocess
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'unknown'
