"""The benchmark's files, found by name: BENCHMARK.json at the root of the
checkout, a configuration's file as BENCHMARK.json names it, a traffic
mix in traffic/<name>.json, a cell's correctness limits in
limits/<cell>.json, a per-layer metric's reader in metrics/<metric>.py and
a layer's kernel names in layers/<layer>/*.json. Adding a configuration,
a mix, a metric or a layer's kernels is adding a file."""
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell of BENCHMARK.json with what it names."""

    def __init__(self, workload, root=ROOT, bench=BENCH):
        self.root, self.bench = Path(root), Path(bench)
        spec = load_json(self.root / 'BENCHMARK.json')
        cells = {w['name']: w for w in spec['workloads']}
        if workload not in cells:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
        self.cell = cells[workload]
        self.name = workload
        cfg = {c['name']: c for c in spec['configs']}[self.cell['config']]
        self.config = load_json(self.root / cfg['file'])
        self.traffic = load_json(self.bench / 'traffic'
                                 / f"{self.cell['traffic']}.json")
        self.limits = load_json(self.bench / 'limits' / f'{workload}.json')
        self.chips = int(self.cell['chips'])

        def here(m):
            return 'workloads' not in m or workload in m['workloads']
        self.end_to_end = [m for m in spec['end_to_end'] if here(m)]
        self.per_layer = [m for m in spec['per_layer'] if here(m)]


def metric_reader(name, bench=BENCH):
    """metrics/<name>.py's read(run) -> a number, or None where the run has
    nothing for it to read."""
    path = Path(bench) / 'metrics' / f'{name}.py'
    mod_spec = importlib.util.spec_from_file_location(
        'metric_' + re.sub(r'\W', '_', name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def layer_patterns(layer, group=None, bench=BENCH):
    """The kernel-name patterns of layers/<layer>/*.json (of the file
    <group>.json alone when given): a kernel belongs to the layer when its
    name has one of the listed names as a whole function name."""
    names = []
    for path in sorted((Path(bench) / 'layers' / layer).glob('*.json')):
        if group is None or path.stem == group:
            names += load_json(path)['kernels']
    return [re.compile(r'(^|[\s:])' + re.escape(n) + r'\s*[<(]')
            for n in names]


def matches(name, patterns):
    return any(p.search(name) for p in patterns)
