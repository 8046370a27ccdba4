"""Nothing that benchmark/run.py loads imports JAX or the JAX package, and
the reference imports nothing of the program either: top-level module
names compared whole (lvae_tpu_torch begins with lvae_tpu)."""
import ast
import json
import subprocess
import sys

from harness.main import FORBIDDEN, forbidden_modules
from harness.spec import BENCH, ROOT

RUN_A_CELL = '''
import argparse, json, sys, time
sys.path[:0] = [{tests!r}, {bench!r}, {root!r}]
import conftest
from pathlib import Path
from harness.main import report
from harness.spec import Spec
root, bench = conftest.write_bench(Path({tmp!r}))
for cell in conftest.CELLS:
    args = argparse.Namespace(workload=cell, seed=5, seconds=0.2, trace=1)
    report(Spec(cell, root, bench), args, 'cpu', time.perf_counter())
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''


def _top_level(code):
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    names = _top_level(RUN_A_CELL.format(
        tests=str(BENCH / 'tests'), bench=str(BENCH), root=str(ROOT),
        tmp=str(tmp_path)))
    assert 'lvae_tpu_torch' in names and 'harness' in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(
        f'import sys, json; sys.path[:0] = [{str(BENCH)!r}]\n'
        'import reference.nets, reference.weights\n'
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & (set(FORBIDDEN) | {'lvae_tpu_torch', 'harness'})
    for path in (BENCH / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ''] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split('.')[0] not in set(FORBIDDEN) | {
                    'lvae_tpu_torch', 'harness'}, (path, m)


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'lvae_tpu_torch_fake', object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'lvae_tpu.models', object())
    assert forbidden_modules() == ['lvae_tpu']
