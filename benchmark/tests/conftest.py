"""Tests of the benchmark harness, run on the CPU with the tiny models
(python -m pytest benchmark/tests -p no:cacheprovider); the ones marked
`cuda` need the card and skip elsewhere, deciding inside a fixture."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

QARV_TINY = dict(
    family='qarv', embed_dim=32, lmb_range=[16.0, 2048.0], max_lmb=8192.0,
    sin_period=64, im_shift=-0.45, im_scale=3.67, max_stride=64,
    scale_table=[0.11, 20.0, 64],
    enc=[['down', 3, 16, 4], ['rb', 16, 7, 2], ['down', 16, 16, 4],
         ['rb', 16, 3, 2], ['key', 'enc_s16'], ['down', 16, 16, 4],
         ['rb', 16, 1, 2], ['key', 'enc_s64']],
    dec=[['latent', 16, 4, 'enc_s64', 16, 1, 2, 'base'], ['up', 16, 16, 4],
         ['latent', 16, 4, 'enc_s16', 16, 3, 2, 'small'], ['stop'],
         ['rb', 16, 3, 2], ['up', 16, 16, 4], ['rb', 16, 7, 2],
         ['up', 16, 3, 4]])
QRES_TINY = dict(
    family='qres', im_shift=-0.45, im_scale=3.67, max_stride=64,
    scale_table=[0.1, 20.0, 64],
    enc=[['down', 3, 16, 4], ['cnx', 16, 7], ['cnxdown', 16, 16, 4, 7],
         ['cnx', 16, 3], ['cnxdown', 16, 16, 4, 7], ['cnx', 16, 1]],
    dec=[['qlatent', 16, 4, 1, 1.0], ['up', 16, 16, 4],
         ['qlatent', 16, 4, 3, 1.0], ['up', 16, 16, 4],
         ['qlatent', 16, 4, 7, 1.0], ['up', 16, 3, 4]])

SEEDED = dict(kind='seeded_flax_init', scales={'prior.c4': 1.0, 'prior': 1.0})
CONFIGS = {
    'qarv_tiny': dict(port_model='qarv_tiny', weights=SEEDED, net=QARV_TINY,
                      codec=dict(coder='fused', portable=True,
                                 num_lanes='auto', esc_cap=8192)),
    'qres_tiny': dict(port_model='qres_tiny', weights=SEEDED, net=QRES_TINY,
                      codec=dict(coder='fused', portable=True, num_lanes=16,
                                 esc_cap=1 << 16)),
}
IMAGES = ['images/collie64.png']
TRAFFIC = {
    'dec.tiny': dict(kind='dec', images=IMAGES, height=64, width=64,
                     batch=2, lambdas=[16.0, 2048.0], per_lambda=1,
                     outstanding=2, check_sample=3),
    'dec.tiny-fixed': dict(kind='dec', images=IMAGES, height=64, width=64,
                           batch=2, lambdas=None, per_lambda=2,
                           outstanding=2, check_sample=3),
    'enc.tiny': dict(kind='enc', images=IMAGES, height=64, width=64,
                     batch=2, lambdas=[16.0, 2048.0], per_lambda=1,
                     outstanding=2, check_sample=3),
    'train.tiny': dict(kind='train', images=['images/gun128.png'],
                       height=128, width=128, batch=2, crop=64, batches=6, lr=2e-4, grad_clip=2.0,
                       ema_decay=0.9999, ema_warmup=10000, trace_steps=2),
}
CELLS = {
    'qarv_tiny.dec': ('qarv_tiny', 'dec.tiny'),
    'qres_tiny.dec': ('qres_tiny', 'dec.tiny-fixed'),
    'qarv_tiny.enc': ('qarv_tiny', 'enc.tiny'),
    'qarv_tiny.train': ('qarv_tiny', 'train.tiny'),
}
# limits of the tiny cells: sound CPU runs read 0 or a few 1e-5 (the same
# library calls on both sides); the faults read 1e-2 and more. A tiny
# image's stream is mostly container: sound qarv_tiny streams read 4.4 to
# 22.4 times their ideal bits over (qres_tiny 0.26), eight times as long
# 42 to 186
RATE = 30.0
LIMITS = {'dec': {'differ_gap': 0.05, 'rate_excess': RATE},
          'enc': {'differ_gap': 0.05, 'rate_excess': RATE},
          'train': {'loss_gap': 1e-4, 'window_loss_gap': 1e-4,
                    'grad_gap': 1e-3, 'change_gap': 1e-2, 'ema_gap': 1e-2}}


def _metrics():
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    return spec['per_layer']


def write_bench(tmp):
    """A checkout-like tree of tiny cells under `tmp`: (root, bench)."""
    root, bench = tmp / 'root', tmp / 'root' / 'benchmark'
    for d in ('configs', 'traffic', 'limits'):
        (bench / d).mkdir(parents=True)
    shutil.copytree(BENCH / 'metrics', bench / 'metrics')
    shutil.copytree(BENCH / 'layers', bench / 'layers')
    configs = []
    for name, cfg in CONFIGS.items():
        path = bench / 'configs' / f'{name}.json'
        path.write_text(json.dumps(dict(name=name, **cfg)))
        configs.append(dict(name=name, source='tests', reduced=[], why='t',
                            file=f'benchmark/configs/{name}.json'))
    for name, tr in TRAFFIC.items():
        (bench / 'traffic' / f'{name}.json').write_text(json.dumps(tr))
    cells = []
    for name, (cfg, tr) in CELLS.items():
        cells.append(dict(name=name, config=cfg, traffic=tr, chips=1,
                          why='t'))
        kind = TRAFFIC[tr]['kind']
        (bench / 'limits' / f'{name}.json').write_text(
            json.dumps(LIMITS[kind]))
    e2e = json.loads((ROOT / 'BENCHMARK.json').read_text())['end_to_end']
    per_layer = []
    for m in _metrics():
        m = dict(m)
        kind = m['name'].rsplit('.', 1)[-1]
        m['workloads'] = [c for c in CELLS
                          if TRAFFIC[CELLS[c][1]]['kind'] == kind]
        per_layer.append(m)
    for m in e2e:
        m.pop('workloads', None)
    (root / 'BENCHMARK.json').write_text(json.dumps(dict(
        command=['python3', 'benchmark/run.py'], paths=['benchmark'],
        run_seconds=1, configs=configs, workloads=cells, end_to_end=e2e,
        per_layer=per_layer)))
    return root, bench


@pytest.fixture
def tiny_bench(tmp_path):
    return write_bench(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda:0')


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'cuda: needs a CUDA card (skips without one)')
