"""The port stands alone: it imports, codes (qarv_tiny and qres_tiny, on
the fused, host and device coders, and with the bf16 backbone), evaluates
(a file sweep, the forward-only sweeps, H-sharded eval on a 1x1 grid),
runs rd_tiny's forward, samples from each family and trains with both
CLIs with jax, flax, msgpack and PIL all blocked, and no file of it
imports them or the JAX package (Pillow only inside the reader of non-PNG
images, datasets/image.py:read_rgb)."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('lvae_tpu', 'jax', 'flax', 'msgpack', 'PIL')

_CHILD = r'''
import sys
for name in ('jax', 'flax', 'msgpack', 'PIL'):
    sys.modules[name] = None
import numpy as np
import torch
import lvae_tpu_torch
from lvae_tpu_torch.utils import coding

np.save(sys.argv[1], coding.read_png('images/collie64.png'))
torch.manual_seed(0)
model = lvae_tpu_torch.get_model('qarv_tiny', device='cpu')
model.compress_mode(num_lanes='auto')
model.compress_file('images/collie64.png', sys.argv[2], lmb=512.0)
rec = model.decompress_file(sys.argv[2])
assert rec.shape == (1, 64, 64, 3) and np.isfinite(rec).all()
qres = lvae_tpu_torch.get_model('qres_tiny', device='cpu')
qres.compress_mode(num_lanes=16)
qres.compress_file('images/collie64.png', sys.argv[2] + '.qres')
rec = qres.decompress_file(sys.argv[2] + '.qres')
assert rec.shape == (1, 64, 64, 3) and np.isfinite(rec).all()
# the eval harness: a file sweep, the forward and the CLI's pieces
from lvae_tpu_torch import datasets, eval_fix_rate, eval_var_rate, paths
from lvae_tpu_torch import evaluation
stats = evaluation.imcoding_evaluate(model, sys.argv[3], progress=False)
assert stats['bpp'] > 0 and np.isfinite(stats['psnr'])
stats = evaluation.image_self_evaluate(qres, sys.argv[3], progress=False)
assert np.isfinite(stats['loss']) and 'kodak' in paths.known_datasets
sweep = model.self_evaluate(sys.argv[3], steps=2)
assert abs(sweep['lambda'][0] - 16) < 1e-9 and len(sweep['bpp']) == 2
assert datasets.parse_transform_cfg('lmb=64') == {'lmb': 64}
# the host and device coders (the native coder built by g++) and qres17m
from lvae_tpu_torch.models import staged
from lvae_tpu_torch.ops import crans, rans_interleaved, rans_numpy
im = coding.read_png('images/collie64.png').astype(np.float32)[None] / 255
for coder in ('host', 'device'):
    model.compress_mode(coder=coder)
    s, recon = model.compress_check(im, lmb=512.0)
    assert np.array_equal(model.decompress(s), recon)
    qres.compress_mode(coder=coder)
    obj, recon = qres.compress_check(im)
    assert np.array_equal(qres.decompress(obj), recon)
assert crans.LIBRARY.exists()
assert 'qres17m' in lvae_tpu_torch.registry._all_models
# the RD model's forward and one sample of each family
rd = lvae_tpu_torch.get_model('rd_tiny', device='cpu')
stats = rd.forward(im, lmb=64.0)
assert np.isfinite(stats['bppix']) and np.isfinite(stats['psnr'])
for s in (rd.unconditional_sample(64.0, (1, 1, 1)),
          model.unconditional_sample(512.0, (1, 1, 1)),
          qres.uncond_sample((1, 1, 1))):
    assert s.shape == (1, 64, 64, 3) and np.isfinite(s).all()
assert 'rd_model_base' in lvae_tpu_torch.registry._all_models
from lvae_tpu_torch.models import port
from lvae_tpu_torch.models.rd import evaluate
# training: every module, the bf16 codec and a short run of each CLI
from lvae_tpu_torch import train_fix_rate, train_var_rate, training
from lvae_tpu_torch.datasets import device_cache, image, loader, video
from lvae_tpu_torch.training import checkpoint, optim, schedules, trainer
from lvae_tpu_torch.utils import general
model.compress_mode(num_lanes=16, compute_dtype='bfloat16', portable=True)
s, recon = model.compress_check(im, lmb=512.0)
assert np.array_equal(model.decompress(s), recon)
# the multi-process modules, at world size 1: H-sharded eval on a 1x1 grid
from lvae_tpu_torch import parallel
from lvae_tpu_torch.parallel import dist_utils, mesh, spatial
stats = parallel.spatial_eval(model, im, parallel.get_2d_mesh(1, 1), lmb=512.0)
assert np.isfinite(stats['loss']) and dist_utils.check_model_equivalence(
    model.net)
import os
os.chdir(sys.argv[4])
for cli, name in ((train_fix_rate, 'qres_tiny'), (train_var_rate, 'qarv_tiny')):
    t = cli.main(['--model', name, '--trainset', sys.argv[3], '--valset',
                  sys.argv[3], '--transform', 'crop=64', '--batch_size', '1',
                  '--workers', '1', '--iterations', '2', '--val_steps', '2']
                 [:-2 if cli is train_fix_rate else None], device='cpu')
    assert t.state.step == 2 and (t._log_dir / 'last').is_file()
if not torch.cuda.is_available():
    try:
        lvae_tpu_torch.get_model('qarv_tiny')
    except RuntimeError as e:
        assert 'no CUDA device' in str(e)
    else:
        raise AssertionError('get_model without a card must raise')
for name in ('jax', 'flax', 'msgpack', 'PIL', 'lvae_tpu'):
    assert sys.modules.get(name) is None, name
print('ok')
'''


def test_port_runs_without_jax_flax_msgpack_pil(tmp_path):
    png, bits = tmp_path / 'collie.npy', tmp_path / 'collie.bits'
    dataset = tmp_path / 'set'
    dataset.mkdir()
    shutil.copy(ROOT / 'images/collie64.png', dataset)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', _CHILD, str(png), str(bits),
                          str(dataset), str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('ok')
    want = np.asarray(Image.open(ROOT / 'images/collie64.png').convert('RGB'))
    assert np.array_equal(np.load(png), want)
    assert bits.stat().st_size > 4


# the one import of a forbidden package the port may make: Pillow, inside
# the reader of non-PNG images, when such a file is read
LAZY = {('lvae_tpu_torch/datasets/image.py', 'read_rgb', 'PIL')}


def _imported_modules(path):
    """(module, the function whose body imports it or None) of a file."""
    tree = ast.parse(path.read_text(), str(path))
    owner = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                owner.setdefault(node, fn.name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, owner.get(node)) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, owner.get(node)


def test_no_source_imports_the_reference_or_its_packages():
    files = sorted(p for p in (ROOT / 'lvae_tpu_torch').rglob('*.py')
                   if '_build' not in p.parts)         # build output
    files.append(ROOT / 'chip_smoke.py')
    assert len(files) > 10
    lazy = set()
    for path in files:
        rel = str(path.relative_to(ROOT))
        for mod, fn in _imported_modules(path):
            for bad in FORBIDDEN:
                if (rel, fn, bad) in LAZY:
                    lazy.add((rel, fn, bad))
                    continue
                assert not (mod == bad or mod.startswith(bad + '.')), \
                    f'{rel} imports {mod}'
    assert lazy == LAZY
