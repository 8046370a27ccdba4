"""The port's trainer data parallel on the CPU: train_fix_rate.main at two
gloo ranks (qres_tiny, 64x64 crops, batch 2 a rank, --fixseed), launched
as torchrun launches them (tests/torch_ranks.py), in one launch:

  * a 4-step run: the ranks' final states (parameters, EMA, moments,
    counts) are bitwise equal, and rank 1 writes nothing (every write
    under runs/ raises on it, so the run would fail);
  * a 2-step run resumed to step 4 at two ranks equals the 4-step run
    bitwise;
  * a non-finite streak that rank 1 alone causes (its loss times NaN: the
    averaged gradient is NaN on both) stops both ranks on the same step,
    with one failed dump, written by rank 0, holding the initial
    parameters.
"""
import json

import numpy as np
import pytest
import torch

from lvae_tpu_torch import get_model
from lvae_tpu_torch.training import checkpoint as ckpt
from lvae_tpu_torch.utils import coding

import torch_ranks

_RANK = r'''
import builtins, hashlib, json, os, sys
import torch
torch.set_num_threads(1)
from lvae_tpu_torch import train_fix_rate
from lvae_tpu_torch.models.qresvae.model import QresModel
from lvae_tpu_torch.parallel import mesh as pmesh

data, work = sys.argv[1], sys.argv[2]
os.chdir(work)
rank = int(os.environ['RANK'])
pmesh.init_distributed(backend='gloo', device='cpu')
runs = os.path.join(work, 'runs')

if rank:
    # rank 1 must write nothing under runs/
    def guard(fn, is_write):
        def g(path, *a, **kw):
            if is_write(a, kw) and os.path.abspath(str(path)).startswith(
                    runs):
                raise PermissionError(f'rank {rank} wrote {path}')
            return fn(path, *a, **kw)
        return g
    writes = lambda a, kw: any(c in (a[0] if a else kw.get('mode', 'r'))
                               for c in 'wax+')
    builtins.open = guard(builtins.open, writes)
    for name in ('mkdir', 'makedirs', 'link'):
        setattr(os, name, guard(getattr(os, name), lambda a, kw: True))
    os.replace = guard(os.replace, lambda a, kw: True)


def argv(name, iterations, *extra):
    return ['--model', 'qres_tiny', '--model_args', 'lmb=64',
            '--trainset', data, '--valset', data,
            '--transform', 'crop=64,hflip=True', '--batch_size', '2',
            '--workers', '1', '--iterations', str(iterations),
            '--lr', '1e-3', '--lr_warmup', '0', '--val_interval', '2',
            '--device', 'cpu', '--name', name, *extra]


def digest(t):
    st = t.state
    h = hashlib.sha256(repr((st.step, st.count)).encode())
    for buf in st.flat_buffers().values():
        h.update(buf.numpy().tobytes())
    return dict(state=h.hexdigest(), history=t.history)


out = {}
out['straight'] = digest(train_fix_rate.main(argv('b', 4)))
train_fix_rate.main(argv('a', 2))
out['resumed'] = digest(train_fix_rate.main(argv('a', 4, '--resume', 'a')))

real = QresModel.loss_and_stats
if rank:
    def poisoned(self, im, **kw):
        loss, stats = real(self, im, **kw)
        return loss * float('nan'), stats
    QresModel.loss_and_stats = poisoned
steps = []
trainer = train_fix_rate.BaseTrainingWrapper
orig = trainer.clean_and_exit
def clean_and_exit(self):
    steps.append(len(self.history))
    orig(self)
trainer.clean_and_exit = clean_and_exit
try:
    train_fix_rate.main(argv('nan', 40, '--val_interval', '0'))
except SystemExit as e:
    out['abort'] = dict(message=str(e), steps=steps)
print('RESULT ' + json.dumps(out), flush=True)
'''


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    data = tmp_path_factory.mktemp('imgs')
    rng = np.random.default_rng(0)
    for i in range(8):
        coding.write_png(data / f'{i}.png', (rng.uniform(0, 1, (80, 80, 3))
                                             * 255).astype(np.uint8))
    work = tmp_path_factory.mktemp('work')
    script = work / 'rank.py'
    script.write_text(_RANK)
    outs = torch_ranks.launch(script, 2, args=(data, work), timeout=200)
    results = []
    for out in outs:
        line = next(l for l in out.splitlines() if l.startswith('RESULT '))
        results.append(json.loads(line[len('RESULT '):]))
    return work / 'runs' / 'qres', results


@pytest.mark.timeout(240)
def test_ranks_equal_and_only_rank0_writes(two_ranks):
    run_dir, (r0, r1) = two_ranks
    assert r0['straight']['state'] == r1['straight']['state']
    # the averaged stats: the same loss and grad norm on both ranks
    def numbers(r):
        return [(h['step'], h['loss'], h['grad_norm'])
                for h in r['straight']['history']]
    assert numbers(r0) == numbers(r1)
    assert [h['step'] for h in r0['straight']['history']] == [0, 1, 2, 3]
    files = {p.name for p in (run_dir / 'b').iterdir()}
    assert {'config.json', 'model.txt', 'optimizer.json', 'results.txt',
            'last', 'best', 'last_ema'} <= files
    saved = ckpt.load_checkpoint(run_dir / 'b' / 'last')
    assert saved['state']['step'] == 4 and saved['iter'] == 4


@pytest.mark.timeout(240)
def test_two_rank_resume_is_bitwise(two_ranks):
    _, results = two_ranks
    for r in results:
        assert r['resumed']['state'] == r['straight']['state']
        assert [h['loss'] for h in r['resumed']['history']] == \
            [h['loss'] for h in r['straight']['history'][2:]]


@pytest.mark.timeout(240)
def test_nonfinite_streak_stops_both_ranks(two_ranks):
    run_dir, (r0, r1) = two_ranks
    for r in (r0, r1):
        assert 'non-finite' in r['abort']['message']
    assert r0['abort']['steps'] == r1['abort']['steps']
    assert r0['abort']['steps'][0] in (20, 21)
    files = {p.name for p in (run_dir / 'nan').iterdir()}
    assert 'failed' in files
    failed = ckpt.load_checkpoint(run_dir / 'nan' / 'failed')['state']
    with torch.random.fork_rng():
        torch.manual_seed(0)
        start = get_model('qres_tiny', device='cpu', lmb=64)
    # every step was skipped on both ranks: the initial parameters, bitwise
    for name, p in start.net.named_parameters():
        assert torch.equal(failed['params'][name], p.detach()), name
