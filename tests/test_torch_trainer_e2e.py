"""The port's trainer end to end on the CPU through its two CLIs
(lvae_tpu_torch.train_fix_rate at qres_tiny, train_var_rate at qarv_tiny),
in the pattern of tests/test_trainer_e2e.py: main() writes the run
directory (config.json, model.txt, optimizer.json, results.txt,
train_log.jsonl, last / best / last_ema; best_ema where the EMA's loss is
the best yet), a --resume carries on
the step, the Adam moments and the EMA, and with --fixseed the resumed run
equals the uninterrupted one bitwise (any worker count). Also --amp
--remat --device_data, --weights and --load_optim, the weights file that
load_weights reads, and the abort after 20 skipped steps (a non-finite
grad norm counts, as a non-finite loss does) with its failed dump."""
import json

import numpy as np
import pytest
import torch

from lvae_tpu_torch import get_model, train_fix_rate, train_var_rate
from lvae_tpu_torch.training import checkpoint as ckpt
from lvae_tpu_torch.utils import coding

RUN_FILES = ('config.json', 'model.txt', 'optimizer.json', 'results.txt',
             'train_log.jsonl', 'last', 'best', 'last_ema')


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
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp('imgs')
    rng = np.random.default_rng(0)
    for i in range(4):
        coding.write_png(d / f'{i}.png', (rng.uniform(0, 1, (80, 80, 3))
                                          * 255).astype(np.uint8))
    return str(d)


def _fix_argv(dataset, name, iterations, *extra):
    return ['--model', 'qres_tiny', '--model_args', 'lmb=64',
            '--trainset', dataset, '--valset', dataset,
            '--transform', 'crop=64,hflip=True', '--batch_size', '2',
            '--workers', '1', '--iterations', str(iterations),
            '--lr', '1e-3', '--lr_warmup', '0', '--val_interval', '4',
            '--name', name, *extra]


def _var_argv(dataset, name, iterations, *extra):
    return ['--model', 'qarv_tiny', '--trainset', dataset,
            '--valset', dataset, '--transform', 'crop=64,hflip=True',
            '--batch_size', '2', '--workers', '2', '--val_steps', '2',
            '--iterations', str(iterations), '--lr', '1e-3',
            '--lr_sched', 'constant', '--val_interval', '4', '--name', name,
            *extra]


def _same_state(a, b):
    sa, sb = a.state, b.state
    assert (sa.step, sa.count) == (sb.step, sb.count)
    for x, y in ((sa.flat, sb.flat), (sa.ema, sb.ema),
                 (sa.moments['mu'], sb.moments['mu']),
                 (sa.moments['nu'], sb.moments['nu'])):
        assert torch.equal(x, y)


@pytest.mark.parametrize('cli,argv', [(train_fix_rate, _fix_argv),
                                      (train_var_rate, _var_argv)],
                         ids=['fix_rate', 'var_rate'])
def test_main_resume_and_determinism(dataset, tmp_path, monkeypatch, cli,
                                     argv):
    monkeypatch.chdir(tmp_path)                 # the trainer writes ./runs
    first = cli.main(argv(dataset, 'a', 8), device='cpu')
    run_dir = first._log_dir
    for f in RUN_FILES:
        assert (run_dir / f).is_file(), f
    assert json.loads((run_dir / 'config.json').read_text())['iterations'] \
        == 8
    groups = json.loads((run_dir / 'optimizer.json').read_text())
    assert groups['weights'] and groups['bias'] and groups['other']
    assert [h['step'] for h in first.history] == list(range(8))
    assert all(np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])
               for h in first.history)
    saved = ckpt.load_checkpoint(run_dir / 'last')
    assert saved['iter'] == 8 and saved['state']['step'] == 8
    assert len(saved['grad_norms']) == 8
    assert first._results and first.state.step == 8

    resumed = cli.main(argv(dataset, 'a', 12, '--resume', 'a'),
                       device='cpu')
    assert [h['step'] for h in resumed.history] == list(range(8, 12))
    assert resumed.state.step == 12 and resumed.state.count == 12
    assert float(resumed.state.moments['nu'].abs().max()) > 0

    straight = cli.main(argv(dataset, 'b', 12, '--workers', '3'),
                        device='cpu')
    _same_state(resumed, straight)
    assert [h['loss'] for h in straight.history[8:]] == \
        [h['loss'] for h in resumed.history]


def test_amp_remat_device_data(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    runs = {}
    for name, extra in (('dev', ['--device_data']),
                        ('amp', ['--amp', '--remat', '--device_data'])):
        runs[name] = train_var_rate.main(
            _var_argv(dataset, name, 3, '--val_interval', '0', *extra),
            device='cpu')
        assert all(np.isfinite(h['loss']) for h in runs[name].history)
        assert runs[name]._step_flops > 0
    host = train_var_rate.main(_var_argv(dataset, 'host', 3, '--val_interval',
                                         '0'), device='cpu')
    # the device cache feeds the batches the threaded loader feeds
    _same_state(runs['dev'], host)
    assert runs['amp'].compute_dtype == 'bfloat16'
    assert all(p.dtype == torch.float32
               for p in runs['amp'].model.net.parameters())
    assert not torch.equal(runs['amp'].state.flat, host.state.flat)


def test_weights_load_optim_and_weights_file(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = train_fix_rate.main(_fix_argv(dataset, 'w', 4), device='cpu')
    last = str(first._log_dir / 'last')
    warm = train_fix_rate.main(
        _fix_argv(dataset, 'warm', 1, '--weights', last, '--load_optim',
                  '--val_interval', '0'), device='cpu')
    assert warm.state.step == 1 and warm.state.count == first.state.count + 1
    plain = train_fix_rate.main(
        _fix_argv(dataset, 'plain', 1, '--weights', last,
                  '--val_interval', '0'), device='cpu')
    assert plain.state.count == 1
    # load_weights reads a training checkpoint's parameters and a weights
    # file alike
    path = tmp_path / 'qres_tiny_weights.pt'
    ckpt.save_weights(path, first.model.net)
    m = get_model('qres_tiny', device='cpu', lmb=64)
    m.load_weights(path)
    assert all(torch.equal(a, b) for a, b in zip(
        m.net.state_dict().values(), first.model.net.state_dict().values()))
    m2 = get_model('qres_tiny', device='cpu', lmb=64)
    m2.load_weights(last)
    assert all(torch.equal(a, b) for a, b in zip(
        m2.net.parameters(), first.model.net.parameters()))


def test_nonfinite_streak_aborts_with_failed_dump(dataset, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    from lvae_tpu_torch.models.qresvae.model import QresModel
    real = QresModel.loss_and_stats

    def poisoned(self, im, **kw):
        # the loss stat stays finite, the gradients are NaN: the streak
        # counts a non-finite grad norm too (the JAX trainer counts the
        # loss alone, ADVICE r5)
        loss, stats = real(self, im, **kw)
        return loss * float('nan'), stats
    monkeypatch.setattr(QresModel, 'loss_and_stats', poisoned)
    with pytest.raises(SystemExit, match='non-finite'):
        train_fix_rate.main(_fix_argv(dataset, 'nan', 40, '--val_interval',
                                      '0'), device='cpu')
    run_dir = tmp_path / 'runs' / 'qres' / 'nan'
    failed = ckpt.load_checkpoint(run_dir / 'failed')['state']
    with torch.random.fork_rng():
        torch.manual_seed(0)
        start = get_model('qres_tiny', device='cpu', lmb=64)
    # every step was skipped: the parameters are the initial ones, bitwise
    for name, p in start.net.named_parameters():
        assert torch.equal(failed['params'][name], p.detach()), name
    assert failed['step'] in (20, 21)
