"""The readings that the correctness limits are set from, on the card at a
cell's own size (the benchmark's runs do not run this):

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--program-seeds 11 12 ...] [--seconds 3] [--fault half] [--steps 80]

* the control: the plain reference in the program's place, computed with
  TF32 on (the precision just below the float32 the configurations
  state), judged by the same numbers against the float32 reference; it
  has to read as not correct
* the program: a whole run of the cell (a window of --seconds) on each
  of --program-seeds, its compared numbers; with --fault, of the program
  with that fault planted (the upper readings that the control does not
  give)

One JSON line a reading on standard output."""
import argparse
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import inputs, serve, system, train  # noqa: E402
from harness.main import report  # noqa: E402
from harness.spec import Spec  # noqa: E402


def serving_control(spec, seed, device):
    """The reference with TF32 on as the program's results for the pool's
    first `check_sample` requests -> {'differ_gap': ...} against the
    float32 reference (the control makes images, not streams: no rate)."""
    tr = spec.traffic
    var_u8 = inputs.variants(inputs.photos(tr))
    pool = inputs.request_pool(tr, seed, len(var_u8))[:tr['check_sample']]
    batches = inputs.device_batches(pool, var_u8, device)
    B = tr['batch']
    system.set_tf32(True)
    ref = system.reference(spec.config, seed, device)
    samples = [(q, serve.reference_code(ref, batches[q.index], q.lmb, B)[0],
                None) for q in pool]
    ref = None
    system.free(device)
    gaps = serve.sample_gaps(spec.config, seed, device, samples, batches, B)
    return {'differ_gap': float(gaps['differ'].max()),
            'gaps': serve.gap_summary(gaps)}


def training_control(spec, seed, device, n_steps):
    """The reference's first `n_steps` steps with TF32 on in the program's
    place -> the training numbers against the float32 reference."""
    tr = spec.traffic
    crops = inputs.training_crops(tr, seed, inputs.photos(tr),
                                  tr['batches'], device)
    seeds = inputs.rng(seed, 5).integers(0, 2 ** 62, size=tr['batches'])
    low = train.reference_steps(spec.config, seed, device, crops, seeds,
                                n_steps, tr, tf32=True)
    system.free(device)
    ref = train.reference_steps(spec.config, seed, device, crops, seeds,
                                n_steps, tr)
    return train.compare(low, ref)


FAULTS = ('unchanged', 'half', 'altered', 'ema', 'coarse')


def plant(kind):
    """Plant a fault in the program. In its train step: 'unchanged' (the
    step leaves the state as it was), 'half' (the loss of half the batch,
    its mean over the rest), 'altered' (the update altered where it is
    made), 'ema' (the EMA fed the parameters from before the update). In
    its codec: 'coarse' (scale tables of 16 entries for 64, on the encode
    and the decode side alike: the images as before, longer streams)."""
    if kind == 'coarse':
        from lvae_tpu_torch.ops import cdf
        for name in ('default_gaussian_scale_table',
                     'qres_latent_scale_table'):
            setattr(cdf, name, functools.partial(getattr(cdf, name), 16))
        return
    from lvae_tpu_torch.training import optim
    make = optim.make_train_step

    def faulty(loss_fn, state, **kw):
        if kind == 'half':
            def half(batch, gen):
                return loss_fn(batch[:batch.shape[0] // 2], gen)
            return make(half, state, **kw)
        step = make(loss_fn, state, **kw)

        def wrapped(batch, gen, lr, grad_median, ema_decay):
            before = state.flat.clone()
            ema = state.ema.clone()
            m = step(batch, gen, lr, grad_median, ema_decay)
            with torch.no_grad():
                if kind == 'unchanged':
                    state.flat.copy_(before)
                elif kind == 'ema':
                    state.ema.copy_(ema * ema_decay
                                    + before * (1.0 - ema_decay))
                else:
                    state.flat[:1000] += 0.01
            return m
        return wrapped
    optim.make_train_step = faulty


def control(spec, seed, device, n_steps):
    if spec.traffic['kind'] == 'train':
        return training_control(spec, seed, device, n_steps)
    return serving_control(spec, seed, device)


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--program-seeds', type=int, nargs='*', default=[])
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--steps', type=int, default=80,
                   help="the control's training steps (a 20 s window's)")
    p.add_argument('--fault', choices=FAULTS,
                   help='plant this fault in the program for the '
                        '--program-seeds runs')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    spec = Spec(args.workload)
    device = torch.device('cuda:0')
    for seed in args.seeds:
        t = time.perf_counter()
        out = control(spec, seed, device, args.steps)
        system.free(device)
        print(json.dumps(dict(kind='control', seed=seed, **out,
                              seconds=time.perf_counter() - t)), flush=True)
    if args.fault:
        plant(args.fault)
    for seed in args.program_seeds:
        t = time.perf_counter()
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        result, outcome = report(spec, run, device, t)
        system.free(device)
        print(json.dumps(dict(
            kind=args.fault or 'program', seed=seed,
            correct=result['correct'],
            **{k: v for k, (v, _) in outcome.checks.items()},
            **{k: v['value'] for k, v in result['metrics'].items()},
            **outcome.notes,
            seconds=time.perf_counter() - t)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
