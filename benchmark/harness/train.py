"""The training cell: the port's train step (make_train_step over
loss_and_stats, as training/trainer.py builds it) on seeded crops held on
the device.

Set-up builds one step object and drives it through its first three steps
with the window's own call and feed (they warm every shape); the window
takes that same object on. The window closes with a synchronize after the
last step queued before `seconds`; the rate is all of its images over all
of its time.

The check replays every step that the object took (set-up's, the
window's and, when traced, the traced ones) with the plain reference from
the same weights, batches, lambdas, noise and EMA decays: the losses of
the first three steps and of the later ones, each leaf's first gradient as Adam got it (its first moment after one
step over 1 - beta1), and each leaf's change and its EMA's change after
the last step, each leaf's gap taken against the larger of its reference
norm and the median leaf's."""
import math
import time

import numpy as np
import torch

from harness import inputs, system
from harness.outcome import Outcome
from harness.roofline import reference_flops
from harness.trace import Profiler, span

B1, B2, EPS = 0.9, 0.999, 1e-8
FIRST_STEPS = 3


def _ema_decay(tr, step):
    return tr['ema_decay'] * (1 - math.exp(-max(step, 1) / tr['ema_warmup']))


def run(spec, seed, seconds, trace, device, t0):
    from lvae_tpu_torch.models.base import exact_f32
    # the port's trainer runs every step under its exact_f32() (TF32 off,
    # deterministic cuDNN): the configuration's float32
    with exact_f32():
        out, prog, crops, step_seeds = _program(spec, seed, seconds, trace,
                                                device, t0)
    system.free(device)
    t = time.perf_counter()
    ref = reference_steps(spec.config, seed, device, crops, step_seeds,
                          len(prog['losses']), spec.traffic)
    values = compare(prog, ref)
    out.notes.update(gaps=values, steps=len(prog['losses']),
                     check_s=time.perf_counter() - t)
    for name, limit in spec.limits.items():
        out.check(name, values.get(name, float('inf')), limit)
    return out


def _program(spec, seed, seconds, trace, device, t0):
    cfg, tr = spec.config, spec.traffic
    out = Outcome('train')
    B, c = tr['batch'], tr['crop']
    crops = inputs.training_crops(tr, seed, inputs.photos(tr),
                                  tr['batches'], device)
    step_seeds = inputs.rng(seed, 5).integers(0, 2 ** 62,
                                              size=tr['batches'])
    model = system.build_model(cfg, seed, device, codec=False)
    from lvae_tpu_torch.training.optim import TrainState, make_train_step
    state = TrainState(model.net, optimizer='adam', ema=True)

    def loss_fn(batch, generator):
        im = batch.permute(0, 3, 1, 2).float().div(255.0)
        return model.loss_and_stats(im.contiguous(), training=True,
                                    generator=generator)

    train_step = make_train_step(loss_fn, state, grad_clip=tr['grad_clip'],
                                 use_ema=True)
    gen = torch.Generator(device)
    losses = []           # every step's loss, a device tensor (not pulled)

    def one(k):
        j = k % tr['batches']
        gen.manual_seed(int(step_seeds[j]))
        m = train_step(crops[j], gen, tr['lr'], 1e9, _ema_decay(tr, k))
        losses.append(m['loss'])

    start = state.flat.clone()
    one(0)
    first_moment = state.moments['mu'].clone()
    for k in range(1, FIRST_STEPS):
        one(k)
    system.synchronize(device)
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    out.setup_s = time.perf_counter() - t0

    k = FIRST_STEPS
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        t = time.perf_counter()
        one(k)
        out.issue_s.append(time.perf_counter() - t)
        k += 1
    system.synchronize(device)
    out.window_s = time.perf_counter() - t_start
    steps = k - FIRST_STEPS
    if trace:
        # the traced sub-window, after the measured one: one step for the
        # profiler's start-up, then `trace_steps` steps and a synchronize
        prof = Profiler(device)
        prof.start()
        with span('warm'):
            one(k)
            system.synchronize(device)
        for j in range(1, tr['trace_steps'] + 1):
            with span('step'):
                one(k + j)
        with span('sync'):
            system.synchronize(device)
        prof.stop()
        out.trace, out.traced_items = prof.trace, tr['trace_steps']
    out.completed = out.attempted = steps
    if torch.device(device).type == 'cuda':
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    out.end_to_end['train_img_s'] = out.completed * B / out.window_s
    out.end_to_end['setup_s'] = out.setup_s
    out.flops_per_item = reference_flops(cfg['net'], 'train', B, c, c)

    prog = dict(losses=torch.stack(losses).tolist(),
                grad=_leaf_norms(state, first_moment / (1 - B1)),
                change=_leaf_norms(state, state.flat - start),
                ema=_leaf_norms(state, state.ema - start))
    return out, prog, crops, step_seeds


def _leaf_norms(state, flat):
    return {n: float(torch.linalg.vector_norm(v))
            for n, v in state.named(flat).items()}


def reference_steps(cfg, seed, device, batches, seeds, n_steps, tr,
                    tf32=False):
    """The plain reference's first `n_steps` steps: loss, autograd, clip by
    global norm, Adam, the EMA, step k on batch k mod len(batches) with its
    generator seed -> {'losses', 'grad' (first step, clipped, per leaf),
    'change', 'ema' (after the last step, per leaf)}. float32 with TF32
    off unless `tf32` (the control)."""
    system.set_tf32(tf32)
    # deterministic cuDNN: the reference reads the same on every run (with
    # the default algorithms two runs of it part by up to 1.3e-4 in the
    # last steps' losses)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    net = system.reference(cfg, seed, device).requires_grad_(True).train()
    names = [n for n, _ in net.named_parameters()]
    P = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in P]
    mu = [torch.zeros_like(p) for p in P]
    nu = [torch.zeros_like(p) for p in P]
    ema = [p.detach().clone() for p in P]
    gen = torch.Generator(device)
    losses, first = [], None
    for k in range(n_steps):
        t, j = k + 1, k % len(batches)
        gen.manual_seed(int(seeds[j]))
        im = batches[j].permute(0, 3, 1, 2).float().div(255.0).contiguous()
        loss = net.train_loss(im, gen)
        grads = torch.autograd.grad(loss, P)
        losses.append(loss.detach())
        with torch.no_grad():
            gn = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            scale = torch.clamp(tr['grad_clip'] / torch.clamp(gn, min=1e-12),
                                max=1.0)
            g = torch._foreach_mul(grads, scale)
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, g, alpha=1 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, g, g, value=1 - B2)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - B2 ** t))
            torch._foreach_add_(denom, EPS)
            step = torch._foreach_div(torch._foreach_div(mu, 1 - B1 ** t),
                                      denom)
            torch._foreach_mul_(step, tr['lr'])
            torch._foreach_sub_(P, step)
            d = _ema_decay(tr, k)
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, P, alpha=1 - d)
            if first is None:
                first = _norms(names, g)
    with torch.no_grad():
        change = _norms(names, torch._foreach_sub(P, start))
        ema_change = _norms(names, torch._foreach_sub(ema, start))
    system.set_tf32(False)
    torch.backends.cudnn.deterministic = deterministic
    return dict(losses=torch.stack(losses).tolist(), grad=first,
                change=change, ema=ema_change)


def _norms(names, tensors):
    return dict(zip(names, torch.stack(
        torch._foreach_norm(tensors)).tolist()))


def compare(prog, ref):
    """{'loss_gap': the largest relative gap of the first three steps'
    losses, 'window_loss_gap': the median relative gap of the later
    steps' (the window's and the traced ones), 'grad_gap': the worst
    leaf's gap of first-gradient norms, 'change_gap' and 'ema_gap': the
    worst leaf's gap of the norms of its change and of its EMA's change
    after the last step}; a leaf's gap over the larger of its reference
    norm and the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the changes. A program that took another number of steps than
    the reference reads inf.

    The window's losses are held by their median: round-off grows over the
    steps, and on about a third of the seeds a few of the last steps read
    gaps of 4e-4 to 8e-4, the reference against itself 1.3e-4."""
    if len(prog['losses']) != len(ref['losses']):
        return {}
    gaps = [abs(p - r) / abs(r)
            for p, r in zip(prog['losses'], ref['losses'])]
    later = gaps[FIRST_STEPS:]

    def worst(key, names):
        med = float(np.median([ref[key][n] for n in names]))
        gaps = [abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med)
                for n in names]
        return max(gaps) if med > 0 else float('inf')
    names = list(ref['grad'])
    gmed = float(np.median([ref['grad'][n] for n in names]))
    moving = [n for n in names if ref['grad'][n] >= 1e-3 * gmed]
    return dict(loss_gap=max(gaps[:FIRST_STEPS]),
                window_loss_gap=(float(np.median(later)) if later
                                 else float('inf')),
                grad_gap=worst('grad', names),
                change_gap=worst('change', moving),
                ema_gap=worst('ema', moving))
