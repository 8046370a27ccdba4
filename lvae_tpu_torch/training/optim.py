"""The optimizer state and the train step, with the semantics of
``lvae_tpu/training/optim.py`` (make_train_step, :76-152):

  * three parameter groups (weights / bias / other) by parameter name; L2
    weight decay goes into the gradient of the weights group only
  * the learning rate, the moving grad-norm median and the EMA decay are
    numbers the host passes in each step
  * clip by global norm on the raw accumulated gradients, then the weight
    decay, then the median-spike LR cut (grad_norm over 10x the median:
    0.1x the LR for the step, EMA frozen)
  * gradient accumulation over accum_num steps
  * Adam, Adamax or SGD momentum as optax's scale_by_adam(0.9, 0.999,
    1e-8), scale_by_adamax(0.9, 0.999, 1e-8) and trace(0.9)
  * a non-finite grad norm zeroes the gradients and the effective LR:
    parameters and EMA stay bitwise as they were, and the moments take one
    zero-gradient step

One deviation from the JAX step (ADVICE r5): on a skipped step no weight
decay enters the gradient, so that the moments see zeros alone.

All state lives in flat float32 buffers, one each for the parameters
(the network's parameters become views of it), the moments, the gradient
accumulator and the EMA: the update is a handful of whole-buffer kernels.
The step runs on the device with no host synchronisation: the step count,
the moments' count and the accumulation count are host integers.

Data parallel (and with H sharding, parallel/spatial.py): given a mesh,
each rank runs the loss on its rows (and slab) under parallel.sharded, so
that its noise is its rows of the global draw, then averages each
micro-step's flat gradient and the loss stats over the mesh's ranks (one
all_reduce each) before it accumulates. Every rank then updates from
identical buffers: the clip, skip and spike decisions agree and the ranks'
states stay bitwise equal. On one rank the step is bitwise the one
without a mesh.
"""
import numpy as np
import torch
import torch.nn as nn

from lvae_tpu_torch.parallel.spatial import sharded
from lvae_tpu_torch.utils import trace

__all__ = ['TrainState', 'make_train_step', 'param_group_label']

B1, B2, EPS = 0.9, 0.999, 1e-8
MOMENTS = {'adam': ('mu', 'nu'), 'adamax': ('mu', 'nu'), 'sgd': ('trace',)}


def param_group_label(name, net):
    """weights / bias / other of the parameter `name` of `net`: the JAX
    package's rule (lvae_tpu/training/optim.py:31-39) on the flax name that
    models/weights.py maps onto this one. A torch 'weight' is flax's
    'kernel' (weights), except a LayerNorm's, which is flax's 'scale'
    (other)."""
    owner, _, last = name.rpartition('.')
    if 'bias' in last or last.startswith('bn'):
        return 'bias'
    if last == 'weight' and isinstance(net.get_submodule(owner),
                                       nn.LayerNorm):
        return 'other'
    if 'kernel' in last or 'weight' in last or last == 'embedding':
        return 'weights'
    return 'other'


class TrainState:
    """The train state of a network: its parameters, the optimizer's moments
    and count, the gradient accumulator and its count, the EMA of the
    parameters and the step count. Building it makes the network's
    parameters views of `flat`."""

    def __init__(self, net, optimizer='adam', ema=True):
        if optimizer not in MOMENTS:
            raise ValueError(f'Unknown optimizer: {optimizer}')
        named = list(net.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.numels = [p.numel() for p in self.params]
        with torch.no_grad():
            self.flat = torch.cat([p.reshape(-1) for p in self.params])
            off = 0
            for p, n in zip(self.params, self.numels):
                p.data = self.flat[off:off + n].view_as(p)
                off += n
        labels = [param_group_label(n, net) for n in self.names]
        self.groups = dict(zip(self.names, labels))
        self.weights_mask = torch.cat([
            torch.full((n,), lab == 'weights', device=self.flat.device)
            for n, lab in zip(self.numels, labels)])
        self.optimizer = optimizer
        self.moments = {k: torch.zeros_like(self.flat)
                        for k in MOMENTS[optimizer]}
        self.count = 0
        self.grad_accum = torch.zeros_like(self.flat)
        self.accum_count = 0
        self.ema = self.flat.clone() if ema else None
        self.step = 0

    def flat_buffers(self):
        """{name: flat buffer} of the whole state: parameters, gradient
        accumulator, moments and EMA."""
        out = dict(flat=self.flat, grad_accum=self.grad_accum,
                   **self.moments)
        if self.ema is not None:
            out['ema'] = self.ema
        return out

    def named(self, flat):
        """{parameter name: its view of a flat buffer}."""
        out, off = {}, 0
        for name, p, n in zip(self.names, self.params, self.numels):
            out[name] = flat[off:off + n].view_as(p)
            off += n
        return out

    def state_dict(self):
        """The state as tensors (on the CPU) and numbers, by name."""
        def host(flat):
            return None if flat is None else self.named(flat.cpu())
        return dict(params=host(self.flat),
                    opt=dict(count=self.count, **{
                        k: host(v) for k, v in self.moments.items()}),
                    grad_accum=host(self.grad_accum),
                    accum_count=self.accum_count, ema=host(self.ema),
                    step=self.step)

    @torch.no_grad()
    def load_state_dict(self, sd, counts=True):
        """Restore a state_dict() in place; counts=False keeps this state's
        step and accumulation count (a warm start with --load_optim)."""
        def load(flat, tensors):
            for name, view in self.named(flat).items():
                view.copy_(tensors[name])
        load(self.flat, sd['params'])
        for k, v in self.moments.items():
            load(v, sd['opt'][k])
        self.count = int(sd['opt']['count'])
        load(self.grad_accum, sd['grad_accum'])
        if self.ema is not None:
            load(self.ema, sd['ema'] if sd['ema'] is not None
                 else sd['params'])
        if counts:
            self.accum_count = int(sd['accum_count'])
            self.step = int(sd['step'])


def _f32(x):
    return float(np.float32(x))


def make_train_step(loss_fn, state, accum_num=1, grad_clip=2.0, wdecay=0.0,
                    use_ema=True, mesh=None):
    """The train step over `state`:
    step(batch, generator, lr, grad_median, ema_decay) -> metrics, the
    loss_fn's stats and 'grad_norm' as 0-d device tensors (not pulled).
    loss_fn(batch, generator) -> (loss, stats). With a mesh (parallel/):
    `batch` is this rank's rows (and H slab), `generator` the same on
    every rank, and gradients and stats are averaged over the mesh."""
    params = state.params

    @torch.no_grad()
    def apply_update(lr, grad_median, ema_decay):
        acc, flat = state.grad_accum, state.flat
        gnorm = torch.linalg.vector_norm(acc)
        ok = torch.isfinite(gnorm)
        scale = torch.where(ok, torch.clamp(
            torch.full_like(gnorm, grad_clip) / torch.clamp(gnorm, min=1e-12),
            max=1.0), 0.0)
        g = torch.where(ok, acc, 0.0) * scale
        if wdecay > 0:
            # only on a finite step: a skipped one feeds the moments zeros
            g = torch.where(state.weights_mask & ok, g + wdecay * flat, g)
        spike = gnorm > _f32(_f32(grad_median) * _f32(10.0))
        lr = _f32(lr)
        lr_eff = torch.where(ok, torch.where(spike, _f32(lr * _f32(0.1)),
                                             lr), 0.0)
        state.count += 1
        m = state.moments
        if state.optimizer == 'sgd':
            u = m['trace'].mul_(B1).add_(g)
        else:
            m['mu'].mul_(B1).add_(g * (1 - B1))
            bc1 = _f32(1 - np.float32(B1) ** np.float32(state.count))
            if state.optimizer == 'adam':
                m['nu'].mul_(B2).add_(g.square_().mul_(1 - B2))
                bc2 = _f32(1 - np.float32(B2) ** np.float32(state.count))
                u = (m['mu'] / bc1).div_((m['nu'] / bc2).sqrt_().add_(EPS))
            else:
                torch.maximum(g.abs_().add_(EPS), m['nu'] * B2,
                              out=m['nu'])
                u = (m['mu'] / bc1).div_(m['nu'])
        flat.sub_(u * lr_eff)          # u may be the trace itself
        if use_ema:
            # frozen on a spike or a skipped step: d = 1 leaves it bitwise
            d = torch.where(spike | ~ok, 1.0, _f32(ema_decay))
            state.ema.mul_(d).add_(flat * (1.0 - d))
        acc.zero_()
        return gnorm

    def train_step(batch, generator, lr, grad_median, ema_decay):
        with trace.span('train.step'):
            with trace.span('train.forward'):
                if mesh is None:
                    loss, stats = loss_fn(batch, generator)
                else:
                    with sharded(mesh, generator) as rows:
                        loss, stats = loss_fn(batch, rows)
            with trace.span('train.backward'):
                grads = torch.autograd.grad(loss, params, allow_unused=True,
                                            materialize_grads=True)
                with torch.no_grad():
                    g = torch.cat([x.reshape(-1) for x in grads])
                    if mesh is not None:
                        mesh.mean(g)
                    state.grad_accum.add_(g if accum_num == 1
                                          else g / accum_num)
            state.accum_count += 1
            state.step += 1
            if state.accum_count >= accum_num:
                with trace.span('train.update'):
                    gnorm = apply_update(lr, grad_median, ema_decay)
                state.accum_count = 0
            else:
                gnorm = (torch.linalg.vector_norm(state.grad_accum)
                         * accum_num)
            metrics = {k: v.detach() for k, v in stats.items()}
            if mesh is not None:
                keys = list(metrics)
                vals = mesh.mean(torch.stack([metrics[k].float()
                                              for k in keys]))
                metrics = dict(zip(keys, vals))
            metrics['grad_norm'] = gnorm
            return metrics

    return train_step
