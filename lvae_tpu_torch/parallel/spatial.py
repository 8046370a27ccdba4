"""Spatial partitioning (SP): image height split over a 'space' axis of
ranks, counterpart of ``lvae_tpu/parallel/spatial.py``.

In the JAX package GSPMD inserts every convolution's halo exchange and
the reductions of the statistics. Here each rank runs the model on its H
slab, and while it runs a TorchFunctionMode (HaloConvs) gives every
convolution the rows it needs from the neighbouring slabs, exchanged by
one all_reduce of the space group (exact: each element of the buffer is
written by one rank, the others add zeros). A convolution whose rows
cannot be exchanged exactly raises; it never runs on the slab alone. The
exchange is an autograd Function whose backward sends the halo's
gradients back to the rows they came from, so a sharded train step
(training/optim.make_train_step with a (data, space) mesh) differentiates
through it. Per-image statistics normalised by the slab's own size are
averaged over the ranks (slabs are equal in size).

Sharding rules (NHWC images): batch over 'data', H over 'space'.
Constraint: H divides by n_space * max_stride, so that every stride's
grid splits evenly and each slab starts on a multiple of every stride.
Remat (per-block checkpointing) is not sharded: its recompute runs
outside the exchange, and torch.utils.checkpoint raises a CheckpointError
in the backward.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from lvae_tpu_torch.models import entropy_coding as ec
from lvae_tpu_torch.models.base import exact_f32, host_stats
from lvae_tpu_torch.parallel.mesh import Mesh, Sharding, process_count

__all__ = ['get_2d_mesh', 'image_sharding', 'spatial_eval', 'sharded',
           'HaloConvs']


def get_2d_mesh(n_data, n_space, ranks=None, axis_names=('data', 'space')):
    """A (data, space) grid over the first n_data * n_space ranks of the
    world (or of `ranks`); the others are outside it."""
    ranks = list(range(process_count()) if ranks is None else ranks)
    need = n_data * n_space
    if len(ranks) < need:
        raise ValueError(f'need {need} ranks for a {n_data}x{n_space} mesh, '
                         f'have {len(ranks)}')
    return Mesh(np.asarray(ranks[:need]).reshape(n_data, n_space),
                axis_names)


def image_sharding(mesh, axis_names=('data', 'space')):
    """NHWC image sharding: batch over 'data', height over 'space'."""
    return Sharding(mesh, axis_names)


def _check_spatial_shape(model, im, n_space):
    s = model.net.max_stride
    H = im.shape[1]
    if H % (n_space * s):
        raise ValueError(f'H={H} must divide by n_space*max_stride='
                         f'{n_space * s} for spatial sharding')


def _halo_index(r, n, h, k, top, bottom):
    """Rows of the exchange buffer (n slots of 2k rows, each rank's first
    and last k rows, then one row of zeros) that make rank r's `top` rows
    above its slab and `bottom` rows below: the global rows outside the
    image read the zero row."""
    out = []
    for g in [*range(r * h - top, r * h),
              *range((r + 1) * h, (r + 1) * h + bottom)]:
        if not 0 <= g < n * h:
            out.append(n * 2 * k)
            continue
        s, row = divmod(g, h)
        if row < k:
            out.append(s * 2 * k + row)
        elif row >= h - k:
            out.append(s * 2 * k + k + row - (h - k))
        else:
            raise AssertionError('a halo row past the exchanged ones')
    return out


class _HaloPad(torch.autograd.Function):
    """NCHW slab (B, C, h, W) -> (B, C, top + h + bottom, W): the slab
    with the rows above and below it from the other slabs of the space
    group (zeros beyond the image)."""

    @staticmethod
    def forward(ctx, x, top, bottom, space):
        group, r, n = space.group, space.index, space.count
        B, C, h, W = x.shape
        k = min(max(top, bottom), h)
        buf = x.new_zeros(B, C, n * 2 * k + 1, W)
        buf[:, :, r * 2 * k:r * 2 * k + k] = x[:, :, :k]
        buf[:, :, r * 2 * k + k:(r + 1) * 2 * k] = x[:, :, h - k:]
        if n > 1:
            dist.all_reduce(buf, group=group)
        idx = space.index_tensor(h, k, top, bottom, x.device)
        halo = buf.index_select(2, idx)
        ctx.geometry = (top, h, k, space)
        ctx.save_for_backward(idx)
        return torch.cat([halo[:, :, :top], x, halo[:, :, top:]], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, h, k, space = ctx.geometry
        idx, = ctx.saved_tensors
        r, n = space.index, space.count
        B, C, _, W = g.shape
        gx = g[:, :, top:top + h].clone()
        buf = g.new_zeros(B, C, n * 2 * k + 1, W)
        buf.index_add_(2, idx, torch.cat([g[:, :, :top], g[:, :, top + h:]],
                                         dim=2))
        if n > 1:
            dist.all_reduce(buf, group=space.group)
        gx[:, :, :k] += buf[:, :, r * 2 * k:r * 2 * k + k]
        gx[:, :, h - k:] += buf[:, :, r * 2 * k + k:(r + 1) * 2 * k]
        return gx, None, None, None


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _no_rule(func, kernel, stride, padding, rest=''):
    return ValueError(
        f'{func}: kernel {kernel}, stride {stride}, padding {padding}{rest} '
        f'has no exact halo rule along H (conv2d: kernel = stride + 2 * '
        f'padding; conv_transpose2d: kernel + output_padding - 2 * padding '
        f'= stride; dilation 1)')


# functions that are not local along H and that no rule below exchanges:
# they raise under HaloConvs
_NOT_LOCAL = {getattr(F, n) for n in (
    'conv1d', 'conv3d', 'conv_transpose1d', 'conv_transpose3d', 'pad',
    'avg_pool2d', 'max_pool2d', 'adaptive_avg_pool2d', 'adaptive_max_pool2d',
    'interpolate', 'unfold', 'fold', 'batch_norm', 'instance_norm',
    'group_norm')} | {torch.convolution}


class HaloConvs(TorchFunctionMode):
    """While active, every F.conv2d and F.conv_transpose2d of this rank's
    slab runs on the slab with its halo (_HaloPad) and no H padding, its W
    padding unchanged; any other convolution, and the functions of
    _NOT_LOCAL, raise. group / index / count: the space group and this
    rank's place in it (group None at count 1: the halo is zeros)."""

    def __init__(self, group, index, count):
        super().__init__()
        self.group, self.index, self.count = group, index, count
        self._indexes = {}

    def index_tensor(self, h, k, top, bottom, device):
        """_halo_index's rows for this rank, as a tensor on `device`."""
        key = (h, k, top, bottom, device)
        if key not in self._indexes:
            self._indexes[key] = torch.tensor(_halo_index(
                self.index, self.count, h, k, top, bottom), device=device)
        return self._indexes[key]

    def pad(self, x, top, bottom):
        if top == bottom == 0:
            return x
        return _HaloPad.apply(x, top, bottom, self)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            return self._conv2d(*args, **kwargs)
        if func is F.conv_transpose2d:
            return self._conv_transpose2d(*args, **kwargs)
        if func in _NOT_LOCAL:
            raise ValueError(f'{getattr(func, "__name__", func)} is not '
                             f'local along H and has no halo rule')
        return func(*args, **kwargs)

    def _conv2d(self, input, weight, bias=None, stride=1, padding=0,
                dilation=1, groups=1):
        kernel = tuple(weight.shape[2:])
        if isinstance(padding, str):
            raise _no_rule('conv2d', kernel, stride, padding)
        (sh, _), (ph, pw), (dh, _) = (_pair(stride), _pair(padding),
                                      _pair(dilation))
        if dh != 1 or kernel[0] != sh + 2 * ph:
            raise _no_rule('conv2d', kernel, stride, padding,
                           f', dilation {dilation}')
        return F.conv2d(self.pad(input, ph, ph), weight, bias, stride,
                        (0, pw), dilation, groups)

    def _conv_transpose2d(self, input, weight, bias=None, stride=1,
                          padding=0, output_padding=0, groups=1,
                          dilation=1):
        kernel = tuple(weight.shape[2:])
        (sh, _), (ph, pw), (oh, ow), (dh, _) = (
            _pair(stride), _pair(padding), _pair(output_padding),
            _pair(dilation))
        if dh != 1 or kernel[0] + oh - 2 * ph != sh:
            raise _no_rule('conv_transpose2d', kernel, stride, padding,
                           f', output_padding {output_padding}, dilation '
                           f'{dilation}')
        # input rows [a - top, a + h + bottom) make the output rows
        # [a * s, (a + h) * s); the unpadded output starts top * s + p
        # rows above the first of them
        top, bottom = (kernel[0] - 1 - ph) // sh, -(-ph // sh)
        y = F.conv_transpose2d(self.pad(input, top, bottom), weight, bias,
                               stride, (0, pw), (0, ow), groups, dilation)
        start = top * sh + ph
        return y[:, :, start:start + input.shape[2] * sh]


@contextlib.contextmanager
def sharded(mesh, generator=None):
    """One rank's part of a forward sharded over `mesh`: its convolutions
    exchange halos over the 'space' axis (where the mesh has one), and it
    yields `generator` as a RowGenerator that draws the global noise and
    keeps this rank's rows over 'data' and 'space' (None stays None)."""
    rows = ec.RowGenerator(
        generator,
        batch=(mesh.axis_index('data'), mesh.axis_size('data')),
        height=(mesh.axis_index('space'), mesh.axis_size('space'))) \
        if generator is not None else None
    if 'space' not in mesh.shape:
        yield rows
        return
    with HaloConvs(mesh.axis_groups.get('space'), mesh.axis_index('space'),
                   mesh.axis_size('space')):
        yield rows


def spatial_eval(model, im, mesh, lmb=None):
    """The forward-eval statistics with the image's height split over the
    mesh's 'space' axis (and its batch over 'data'). Every rank calls it
    with the whole image, (B, H, W, 3) float32 in [0, 1], and the same
    weights (parallel.replicate, or one file); a rank outside the mesh
    returns None, the others the same stats dict as model.forward's
    (loss, bppix, mse, psnr, ...). The RD family's latent noise is
    model.forward's (seed 0), drawn for the whole image."""
    im = np.asarray(im, np.float32)
    if im.ndim == 3:
        im = im[None]
    _check_spatial_shape(model, im, mesh.axis_size('space'))
    if not mesh.includes_me:
        return None
    part = image_sharding(mesh).local(im)
    x = torch.from_numpy(np.ascontiguousarray(part)).to(
        model.device).permute(0, 3, 1, 2).contiguous()
    if lmb is None:
        lmb = getattr(model, 'default_lmb', None)
    kw = {} if lmb is None else {'lmb': model._lmbs(float(lmb), x.shape[0])}
    with torch.no_grad(), exact_f32(), \
            sharded(mesh, model._generator(0)) as generator:
        _, stats = model.loss_and_stats(x, training=False,
                                        generator=generator, **kw)
        keys = list(stats)
        vals = mesh.mean(torch.stack([stats[k].float() for k in keys]))
    return host_stats(dict(zip(keys, vals)))
