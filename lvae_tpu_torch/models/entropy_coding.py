"""Probability side of the entropy coder, counterpart of
``lvae_tpu/models/entropy_coding.py``: the log probability masses of the
rate term, the eval-time discretized likelihood, scale-index lookup and the
quantized CDF table of the discretized Gaussian with its host coder (the
native per-block rANS of ops/crans.py, coder='host').

Probability-mass math runs in float32 whatever its inputs' dtype: CDF
differences underflow in lower precision.
"""
import math

import numpy as np
import torch

from lvae_tpu_torch.ops import cdf as cdf_ops
from lvae_tpu_torch.ops import crans


_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))


def _normal_log_pdf(x, mean, scale):
    z = (x - mean) / scale
    return -0.5 * (z * z) - torch.log(scale) - 0.5 * math.log(2 * math.pi)


def _laplace_cdf(x):
    return torch.where(x < 0, 0.5 * torch.exp(x), 1.0 - 0.5 * torch.exp(-x))


def _laplace_log_pdf(x, mean, scale):
    return -torch.abs(x - mean) / scale - torch.log(2.0 * scale)


def _f32(*xs):
    return [torch.as_tensor(x).to(torch.float32) for x in xs]


def _safe_log_prob_mass(cdf_fn, log_pdf_fn, mean, scale, x, bin_size,
                        prob_clamp):
    """log P where P = cdf(x+b/2) - cdf(x-b/2), with a log-pdf*bin fallback
    below prob_clamp for numerical stability."""
    upper = cdf_fn((x + 0.5 * bin_size - mean) / scale)
    lower = cdf_fn((x - 0.5 * bin_size - mean) / scale)
    prob_mass = upper - lower
    return torch.where(prob_mass > prob_clamp,
                       torch.log(torch.clamp(prob_mass, min=1e-8)),
                       log_pdf_fn(x, mean, scale) + math.log(bin_size))


def gaussian_log_prob_mass(mean, scale, x, bin_size=1.0, prob_clamp=1e-6):
    """log P of a quantized Normal(mean, scale) evaluated at x (float32)."""
    mean, scale, x = _f32(mean, scale, x)
    return _safe_log_prob_mass(_normal_cdf, _normal_log_pdf, mean, scale, x,
                               bin_size, prob_clamp)


def laplace_log_prob_mass(mean, scale, x, bin_size=1.0, prob_clamp=1e-6):
    """log P of a quantized Laplace(mean, scale) evaluated at x (float32)."""
    mean, scale, x = _f32(mean, scale, x)
    return _safe_log_prob_mass(_laplace_cdf, _laplace_log_pdf, mean, scale,
                               x, bin_size, prob_clamp)


def quantize_dequantize(x, means):
    """Residual round-to-integer quantization: round(x - means) + means."""
    return torch.round(x - means) + means


def discrete_likelihood(x, scales, means, scale_bound,
                        likelihood_bound=1e-9):
    """P(round residual) under the eval-time discretized Gaussian: scales
    lower-bounded by scale_bound, the likelihood by likelihood_bound
    (float32)."""
    x, scales, means = _f32(x, scales, means)
    scales = torch.clamp(scales, min=scale_bound)
    v = torch.abs(x - means)
    upper = _normal_cdf((0.5 - v) / scales)
    lower = _normal_cdf((-0.5 - v) / scales)
    return torch.clamp(upper - lower, min=likelihood_bound)


def _draw_device(like, generator):
    """Where a draw happens: on the generator's device when one is given
    (a CPU generator gives the same numbers to a CPU and a card run), else
    on `like`'s."""
    return like.device if generator is None else generator.device


class RowGenerator:
    """A torch.Generator whose draws are made at the global shape, of which
    this rank keeps its block: of the leading (batch) dimension the part
    `batch` = (index, count), and of an NCHW draw's H the part `height` =
    (index, count). A rank of a sharded step (parallel/spatial.sharded) so
    draws the rows one process would for the whole batch and image: the
    JAX package draws the global noise and keeps each device's shard. At
    (0, 1), (0, 1) the draw is the plain one, bitwise."""

    def __init__(self, generator, batch=(0, 1), height=(0, 1)):
        self.generator, self.batch, self.height = generator, batch, height

    @property
    def device(self):
        return self.generator.device

    def draw(self, fn, shape, dtype=None, device=None):
        (bi, bn), (hi, hn) = self.batch, self.height
        full = list(shape)
        full[0] *= bn
        if len(shape) == 4:
            full[2] *= hn
        x = fn(full, generator=self.generator, dtype=dtype, device=device)
        x = x[bi * shape[0]:(bi + 1) * shape[0]]
        if len(shape) == 4:
            x = x[:, :, hi * shape[2]:(hi + 1) * shape[2]]
        return x


def draw(fn, shape, generator=None, dtype=None, device=None):
    """fn(shape, generator=, dtype=, device=), torch.rand or torch.randn:
    this rank's block of a RowGenerator's global draw, or the plain draw."""
    if isinstance(generator, RowGenerator):
        return generator.draw(fn, shape, dtype, device)
    return fn(shape, generator=generator, dtype=dtype, device=device)


def uniform_noise(like, generator=None):
    """U(-0.5, 0.5) noise of `like`'s shape and dtype on `like`'s device:
    the training branch's stand-in for rounding, and the sampling blocks'
    dequantization noise. Drawn on `generator`'s device (_draw_device)."""
    u = draw(torch.rand, like.shape, generator, like.dtype,
             _draw_device(like, generator))
    return u.to(like.device) - 0.5


def normal_noise(like, generator=None):
    """Standard normal noise of `like`'s shape and dtype on `like`'s device:
    the RD model's reparameterised latents and the sampling blocks' prior
    draws. Drawn on `generator`'s device (_draw_device)."""
    return draw(torch.randn, like.shape, generator, like.dtype,
                _draw_device(like, generator)).to(like.device)


def build_indexes(scales, scale_table):
    """Per-element scale-table index (int32): the smallest index whose table
    entry is >= scale, as the count of f32 table entries strictly below the
    scale, capped at the last entry. A sum of broadcast compares, exactly as
    the JAX package computes it. scale_table: numpy, or a float32 tensor
    (on the scales' device, it is used without a copy)."""
    st = torch.as_tensor(scale_table, dtype=torch.float32,
                         device=scales.device)
    scales = torch.maximum(scales.to(torch.float32), st[0])
    idx = (st < scales[..., None]).sum(-1, dtype=torch.int32)
    return torch.clamp(idx, max=st.shape[0] - 1)


class DiscretizedGaussian:
    """Discretized Gaussian with the default 64-entry log-spaced scale table
    (0.11 -> 20); `update()` builds its quantized CDF table and the native
    per-block coder over it (lvae_tpu/models/entropy_coding.py:127-183)."""

    def __init__(self, scale_table=None, tail_mass=1e-9):
        if scale_table is None:
            scale_table = cdf_ops.default_gaussian_scale_table()
        self.scale_table = np.asarray(scale_table, dtype=np.float64)
        self.tail_mass = float(tail_mass)
        self.cdf_table = None
        self._codec = None

    def update(self):
        if self.cdf_table is None:
            self.cdf_table = cdf_ops.build_cdf_table(self.scale_table,
                                                     self.tail_mass)
        if self._codec is None:
            self._codec = crans.RansCodec(self.cdf_table)
        return self.cdf_table

    def compress_symbols(self, symbols, indexes) -> bytes:
        """rANS-encode int32 symbols (round(x - mean)) against the rows
        `indexes`: one block's string in the host coder's layout."""
        if self._codec is None:
            raise RuntimeError('call update() / compress_mode() first')
        return self._codec.encode_with_indexes(
            np.asarray(symbols, np.int32), np.asarray(indexes, np.int32))

    def decompress_symbols(self, string: bytes, indexes) -> np.ndarray:
        """Inverse of compress_symbols: the block's int32 symbols, flat."""
        if self._codec is None:
            raise RuntimeError('call update() / compress_mode() first')
        return self._codec.decode_with_indexes(
            string, np.asarray(indexes, np.int32))
