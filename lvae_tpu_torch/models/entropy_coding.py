"""Probability side of the entropy coder, counterpart of
``lvae_tpu/models/entropy_coding.py``: scale-index lookup and the quantized
CDF table of the discretized Gaussian. The host C++ coder of the JAX package
is not needed here: the codec codes on the card."""
import numpy as np
import torch

from lvae_tpu_torch.ops import cdf as cdf_ops


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
    (0.11 -> 20); `update()` builds its quantized CDF table."""

    def __init__(self, scale_table=None, tail_mass=1e-9):
        if scale_table is None:
            scale_table = cdf_ops.default_gaussian_scale_table()
        self.scale_table = np.asarray(scale_table, dtype=np.float64)
        self.tail_mass = float(tail_mass)
        self.cdf_table = None

    def update(self):
        if self.cdf_table is None:
            self.cdf_table = cdf_ops.build_cdf_table(self.scale_table,
                                                     self.tail_mass)
        return self.cdf_table
