"""Deterministic quantized-CDF tables for the Gaussian entropy model.

A copy of the parts of ``lvae_tpu/ops/cdf.py`` that the codec needs, kept
here so that the port imports nothing of the JAX package. Bitstreams depend
on these tables, so everything is pure integer/float64 numpy and must stay
byte-identical to the reference tables (tests/test_torch_rans.py).

A `CdfTable` holds, per scale-table entry:
  * cdf[s]        : uint32 quantized CDF row, cdf[s][0] = 0, row max = 2^16
  * cdf_length[s] : number of valid CDF entries in the row (= pmf_len + 2;
                    the final pmf bin is the escape/bypass symbol)
  * offset[s]     : integer value represented by symbol index 0
"""
import math
from dataclasses import dataclass

import numpy as np

PRECISION = 16  # CDF precision in bits; total mass per row = 2**16

_SQRT2 = math.sqrt(2.0)


def std_normal_cdf(x):
    x = np.asarray(x, dtype=np.float64)
    return 0.5 * (1.0 + np.vectorize(math.erf, otypes=[np.float64])(x / _SQRT2))


def std_normal_ppf(q):
    """Inverse standard normal CDF (Acklam's rational approximation refined
    with one Halley step — ~1e-15 accurate, deterministic)."""
    q = float(q)
    assert 0.0 < q < 1.0
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        ql = math.sqrt(-2 * math.log(q))
        x = (((((c[0]*ql+c[1])*ql+c[2])*ql+c[3])*ql+c[4])*ql+c[5]) / \
            ((((d[0]*ql+d[1])*ql+d[2])*ql+d[3])*ql+1)
    elif q <= phigh:
        ql = q - 0.5
        r = ql * ql
        x = (((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*ql / \
            (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1)
    else:
        ql = math.sqrt(-2 * math.log(1 - q))
        x = -(((((c[0]*ql+c[1])*ql+c[2])*ql+c[3])*ql+c[4])*ql+c[5]) / \
            ((((d[0]*ql+d[1])*ql+d[2])*ql+d[3])*ql+1)
    e = std_normal_cdf(np.array([x]))[0] - q
    u = e * math.sqrt(2 * math.pi) * math.exp(x * x / 2)
    return x - u / (1 + x * u / 2)


def default_gaussian_scale_table(n=64, lo=0.11, hi=20.0):
    return np.exp(np.linspace(math.log(lo), math.log(hi), n))


def qres_latent_scale_table(n=64, lo=0.1, hi=20.0):
    """The QRes-VAE latent blocks' table: min scale 0.1, not the default
    0.11 (lvae_tpu/ops/cdf.py:100)."""
    return np.exp(np.linspace(math.log(lo), math.log(hi), n))


def lossless_head_scale_table(lo=0.11, hi=20.0, n=128):
    """The 128-entry table of the lossless pixel head, in bin units
    (lvae_tpu/ops/cdf.py:105)."""
    return np.exp(np.linspace(math.log(lo), math.log(hi), n))


def pmf_to_quantized_cdf(pmf, precision=PRECISION):
    """Quantize a PMF into an integer CDF with total 2**precision.

    Every bin is guaranteed a frequency >= 1 (deficits are taken from the
    largest bins, deterministically). Input `pmf` already includes the
    escape/tail bin as its final entry.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    assert pmf.ndim == 1 and pmf.size >= 1
    total_mass = 1 << precision
    p = np.maximum(pmf, 0.0)
    s = p.sum()
    if s <= 0:
        freqs = np.full(pmf.size, total_mass // pmf.size, dtype=np.int64)
        freqs[: total_mass - freqs.sum()] += 1
    else:
        freqs = np.round(p * (total_mass / s)).astype(np.int64)
        freqs = np.maximum(freqs, 1)
        diff = int(freqs.sum()) - total_mass
        # remove excess from (or add deficit to) the largest bins first
        while diff != 0:
            order = np.argsort(-freqs, kind='stable')
            step = -1 if diff > 0 else 1
            for i in order:
                if diff == 0:
                    break
                if step == -1 and freqs[i] <= 1:
                    continue
                freqs[i] += step
                diff += step
    cdf = np.zeros(pmf.size + 1, dtype=np.uint32)
    cdf[1:] = np.cumsum(freqs, dtype=np.int64)
    assert cdf[-1] == total_mass
    return cdf


@dataclass
class CdfTable:
    scale_table: np.ndarray   # (S,) float64, sorted ascending
    cdfs: np.ndarray          # (S, max_len) uint32, zero padded
    cdf_lengths: np.ndarray   # (S,) int32, valid entries per row
    offsets: np.ndarray       # (S,) int32

    @property
    def num_scales(self):
        return int(self.scale_table.shape[0])

    @property
    def max_cdf_length(self):
        return int(self.cdfs.shape[1])


def build_cdf_table(scale_table, tail_mass=1e-9) -> CdfTable:
    """Quantized CDF table of the discretized Gaussian family: per scale,
    symbols cover [-c, c] with c = ceil(scale * multiplier), multiplier =
    -ppf(tail_mass/2); the remaining tail mass goes to a final escape bin."""
    scale_table = np.asarray(scale_table, dtype=np.float64)
    assert scale_table.ndim == 1 and scale_table.size >= 1
    assert np.all(np.diff(scale_table) > 0), 'scale table must be sorted ascending'
    assert scale_table[0] > 0

    multiplier = -std_normal_ppf(tail_mass / 2)
    centers = np.ceil(scale_table * multiplier).astype(np.int64)
    max_len = int((2 * centers + 1).max()) + 2  # +1 escape bin, +1 leading 0

    S = scale_table.size
    cdfs = np.zeros((S, max_len), dtype=np.uint32)
    cdf_lengths = np.zeros(S, dtype=np.int32)
    for i in range(S):
        c = int(centers[i])
        x = np.arange(-c, c + 1, dtype=np.float64)
        pmf = (std_normal_cdf((x + 0.5) / scale_table[i])
               - std_normal_cdf((x - 0.5) / scale_table[i]))
        tail = max(1.0 - pmf.sum(), 0.0)
        row = pmf_to_quantized_cdf(np.concatenate([pmf, [tail]]))
        cdfs[i, :row.size] = row
        cdf_lengths[i] = row.size
    return CdfTable(scale_table=scale_table, cdfs=cdfs,
                    cdf_lengths=cdf_lengths,
                    offsets=(-centers).astype(np.int32))


def build_indexes_np(scales, scale_table):
    """Per-element scale-table index on the host: the smallest index whose
    float64 table entry is >= the scale, capped at the last entry
    (lvae_tpu/ops/cdf.py:217; the host coder's lossless head uses it)."""
    scales = np.maximum(np.asarray(scales, dtype=np.float64), scale_table[0])
    idx = np.searchsorted(scale_table, scales, side='left')
    return np.minimum(idx, len(scale_table) - 1).astype(np.int32)
