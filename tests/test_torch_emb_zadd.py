"""emb_mlp on its thread-block cluster and zadd folded into z_proj_0
(zadd_conv_kxk), on the CPU.

On the card (chip_smoke.py, tests/test_torch_cuda.py) the cluster kernel is
held bitwise against the one-block kernel (trunk.emb_mlp_oneblock) and
zadd_conv_kxk against zadd then conv_kxk_act(act=False). Here, where every
wrapper runs its plain version:
- zadd_conv_kxk's plain version and the port's qres_fuse against the JAX
  Pallas kernels (interpret mode), atol 1e-5, rtol 1e-4 (XLA:CPU and ATen
  sum each tap's products in different orders), with Z of 8-14, ragged
  H x W (also below 3) and escape-sized symbols;
- emb_mlp at B = 1, 6 and 7 against the JAX kernel, the same tolerance;
- a numpy emulation of the cluster kernel's partition (each CTA's slice of
  outputs, its chunks of batch rows, the rows a warp's chains carry, the
  exchange of the first product's slices, warp_dot's lane-strided fmaf
  chains and shuffle tree) with an exact fmaf. Its sums are the kernel's,
  so it can equal the plain version (one BLAS call a product) bitwise only
  where every sum is exact: on weights with one power of two a column it
  must, which checks every index of the partition; on dense weights it is
  held to the tolerance above.
"""
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.ops.pallas import trunk as jtrunk

from lvae_tpu_torch.ops import trunk

ATOL, RTOL = 1e-5, 1e-4
# lambdas over the codec's range [1, 8192], the batch's 776.05 among them
LAMBDAS = np.array([776.0468820533245, 16.0, 512.0, 2048.0, 1.0, 8192.0,
                    37.5], np.float32)
TRUNK_CU = os.path.join(os.path.dirname(trunk.__file__), '..', 'csrc',
                        'trunk.cu')


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _symbols(rng, shape):
    """Mostly small symbols, one in 16 escape-sized (up to 2^16), and the
    first two at +-(2^24 - 1), the largest that convert to float exactly."""
    big = (1 << 24) - 1
    s = rng.integers(-40, 41, shape)
    esc = rng.random(shape) < 1 / 16
    s[esc] = rng.integers(-(1 << 16), (1 << 16) + 1, int(esc.sum()))
    flat = s.reshape(-1)
    flat[:2] = [big, -big][:flat.size]
    return s.astype(np.int32)


# ---- zadd_conv_kxk ----------------------------------------------------------

# (B, H, W, Z, Co, K): qres34m's latent widths Z 8-14 at 3x3, ragged H x W,
# H or W below 3 (every tap of a pixel off the image on a side), and one
# 5x5 case
_CONV_CASES = [(2, 9, 7, 8, 24, 3), (1, 2, 5, 10, 16, 3), (2, 5, 1, 12, 8, 3),
               (1, 1, 1, 14, 24, 3), (1, 4, 6, 14, 12, 3),
               (2, 1, 2, 10, 8, 3), (1, 6, 5, 12, 8, 5)]


@pytest.mark.parametrize('B,H,W,Z,Co,K', _CONV_CASES)
def test_zadd_conv_kxk_plain_matches_jax(B, H, W, Z, Co, K):
    rng = np.random.default_rng(B + 3 * H + 7 * W + 11 * Z + Co)
    syms, pm = _symbols(rng, (B, H, W, Z)), _normal(rng, (B, H, W, Z))
    wk = _normal(rng, (K, K, Z, Co), (K * K * Z) ** -0.5)
    b = _normal(rng, (Co,), 0.1)
    z = jtrunk.zadd(syms.reshape(B, H * W, Z), pm.reshape(B, H * W, Z),
                    interpret=True).reshape(B, H, W, Z)
    want = np.asarray(jtrunk.conv_kxk_act(z, wk, b, act=False,
                                          interpret=True))
    got = trunk.zadd_conv_kxk(*_t(syms, pm, wk, b))
    assert got.shape == want.shape == (B, H, W, Co)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the wrapper's CPU path is the plain version, which is zadd then the
    # conv's plain version, bit for bit
    ts, tp, tw, tb = _t(syms, pm, wk, b)
    assert torch.equal(got, trunk.zadd_conv_kxk_plain(ts, tp, tw, tb))
    assert torch.equal(got, trunk.conv_kxk_act_plain(
        trunk.zadd_plain(ts, tp), tw, tb, False))
    assert np.abs(want).max() > 1e5     # the escape-sized symbols reach it


def test_zadd_conv_kxk_on_cpu_counts_nothing():
    args = _t(*[a for a in (_symbols(np.random.default_rng(0), (1, 3, 4, 8)),
                            np.ones((1, 3, 4, 8), np.float32),
                            np.ones((3, 3, 8, 4), np.float32),
                            np.zeros(4, np.float32))])
    counts = {k.__name__: k.launches for k in trunk.KERNELS}
    trunk.zadd_conv_kxk(*args)
    trunk.emb_mlp_oneblock(*_t(*_emb_args(np.random.default_rng(0), 2, 8,
                                          8)[:6]), 64)
    assert {k.__name__: k.launches for k in trunk.KERNELS} == counts
    assert trunk.zadd_conv_kxk in trunk.KERNELS
    assert trunk.PLAIN[trunk.zadd_conv_kxk] is trunk.zadd_conv_kxk_plain


def test_qres_fuse_runs_z_proj_0_through_zadd_conv_kxk(monkeypatch):
    """The port's qres_fuse on a qres_tiny-sized block at kernel size 3
    against the JAX qres_fuse (zadd, then the 3x3 conv) on the same flax
    weights, with escape-sized symbols on a ragged 5 x 2 grid; z_proj_0
    goes through zadd_conv_kxk, and neither zadd nor conv_kxk_act runs."""
    import jax
    from lvae_tpu.models.qresvae import model as jqres
    from lvae_tpu_torch.models.qresvae import model as tqres
    from lvae_tpu_torch.models.weights import params_from_flax
    rng = np.random.default_rng(41)
    C, Z, K, H, W = 16, 4, 3, 5, 2
    x = _normal(rng, (1, H, W, C), 2.0)
    jb = jqres.QLatentBlock(C, Z, kernel_size=K)
    params = jax.tree.map(lambda a: _normal(rng, a.shape, 0.2),
                          jb.init(jax.random.PRNGKey(0), x, x)['params'])
    tb = tqres.QLatentBlock(C, Z, kernel_size=K)
    tb.load_state_dict(params_from_flax(params), strict=True)
    syms, pm = _symbols(rng, (1, H, W, Z)), _normal(rng, (1, H, W, Z))
    want = np.asarray(jtrunk.qres_fuse(x, syms, pm, params, K,
                                       interpret=True))
    calls = []
    fused = trunk.zadd_conv_kxk

    def record(*args):
        calls.append(tuple(a.shape for a in args[:3]))
        return fused(*args)

    def refuse(*args):
        raise AssertionError('qres_fuse wrote z')

    monkeypatch.setattr(trunk, 'zadd_conv_kxk', record)
    monkeypatch.setattr(trunk, 'zadd', refuse)
    monkeypatch.setattr(trunk, 'conv_kxk_act', refuse)
    with torch.no_grad():
        got = trunk.qres_fuse(*_t(x, syms, pm), tb)
    Co = tb.z_proj_0.out_channels
    assert calls == [((1, H, W, Z), (1, H, W, Z), (K, K, Z, Co))]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ---- emb_mlp ------------------------------------------------------------------

def _emb_args(rng, B, E0, E, sparse=False):
    """(lmb, freqs, w0, b0, w1, b1, sin_period) as numpy, sin_period 64.
    sparse: each weight column holds one +-2^e (e in -3..1) at a random
    row, zeros elsewhere, so that every sum of the two products is exact."""
    def weight(K, N):
        if not sparse:
            return _normal(rng, (K, N), K ** -0.5)
        w = np.zeros((K, N), np.float32)
        w[rng.integers(0, K, N), np.arange(N)] = (
            rng.choice([-1.0, 1.0], N) * 2.0 ** rng.integers(-3, 2, N))
        return w
    lmb = np.resize(LAMBDAS, B)
    return (lmb, trunk.emb_freqs(E0, 64), weight(E0, E),
            _normal(rng, (E,), 0.1), weight(E, E), _normal(rng, (E,), 0.1),
            64)


@pytest.mark.parametrize('B', [1, 6, 7])
@pytest.mark.parametrize('E', [32, 256])
def test_emb_mlp_matches_jax(B, E):
    args = _emb_args(np.random.default_rng(B * E), B, E, E)
    want = jtrunk.emb_mlp(jnp.asarray(args[0]), jnp.asarray(args[1]),
                          *args[2:6], 64, interpret=True)
    got = trunk.emb_mlp(*_t(*args[:6]), 64)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w) == (B, E)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    # the oracle's CPU path is the same plain version
    for g, o in zip(got, trunk.emb_mlp_oneblock(*_t(*args[:6]), 64)):
        assert torch.equal(g, o)


def _kernel_constant(name):
    """A constexpr int of csrc/trunk.cu, read from the source."""
    with open(TRUNK_CU) as f:
        m = re.search(rf'constexpr int {name} = (\d+);', f.read())
    return int(m.group(1))


def _fmaf(a, b, c):
    """float32 fmaf(a, b, c), rounded once: a * b is exact in float64, the
    float64 sum is made round-to-odd from its exact error (TwoSum), and
    round-to-odd at 53 bits then to nearest at 24 is the correct rounding."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


_LANES = np.arange(32)


def _warp_sum(v):
    """warp_sum: the xor-shuffle tree, offsets 16 .. 1, over axis -1."""
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., _LANES ^ o]).astype(np.float32)
    return v


def _rows_dot(x, ldx, nr, w, K):
    """rows_dot of csrc/trunk.cu for nr rows of the flat buffer x (row
    stride ldx) with the weight row w: lane l's chain k = l, l + 32, ...,
    then warp_sum; -> (nr,) sums (every lane's, which agree)."""
    acc = np.zeros((nr, 32), np.float32)
    rows = np.arange(nr)[:, None] * ldx
    for k0 in range(0, K, 32):
        k = k0 + _LANES
        ok = k < K
        kk = np.where(ok, k, 0)
        acc = np.where(ok, _fmaf(x[rows + kk], w[kk][None], acc), acc)
    s = _warp_sum(acc)
    assert (s == s[:, :1]).all() or np.isnan(s).any()
    return s[:, 0]


def emulate_emb_mlp_cluster(lmb, freqs, w0, b0, w1, b1, sin_period, cluster,
                            chunk):
    """emb_mlp_cluster_kernel's partition on the CPU, torch tensors in and
    out. CTA r of `cluster` owns outputs [r*E/CL, (r+1)*E/CL); the batch
    runs in chunks of `chunk` rows; a warp takes outputs warp, warp +
    nwarps, ... of its CTA's slice, EMB_ROWS rows of a chunk at a time; the
    first product's values go to every CTA's own copy of h. Every output
    and every element of h must be written exactly once. The sinusoid and
    the GELUs are the plain version's torch expressions, applied to tensors
    of the plain version's shapes, so that only the sums differ from it."""
    R = _kernel_constant('EMB_ROWS')
    nwarps = _kernel_constant('EMB_CLUSTER_THREADS') // 32
    B = lmb.numel()
    E0, E = w0.shape
    w0t = w0.t().contiguous().numpy().reshape(-1)
    w1t = w1.t().contiguous().numpy().reshape(-1)
    b0, b1 = b0.numpy(), b1.numpy()
    scale = float(sin_period) / math.log(8192.0)
    args = (torch.log(lmb.reshape(-1, 1).float()) * scale) * freqs
    x_all = torch.cat([torch.cos(args), torch.sin(args)], -1).numpy()
    lo = [r * E // cluster for r in range(cluster + 1)]

    def product(bufs, wt, K, bias, out, c0, nb):
        """out[b, n] (a NaN buffer) for this chunk, every CTA's slice."""
        for r in range(cluster):
            rows = lo[r + 1] - lo[r]
            wslice = wt[lo[r] * K:(lo[r] + rows) * K]     # the staged rows
            for warp in range(nwarps):
                for n in range(warp, rows, nwarps):
                    for g in range(0, nb, R):
                        s = _rows_dot(bufs[r][g * K:], K, min(R, nb - g),
                                      wslice[n * K:(n + 1) * K], K)
                        for i, v in enumerate(s):
                            assert np.isnan(out[c0 + g + i, lo[r] + n])
                            out[c0 + g + i, lo[r] + n] = v + bias[lo[r] + n]

    h_pre = np.full((B, E), np.nan, np.float32)
    for c0 in range(0, B, chunk):
        nb = min(chunk, B - c0)
        xs = [x_all[c0:c0 + nb].reshape(-1).copy() for _ in range(cluster)]
        product(xs, w0t, E0, b0, h_pre, c0, nb)
    assert not np.isnan(h_pre).any()
    h = trunk._gelu(torch.from_numpy(h_pre)[:, None]).numpy()[:, 0]
    emb = np.full((B, E), np.nan, np.float32)
    for c0 in range(0, B, chunk):
        nb = min(chunk, B - c0)
        # each CTA's copy of h for the chunk, filled slice by slice by
        # every CTA (the distributed shared memory stores)
        hs = [np.full(nb * E, np.nan, np.float32) for _ in range(cluster)]
        for r in range(cluster):
            for peer in hs:
                for i in range(nb):
                    peer[i * E + lo[r]:i * E + lo[r + 1]] = \
                        h[c0 + i, lo[r]:lo[r + 1]]
        assert all(not np.isnan(p).any() for p in hs)
        product(hs, w1t, E, b1, emb, c0, nb)
    assert not np.isnan(emb).any()
    emb = torch.from_numpy(emb)
    return emb, trunk._gelu(emb)


# (B, E0, E, cluster, chunk): qarv_base (256) and qarv_tiny (32) widths at
# clusters of 8 and 16, B = 7 in ragged chunks; E = 20 ragged against the
# cluster; E = 5 below it (empty slices); E0 = 34 and E = 36, no multiple of
# 32 (the lanes' chains of unequal length)
_EMU_CASES = [(1, 256, 256, 8, 1), (6, 256, 256, 8, 6), (7, 256, 256, 16, 3),
              (7, 32, 32, 8, 2), (2, 32, 20, 8, 1), (3, 6, 5, 8, 2),
              (7, 34, 36, 16, 4)]


@pytest.mark.parametrize('B,E0,E,cluster,chunk', _EMU_CASES)
def test_cluster_partition_equals_plain_on_exact_sums(B, E0, E, cluster,
                                                      chunk):
    args = _t(*_emb_args(np.random.default_rng(B + E0 + E), B, E0, E,
                         sparse=True)[:6])
    want = trunk.emb_mlp_plain(*args, 64)
    got = emulate_emb_mlp_cluster(*args, 64, cluster, chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('B,E0,E,cluster,chunk', [(7, 256, 256, 8, 7),
                                                  (7, 32, 32, 16, 3)])
def test_cluster_partition_within_tolerance_on_dense_weights(B, E0, E,
                                                             cluster, chunk):
    args = _t(*_emb_args(np.random.default_rng(E + 1), B, E0, E)[:6])
    want = trunk.emb_mlp_plain(*args, 64)
    got = emulate_emb_mlp_cluster(*args, 64, cluster, chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
    # the chunking and the cluster size move no bit of the emulated sums
    other = emulate_emb_mlp_cluster(*args, 64, 8 if cluster == 16 else 16, 1)
    for g, o in zip(got, other):
        assert torch.equal(g, o)


def test_fmaf_rounds_once():
    """_fmaf against exact rational arithmetic, on products whose float64
    sum is rounded (c far below a * b, and halfway cases)."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = _normal(rng, 4000)
    b = _normal(rng, 4000)
    c = (_normal(rng, 4000) * 2.0 ** rng.integers(-60, 10, 4000)).astype(
        np.float32)
    # exact ties of the float32 rounding, nudged by a tiny c
    a[:8] = np.float32(1 + 2 ** -12)
    b[:8] = np.float32(1 + 2 ** -12)
    c[:8] = np.float32(2 ** -60) * np.array([1, -1, 0, 1, -1, 0, 1, -1],
                                            np.float32)
    got = _fmaf(a, b, c)
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        lo = np.float32(float(exact))
        # the two float32 neighbours of the exact value; the nearer, ties
        # to even
        cand = [lo, np.nextafter(lo, np.float32(np.inf)),
                np.nextafter(lo, np.float32(-np.inf))]
        best = min(cand, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.float32(v).view(np.int32))
                                        & 1))
        assert got[i] == best, (a[i], b[i], c[i])
