"""At flax-style init the full depth of rd_model_base and of qres34m
overflows float32, in the JAX package and in the port alike: the decoder's
features grow block by block as each z projection is added back, until
rd_model_base's KL becomes inf (its prior scales underflow) and qres34m's
prior samples overflow (inf, then NaN). This is why the card run scales
each latent block's z projection (chip_smoke.ZPROJ_SCALE) before it checks
those models' stats and samples, and why it also requires the unscaled
models to overflow there.

Each net keeps its model's full depth (every block of every stage) at a
narrow width (rd_model_base's widths / 8, qres34m's ch 96 -> 12), so that
it runs in seconds on the CPU. The weights are drawn as the card run draws
them (common.flax_init_ from a seeded generator; qres34m's prior.c4
redrawn, as chip_smoke.build_qres34m does) and given to the JAX package's
net through the inverse of weights.params_from_flax. Both packages run the
same input on the same noise (drawn with numpy inside the JAX package's
calls and replayed into the port's), op by op in JAX (a compile of the
full depth takes minutes). The overflow comes at the same blocks and
elements in both; the finite values agree within rtol 1e-3, the error of
float32 convolutions summed in other orders, grown through features that
reach 1e12 (qres34m) and KL sums that reach 1e38 (rd_model_base). One
difference is the platforms': XLA's CPU flushes subnormal float32 to zero,
torch (CPU and CUDA) keeps them, so a KL element whose prior scale squared
is subnormal is inf in JAX and finite, if near the float32 limit, in the
port.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from lvae_tpu.models.rd import model as jrd
from lvae_tpu.models.rd import zoo as jrzoo

from lvae_tpu_torch.models import entropy_coding as tec
from lvae_tpu_torch.models.rd import zoo as trzoo
from lvae_tpu_torch.models.weights import _torch_key, flatten
from lvae_tpu_torch.utils import coding

PHOTO = 'images/photo1_512x768.png'
CROP = 256
RTOL = 1e-3
RD_ENC = [256, 512, 640, 768, 768]
RD_DEC = [768, 768, 640, 512, 256]
NARROW = 8
SEED = 0


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def flax_tree(shapes, sd):
    """The port's state dict as the flax tree of `shapes` (the inverse of
    weights.params_from_flax for nets without a transposed conv)."""
    tree = {}
    for path, leaf in flatten(shapes).items():
        a = sd[_torch_key(path)].numpy()
        if path[-1] == 'kernel' and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif path[-1] == 'kernel' and a.ndim == 2:
            a = a.T
        elif path == ('bias',) and a.ndim == 4:
            a = a.transpose(0, 2, 3, 1)
        assert a.shape == leaf.shape, path
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(a)
    return tree


def numpy_noise(monkeypatch, rng):
    """jax.random.normal and uniform drawing from numpy's `rng` (no compile
    a shape, as JAX's draws take op by op); the draws, in order, go into
    the returned list."""
    drawn = []

    def normal(key, shape=(), dtype=jnp.float32):
        a = rng.standard_normal(shape).astype(np.float32)
        drawn.append(('normal', a))
        return jnp.asarray(a, dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        a = rng.uniform(minval, maxval, shape).astype(np.float32)
        drawn.append(('uniform', a))
        return jnp.asarray(a, dtype)
    monkeypatch.setattr(jax.random, 'normal', normal)
    monkeypatch.setattr(jax.random, 'uniform', uniform)
    return drawn


def replay(monkeypatch, drawn):
    """The port's noise helpers return the JAX draws in order."""
    queue = list(drawn)

    def pop(kind):
        def draw(like, generator=None):
            k, a = queue.pop(0)
            assert k == kind
            t = nchw(a)
            assert tuple(t.shape) == tuple(like.shape)
            return t.to(like.dtype)
        return draw
    monkeypatch.setattr(tec, 'normal_noise', pop('normal'))
    monkeypatch.setattr(tec, 'uniform_noise', pop('uniform'))
    return queue


def agree(got, want):
    """NaN and inf at the same elements, the finite ones within RTOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=0)


def no_init(self, net, *args, **kwargs):
    self.net = net


def test_rd_model_base_depth_overflows_its_kl_in_both_packages(monkeypatch):
    """rd_model_base's 26 encoder and 15 latent blocks at 1/8 of its widths,
    the training forward on photo1's 256 x 256 crop at lambda 64: each
    block's float32 KL summed in float64, the same in both packages, inf
    (an element's KL overflowed) in the same blocks, the first block
    finite."""
    dims = dict(enc_dims=[d // NARROW for d in RD_ENC],
                dec_dims=[d // NARROW for d in RD_DEC], z_dims=[8] * 5)
    torch.manual_seed(SEED)
    tm = trzoo.build_rd_model(**dims, device='cpu')
    with monkeypatch.context() as mp:
        mp.setattr(jrd.RDModel, '__init__', no_init)
        net = jrzoo.build_rd_model(**dims).net
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    lmb = np.full((1,), 64.0, np.float32)
    shapes = jax.eval_shape(net.init, {'params': jax.random.PRNGKey(0),
                                       'noise': jax.random.PRNGKey(1)},
                            x, jnp.asarray(lmb))['params']
    params = flax_tree(shapes, tm.net.state_dict())
    im = coding.read_png(PHOTO)[:CROP, :CROP].astype(np.float32)[None] / 255
    with monkeypatch.context() as mp:
        drawn = numpy_noise(mp, np.random.default_rng(SEED))
        _, stats = net.apply({'params': params}, jnp.asarray(im),
                             jnp.asarray(lmb), True, False,
                             method=net.forward_end2end,
                             rngs={'noise': jax.random.PRNGKey(0)})
    want = [np.asarray(st['kl'], np.float64).sum() for st in stats]
    queue = replay(monkeypatch, drawn)
    with torch.no_grad():
        _, stats = tm.net.forward_end2end(nchw(im), torch.from_numpy(lmb))
    assert not queue
    got = [st['kl'].double().sum().item() for st in stats]
    got, want = np.array(got), np.array(want)
    assert len(got) == tm.num_latents == 15
    # XLA's CPU flushes a subnormal float32 to zero and torch keeps it:
    # where a prior scale's square is subnormal, an element's KL is inf in
    # JAX and at least 0.5 / the least normal float32 in the port
    edge = np.isinf(want) & np.isfinite(got)
    assert (got[edge] >= 0.5 / np.finfo(np.float32).tiny).all()
    agree(np.where(edge, np.inf, got), want)
    assert np.isfinite(want[0]) and np.isinf(want[-3:]).all()
    assert np.isinf(got[-3:]).all()
