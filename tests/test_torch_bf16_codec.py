"""The bf16 encoder backbone of the fused codecs
(compress_mode(compute_dtype='bfloat16')) on the CPU, at qarv_tiny,
qres_tiny and qres_tiny_lossless (64x64): round trips bit-exact at B = 1
and B = 2 on both trunks; the backbone's features against the JAX
package's bf16 backbone (lvae_tpu/models/qarv/fused.py:222-241,
qresvae/fused.py:183-188, run here op for op) within a stated bf16
tolerance; the symbols and scale indexes against the JAX package's bf16
codec, counted (ROADMAP.md C records the counts); the codec cache across
f32, bf16 and portable; and QRes's compress_mode(coder=None), the fused
coder in both packages.

The posterior's (last) conv is scaled x300 (QRes: the prior's last conv
re-drawn too) so that the untrained models code symbols other than zero.

Tolerance of the features: bf16 keeps 8 bits of mantissa, and the two
packages round after different operations (XLA's CPU backend fuses
elementwise chains in float32, torch rounds after each), so each feature
is held at ||port - jax|| <= 2^-5 ||jax|| (the measured worst is about a
quarter of that), and both packages' bf16 features at the same distance
from the float32 ones.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.models import base as jbase
from lvae_tpu.models import common as jcommon
from lvae_tpu.models.qarv import model as jqarv
from lvae_tpu.models.fused_base import cast_tree

import lvae_tpu_torch
from lvae_tpu_torch.models.weights import params_from_flax

BF16 = 'bfloat16'
FEATURE_RTOL = 2.0 ** -5
NAMES = ['qarv_tiny', 'qres_tiny', 'qres_tiny_lossless']
N = 16
LMB = 512.0


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch calls: under the suite's
    parallel workers torch's default of one thread a core oversubscribes
    the machine, and these small calls then spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(tree, rng):
    """The posterior's (last) conv kernel x300; each QRes prior's last conv re-drawn at the
    lecun-normal scale (flax zero-initialises it)."""
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = v
        elif k == 'posterior' and 'kernel' in v:            # QARV
            out[k] = dict(v, kernel=v['kernel'] * 300.0)
        elif k == 'posterior':                              # QRes: last conv
            out[k] = dict(v, c4=dict(v['c4'],
                                     kernel=v['c4']['kernel'] * 300.0))
        elif k == 'prior' and 'c4' in v:
            c4 = dict(v['c4'])
            c4['kernel'] = (rng.normal(size=c4['kernel'].shape) / np.sqrt(
                c4['kernel'].shape[2])).astype(np.float32)
            out[k] = dict(v, c4=c4)
        else:
            out[k] = _scaled(v, rng)
    return out


def _jit_init(self, net, seed=0, example_hw=64, log_images=()):
    """The JAX handles' flax init jitted (one compile, not an op-by-op
    trace); QarvModel's attributes as its own init sets them."""
    self.net = net
    dummy = jnp.zeros((1, example_hw, example_hw, 3), jnp.float32)
    key = {'params': jax.random.PRNGKey(seed)}
    if isinstance(net, jqarv.VariableRateLossyVAENet):
        self.lmb_range = tuple(float(v) for v in net.lmb_range)
        self.default_lmb = self.lmb_range[1]
        self._logging_images = list(log_images)
        self.num_latents = sum(1 for b in net.dec_blocks
                               if getattr(b, 'is_latent_block', False))
        self._coder = jqarv.ec.DiscretizedConditional(
            jqarv.cdf_ops.default_gaussian_scale_table(), dist='gaussian')
        self.compressing = False
        lmb = jnp.full((1,), self.lmb_range[1], jnp.float32)
        self.params = jax.jit(net.init)(key, dummy, lmb)['params']
    else:
        self.params = jax.jit(net.init)(key, dummy)['params']


@pytest.fixture(scope='module')
def models():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase.VAEModelBase, '__init__', _jit_init)
        mp.setattr(jqarv.QarvModel, '__init__', _jit_init)
        jms = {name: lvae_tpu.get_model(name) for name in NAMES}
    for name in NAMES:
        jm = jms[name]
        params = _scaled(jax.device_get(jm.params),
                         np.random.default_rng(0))
        jm.params = jax.tree.map(jnp.asarray, params)
        tm = lvae_tpu_torch.get_model(name, device='cpu')
        tm.net.load_state_dict(params_from_flax(params), strict=True)
        out[name] = jm, tm, params
    return out


@pytest.fixture(scope='module')
def images():
    return np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)


def _mode(tm, **kw):
    kw.setdefault('num_lanes', N)
    if tm.__class__.__name__ == 'QresModel' and tm.lossless:
        kw.setdefault('esc_cap', 1 << 14)
    tm.compress_mode(compute_dtype=BF16, **kw)


def _compress_check(tm, im):
    if hasattr(tm, 'lmb_range'):
        return tm.compress_check(im, lmb=LMB)
    return tm.compress_check(im)


@pytest.mark.parametrize('portable', [False, True], ids=['legacy', 'portable'])
@pytest.mark.parametrize('name', NAMES)
def test_bf16_round_trips_bit_exact(models, images, name, portable):
    _, tm, _ = models[name]
    _mode(tm, portable=portable)
    stream, recon = _compress_check(tm, images[:1])
    assert np.array_equal(tm.decompress(stream), recon)
    ims = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    ctx = (() if not hasattr(tm, 'lmb_range')
           else (torch.full((2,), LMB),))
    _, want = tm._fused.encode_check_batch(ims, *ctx)
    objs = (tm.compress_batch(images, lmb=LMB) if ctx
            else tm.compress_batch(images))
    got = tm.decompress_batch(objs)
    assert np.array_equal(got, want)
    if portable:             # a portable batch stream decodes alone too
        assert np.array_equal(tm.decompress(objs[1]), got[1:])


def _jax_backbone(jm, params, im, bf16):
    """The JAX fused codec's encode-side backbone, op for op: the encoder
    blocks on cast parameters, each feature taken as float32."""
    net, cd = jm.net, (jnp.bfloat16 if bf16 else None)
    x = net.preprocess_input(im if cd is None else im.astype(cd))
    emb = None
    if hasattr(net, 'lmb_range'):
        emb = net.apply({'params': params}, jnp.full((1,), LMB, jnp.float32),
                        method=net.get_lmb_embedding)
        emb = emb if cd is None else emb.astype(cd)
    feats = {}
    for i, blk in enumerate(net.enc_blocks):
        bp = cast_tree(params.get(f'enc_blocks_{i}', {}), cd)
        if isinstance(blk, jcommon.SetKey):
            feats[blk.key] = x.astype(jnp.float32)
            continue
        if getattr(blk, 'requires_embedding', False):
            x = blk.apply({'params': bp}, x, emb)
        else:
            x = blk.apply({'params': bp}, x) if bp else blk(x)
        if emb is None:      # QRes: the last block at each height wins
            feats[int(x.shape[1])] = x.astype(jnp.float32)
    return {k: np.asarray(v) for k, v in feats.items()}


def _port_backbone(tm, im, bf16):
    tm.compress_mode(num_lanes=N, compute_dtype=BF16 if bf16 else None)
    x = torch.from_numpy(im).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        if hasattr(tm, 'lmb_range'):
            ctx = tm._fused._context(torch.full((1,), LMB))
            feats = tm._fused._backbone(x, *ctx)
        else:
            feats = tm._fused._backbone(x)
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in feats.items()}


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny'])
def test_bf16_backbone_features_match_jax(models, images, name):
    jm, tm, params = models[name]
    im = images[:1]
    want = _jax_backbone(jm, jax.tree.map(jnp.asarray, params),
                         jnp.asarray(im), True)
    got = _port_backbone(tm, im, True)
    f32 = _port_backbone(tm, im, False)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == np.float32
        scale = np.linalg.norm(want[k])
        assert np.linalg.norm(got[k] - want[k]) <= FEATURE_RTOL * scale, k
        assert np.linalg.norm(want[k] - f32[k]) <= FEATURE_RTOL * scale, k
        assert np.linalg.norm(got[k] - f32[k]) <= FEATURE_RTOL * scale, k
        assert not np.array_equal(got[k], f32[k])       # bf16 ran


def _jax_symbols(jm, im):
    """The JAX bf16 fused codec's symbols and indexes, as its payload
    assembly received them (a debug callback)."""
    jm.compress_mode(coder='fused', num_lanes=N, compute_dtype=BF16)
    codec = jm._fused
    captured = []
    orig = codec.pack_payload

    def spy(syms_flat, idx_flat):
        jax.debug.callback(
            lambda *a: captured.append([np.asarray(x) for x in a]),
            *syms_flat, *idx_flat)
        return orig(syms_flat, idx_flat)

    codec.pack_payload = spy
    try:
        if hasattr(jm, 'lmb_range'):
            jm.compress(im, lmb=LMB)
        else:
            jm.compress(im)
    finally:
        codec.pack_payload = orig
    arrs = captured[-1]
    nb = len(arrs) // 2
    return np.concatenate(arrs[:nb]), np.concatenate(arrs[nb:])


def _port_symbols(tm, im, cd=BF16):
    tm.compress_mode(num_lanes=N, compute_dtype=cd)
    codec = tm._fused
    seen = []
    orig = codec.pack_payload
    codec.pack_payload = lambda s, i: (seen.append(
        (torch.cat(s).numpy().copy(), torch.cat(i).numpy().copy()))
        or orig(s, i))
    try:
        if hasattr(tm, 'lmb_range'):
            tm.compress(im, lmb=LMB)
        else:
            tm.compress(im)
    finally:
        codec.pack_payload = orig
    return seen[0]


@pytest.mark.parametrize('name', ['qarv_tiny', 'qres_tiny'])
def test_bf16_symbols_against_jax_stream(models, images, name):
    """Counted, not required equal: a bf16 feature a rounding away from
    the JAX one moves a posterior mean across a rounding boundary (x300
    posteriors make most symbols large), and the trunk floats, so the
    indexes, follow the symbols (the test prints the counts)."""
    jm, tm, _ = models[name]
    jsyms, jidx = _jax_symbols(jm, images[:1])
    tsyms, tidx = _port_symbols(tm, images[:1])
    fsyms, _ = _port_symbols(tm, images[:1], None)
    n_sym, n_idx = int((tsyms != jsyms).sum()), int((tidx != jidx).sum())
    n_f32 = int((tsyms != fsyms).sum())
    print(f'{name} bf16: {n_sym} of {tsyms.size} symbols and {n_idx} of '
          f'{tidx.size} scale indexes differ from the JAX stream; the '
          f'port\'s bf16 stream differs from its float32 one in {n_f32}')
    assert tsyms.size == jsyms.size and (tsyms != 0).any()
    # the two packages' bf16 streams are no farther apart than the port's
    # bf16 stream is from its float32 one (which the JAX package's agrees
    # with: tests/test_torch_codec.py, test_torch_qres.py)
    assert n_sym <= n_f32


def test_codec_cache_keys_compute_dtype(models):
    _, tm, _ = models['qarv_tiny']
    tm.compress_mode(num_lanes=N)
    f32 = tm._fused
    tm.compress_mode(num_lanes=N, compute_dtype=BF16)
    bf = tm._fused
    tm.compress_mode(num_lanes=N, compute_dtype=BF16, portable=True)
    pbf = tm._fused
    assert len({id(f32), id(bf), id(pbf)}) == 3
    assert bf.compute_dtype == torch.bfloat16 and f32.compute_dtype is None
    tm.compress_mode(num_lanes=N)
    assert tm._fused is f32                      # reused, not rebuilt
    tm.compress_mode(num_lanes=N, compute_dtype=BF16)
    assert tm._fused is bf
    blocks = bf.backbone_blocks()
    assert blocks is bf.backbone_blocks()        # cast once
    assert all(p.dtype == torch.bfloat16 for p in blocks.parameters())
    with torch.no_grad():                        # a weight changes: recast
        tm.net.enc_blocks[0].conv.weight.mul_(1.0)
    again = bf.backbone_blocks()
    assert again is not blocks
    assert all(p.dtype == torch.float32 for p in tm.net.parameters())
    with pytest.raises(ValueError, match='not a floating dtype'):
        tm.compress_mode(compute_dtype='int8')


def test_qres_coder_none_is_fused_in_both_packages(models, images):
    jm, tm, _ = models['qres_tiny']
    jm.compress_mode(coder=None, num_lanes=N)
    assert jm.coder_kind == 'fused'
    tm.compress_mode(coder=None, num_lanes=N)
    assert tm.coder_kind == 'fused'
    obj, recon = tm.compress_check(images[:1])
    assert np.array_equal(tm.decompress(obj), recon)
    qarv = models['qarv_tiny'][1]
    with pytest.raises(ValueError):              # QARV keeps refusing None
        qarv.compress_mode(coder=None)
