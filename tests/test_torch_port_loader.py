"""The port's loader of the original PyTorch project's checkpoints
(lvae_tpu_torch/models/port.py) against the JAX package's
(lvae_tpu/models/port.py): on a synthetic state dict under the JAX key
map's names, for qarv_tiny, qres_tiny, qres_tiny_lossless, rd_tiny and
qres17m (its deconvs), the port's state dict equals
params_from_flax(convert_state_dict(...)) bitwise; the checkpoint
container (a nested 'model' key beside optimizer state, CompressAI buffers,
a float16 tensor); pretrained='*.pt' through a zoo; and the three errors."""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import lvae_tpu
from lvae_tpu.models import base as jbase
from lvae_tpu.models import port as jport
from lvae_tpu.models.qarv import model as jqarv
from lvae_tpu.models.rd import model as jrd

import lvae_tpu_torch
from lvae_tpu_torch.models import port as tport
from lvae_tpu_torch.models.weights import params_from_flax

NAMES = ['qarv_tiny', 'qres_tiny', 'qres_tiny_lossless', 'rd_tiny',
         'qres17m']


def _shapes_only(self, net, *args, **kwargs):
    """A JAX handle with its net and a zero parameter tree of the net's
    shapes (eval_shape of its init: nothing compiled or run)."""
    self.net = net
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    extra = ((jnp.full((1,), 64.0, jnp.float32),)
             if isinstance(net, (jqarv.VariableRateLossyVAENet,
                                 jrd.RDVAENet)) else ())
    tree = jax.eval_shape(lambda: net.init(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
        dummy, *extra))['params']
    self.params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)


@pytest.fixture(scope='module')
def models():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jbase.VAEModelBase, jqarv.QarvModel, jrd.RDModel):
            mp.setattr(cls, '__init__', _shapes_only)
        for name in NAMES:
            out[name] = (lvae_tpu.get_model(name),
                         lvae_tpu_torch.get_model(name, device='cpu'))
    return out


def synthetic_sd(jm, rng):
    """A random original-project state dict for the JAX model: the JAX key
    map's names, the shapes its transforms invert (as
    tests/test_port.py:_synthetic_torch_sd builds it)."""
    inv_shape = {
        jport.t_conv: lambda s: (s[3], s[2], s[0], s[1]),
        jport.t_convT: lambda s: (s[2], s[3], s[0], s[1]),
        jport.t_dense: lambda s: (s[1], s[0]),
        jport.t_flat: lambda s: (1, s[0], 1, 1),
        jport.t_raw: lambda s: s,
        jport.t_bias_nhwc: lambda s: (1, s[3], 1, 1),
    }
    flat = {tuple(str(getattr(k, 'key', k)) for k in p): leaf.shape
            for p, leaf in jax.tree_util.tree_leaves_with_path(jm.params)}
    return {tk: rng.normal(0, 0.5, inv_shape[fn](tuple(flat[tuple(path)])))
            .astype(np.float32)
            for path, tk, fn in jport.build_key_map(jm)}


def expected(jm, tm, sd):
    return params_from_flax(jport.convert_state_dict(jm, sd), tm.net)


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize('name', NAMES)
def test_loader_equals_the_jax_conversion(models, name):
    jm, tm = models[name]
    sd = synthetic_sd(jm, np.random.default_rng(NAMES.index(name)))
    got = tport.convert_state_dict(tm, sd)
    assert_same(got, expected(jm, tm, sd))
    assert set(got) == set(tm.net.state_dict())
    # the same original keys, every one used
    assert {tk for _, tk, _ in tport.build_key_map(tm)} == set(sd)
    tm.net.load_state_dict(got, strict=True)


def test_the_checkpoint_container(models, tmp_path):
    """A .pt packaged as the original project's checkpoints are: the state
    dict under 'model' beside optimizer and scaler state, CompressAI's
    int32 CDF buffers, one float16 tensor. The port reads it with
    weights_only=True; extra buffers are ignored and float16 comes back
    float32, as the JAX loader gives it."""
    jm, tm = models['qarv_tiny']
    sd_np = synthetic_sd(jm, np.random.default_rng(7))
    sd = {k: torch.from_numpy(v) for k, v in sd_np.items()}
    first = next(iter(sd))
    sd[first] = sd[first].half()
    sd['entropy_model._quantized_cdf'] = torch.zeros(64, 249,
                                                     dtype=torch.int32)
    sd['entropy_model._offset'] = torch.zeros(64, dtype=torch.int32)
    sd['entropy_model._cdf_length'] = torch.zeros(64, dtype=torch.int32)
    path = tmp_path / 'ckpt.pt'
    torch.save({'model': sd,
                'optimizer': {'state': {}, 'param_groups': []},
                'scaler': {'scale': 1.0}, 'iteration': 123}, path)
    got = tport.load_torch_checkpoint(tm, path)
    assert_same(got, params_from_flax(jport.load_torch_checkpoint(jm, path),
                                      tm.net))
    # the float16 tensor rounded once, as both packages round it
    want16 = sd_np[first].astype(np.float16).astype(np.float32)
    key = next(k for k, tk, _ in tport.build_key_map(tm) if tk == first)
    assert np.array_equal(got[key].numpy().reshape(want16.shape), want16)
    # a bare state dict (no 'model' key) loads the same
    torch.save(sd, tmp_path / 'bare.pth')
    assert_same(tport.load_torch_checkpoint(tm, tmp_path / 'bare.pth'), got)
    tm.load_pretrained(str(path))
    assert_same({k: v for k, v in tm.net.state_dict().items()}, got)


def test_pretrained_pt_through_the_zoo(models, tmp_path):
    jm, tm = models['qres17m']
    sd = synthetic_sd(jm, np.random.default_rng(8))
    path = tmp_path / 'qres17m.pt'
    torch.save({'model': {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    m = lvae_tpu_torch.get_model('qres17m', pretrained=str(path),
                                 device='cpu')
    assert_same(m.net.state_dict(), expected(jm, tm, sd))


def _errors(jm, tm, sd):
    out = []
    for fn, model in ((jport.convert_state_dict, jm),
                      (tport.convert_state_dict, tm)):
        try:
            fn(model, sd)
        except (KeyError, ValueError) as e:
            out.append(e)
        else:
            out.append(None)
    return out


def test_the_three_errors(models, monkeypatch):
    jm, tm = models['rd_tiny']
    sd = synthetic_sd(jm, np.random.default_rng(9))
    # an original key missing
    missing = dict(sd)
    gone = 'dec_blocks.2.posterior.weight'
    del missing[gone]
    for e in _errors(jm, tm, missing):
        assert isinstance(e, KeyError)
        assert f'torch checkpoint missing key {gone}' in str(e)
    # a shape mismatch
    bad = dict(sd)
    bad['dec_blocks.0.z_proj.weight'] = sd[
        'dec_blocks.0.z_proj.weight'][:, :2]
    for e in _errors(jm, tm, bad):
        assert isinstance(e, ValueError)
        assert 'shape mismatch' in str(e) and 'z_proj' in str(e)
    # a parameter no rule covers
    for mod, keep in ((jport, lambda r: r[1] != 'lmb_embedding.2.bias'),
                      (tport, lambda r: r[1] != 'lmb_embedding.2.bias')):
        rules = mod.build_key_map
        monkeypatch.setattr(mod, 'build_key_map',
                            lambda m, rules=rules, keep=keep:
                            [r for r in rules(m) if keep(r)])
    for e in _errors(jm, tm, sd):
        assert isinstance(e, KeyError)
        assert 'no porting rule covers parameters' in str(e)
        assert 'lmb_embed_1' in str(e)


def test_unknown_block_raises():
    with pytest.raises(NotImplementedError, match='no porting rules'):
        tport.block_rules(torch.nn.Identity(), 'x', 'y')
    with pytest.raises(NotImplementedError):
        tport.build_key_map(types.SimpleNamespace(net=torch.nn.Identity()))
