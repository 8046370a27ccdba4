"""The port's RD zoo against the JAX package's: for each of the eight
registered RD models, every flax parameter (from jax.eval_shape of the
net's init: traced, not compiled or run) maps one-to-one, by
weights.params_from_flax's naming and layout, onto a parameter of the
port's net of the same shape (built on the meta device: no memory, no
init), with the parameter count chip_smoke.py requires on the card. Then
the RD evaluate CLI's result file on the CPU."""
import json
import shutil
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
import lvae_tpu
import lvae_tpu.models.rd.zoo
import lvae_tpu_torch
from lvae_tpu_torch.models import weights
from lvae_tpu_torch.models.rd import evaluate

RD_NAMES = ['rd_model_base', 'rd_ablation_c64_l5_nosmooth',
            'rd_ablation_c64_l5', 'rd_ablation_c64_l10',
            'rd_ablation_c64_l15', 'rd_ablation_c96_l15',
            'rd_ablation_c128_l10', 'rd_ablation_base_nosmooth']
# rd_model_base: ~187M parameters (lvae_tpu/models/rd/README.md)
RD_BASE_PARAMS = 186670384


def test_the_eight_names_are_registered_in_both_packages():
    from lvae_tpu.registry import _all_models as jax_models
    from lvae_tpu_torch.registry import _all_models as port_models
    jax_rd = sorted(n for n in jax_models if n.startswith('rd_')
                    and n != 'rd_tiny')
    assert jax_rd == sorted(RD_NAMES)
    assert set(RD_NAMES + ['rd_tiny']) <= set(port_models)


def _jax_shapes(name, monkeypatch):
    """{flax path: shape} of the JAX model's parameters, by eval_shape of
    its net's init (the handle's init is skipped)."""
    monkeypatch.setattr(lvae_tpu.models.rd.zoo, 'RDModel',
                        lambda net, **kw: types.SimpleNamespace(net=net))
    net = lvae_tpu.get_model(name).net
    dummy = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    lmb = jax.ShapeDtypeStruct((1,), jnp.float32)
    tree = jax.eval_shape(net.init, {'params': jax.random.PRNGKey(0),
                                     'noise': jax.random.PRNGKey(1)},
                          dummy, lmb)['params']
    return {k: tuple(v.shape) for k, v in weights.flatten(tree).items()}


def _port_shape(path, shape):
    """params_from_flax's layout rule on a shape."""
    if path[-1] == 'kernel' and len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    if path[-1] == 'kernel' and len(shape) == 2:
        return (shape[1], shape[0])
    if path == ('bias',) and len(shape) == 4:
        return (shape[0], shape[3], shape[1], shape[2])
    return shape


@pytest.mark.parametrize('name', RD_NAMES)
def test_parameters_map_onto_the_jax_tree(name, monkeypatch):
    want = _jax_shapes(name, monkeypatch)
    with torch.device('meta'):
        model = lvae_tpu_torch.get_model(name, device='meta')
    got = {k: tuple(p.shape) for k, p in model.net.named_parameters()}
    mapped = {weights._torch_key(path): _port_shape(path, shape)
              for path, shape in want.items()}
    assert len(mapped) == len(want)                # one-to-one
    assert mapped == got
    n = sum(int(np.prod(s)) for s in want.values())
    assert model.num_params() == n
    if name in ('rd_model_base', 'rd_ablation_base_nosmooth'):
        assert n == RD_BASE_PARAMS
    # the counts the card run requires of the models it builds
    assert chip_smoke.RD_PARAMS[name] == n
    assert model.num_latents == {
        'rd_ablation_c64_l5_nosmooth': 5, 'rd_ablation_c64_l5': 5,
        'rd_ablation_c64_l10': 10, 'rd_ablation_c128_l10': 10}.get(name, 15)
    smooth = {b.use_linear_sqrt for b in model.net.dec_blocks
              if getattr(b, 'is_latent_block', False)}
    assert smooth == {'nosmooth' not in name}


def test_pretrained_true_raises():
    with pytest.raises(RuntimeError, match='pretrained=<local path>'):
        lvae_tpu_torch.get_model('rd_model_base', pretrained=True,
                                 device='meta')


def test_evaluate_cli_writes_the_jax_file_shape(tmp_path, monkeypatch):
    """-n takes a directory (or a known_datasets name); the file is
    runs/results/<set>-<model>.json under the working directory, holding
    {name, dataset, results} as the JAX CLI writes it."""
    (tmp_path / 'set').mkdir()
    shutil.copy('images/collie64.png', tmp_path / 'set')
    monkeypatch.chdir(tmp_path)
    out = evaluate.main(['-m', 'rd_tiny', '-n', 'set', '-s', '2'],
                        device='cpu')
    saved = json.loads(
        (tmp_path / 'runs/results/set-rd_tiny.json').read_text())
    assert list(saved) == ['name', 'dataset', 'results']
    assert saved['name'] == 'rd_tiny' and saved['dataset'] == 'set'
    assert sorted(saved['results']) == ['bpp', 'lambda', 'loss', 'psnr']
    assert all(len(v) == 2 for v in saved['results'].values())
    assert saved['results']['lambda'][0] == pytest.approx(4.0)
    assert saved['results']['lambda'][1] == pytest.approx(2048.0)
    assert out['set']['results'] == saved['results']
