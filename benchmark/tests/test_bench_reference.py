"""The plain reference held against the port's plain path (the library
forward on the CPU) on the tiny models and 64x64 images, with the same
weights: the eval reconstruction, the training loss with the same draws,
and the encode's symbols. Only this file and test_bench_faults.py import
the port."""
import numpy as np
import pytest
import torch

import lvae_tpu_torch
from conftest import QARV_TINY, QRES_TINY
from harness.png import read_png
from harness.spec import ROOT
from reference.nets import CodecNet
from reference.weights import read_flax_state, seeded_flax_state

CASES = [('qarv_tiny', QARV_TINY), ('qres_tiny', QRES_TINY)]


def _pair(name, cfg, seed=2 ** 31 + 3):
    ref = CodecNet(cfg)
    sd = seeded_flax_state(ref, seed, 'cpu', {'prior.c4': 1.0, 'prior': 1.0})
    ref.load_state_dict(sd)
    model = lvae_tpu_torch.get_model(name, device='cpu')
    model.net.load_state_dict(sd)
    return ref.eval(), model


def _image():
    im = read_png(ROOT / 'images' / 'collie64.png').astype(np.float32)
    return torch.from_numpy(np.stack([im, im[:, ::-1].copy()]) / 255.0)


@pytest.mark.parametrize('name,cfg', CASES, ids=[c[0] for c in CASES])
def test_reconstruction_equals_the_ports_forward(name, cfg):
    ref, model = _pair(name, cfg)
    im = _image()
    qarv = cfg['family'] == 'qarv'
    lmb = torch.tensor([16.0, 2048.0]) if qarv else None
    with torch.no_grad():
        got = ref.reconstruct(im.permute(0, 3, 1, 2), lmb)
    want = (model.reconstruct(im.numpy(), [16.0, 2048.0]) if qarv
            else model.reconstruct(im.numpy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize('name,cfg', CASES, ids=[c[0] for c in CASES])
def test_decode_of_the_symbols_is_the_reconstruction(name, cfg):
    ref, _ = _pair(name, cfg)
    im = _image().permute(0, 3, 1, 2)
    lmb = torch.tensor([16.0, 2048.0]) if cfg['family'] == 'qarv' else None
    with torch.no_grad():
        syms, _ = ref.encode(im, lmb)
        got = ref.decode(syms, lmb, (1, 1))
        want = ref.reconstruct(im, lmb)
    assert all(torch.equal(s, torch.round(s)) for s in syms)
    assert torch.equal(got, want)


@pytest.mark.parametrize('name,cfg', CASES, ids=[c[0] for c in CASES])
def test_training_loss_equals_the_ports(name, cfg):
    ref, model = _pair(name, cfg)
    im = _image().permute(0, 3, 1, 2).contiguous()
    g1 = torch.Generator().manual_seed(99)
    g2 = torch.Generator().manual_seed(99)
    if cfg['family'] == 'qarv':
        want, _ = model.loss_and_stats(im, training=True, generator=g1)
        got = ref.train_loss(im, g2)
    else:
        want, _ = model.loss_and_stats(im, training=True, generator=g1)
        got = ref.train_loss(im, g2, mse_lmb=model.net.out_net.mse_lmb)
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-6)


def test_checkpoint_reader_matches_the_ports():
    from lvae_tpu_torch.models.weights import (params_from_flax,
                                               read_flax_msgpack)
    path = ROOT / 'checkpoints' / 'qarv_base_mixed20k_ema_f16.msgpack'
    ours = read_flax_state(path)
    theirs = params_from_flax(read_flax_msgpack(path))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
