"""qres34m's full depth at flax-style init overflows its samples in the
JAX package and in the port alike; see tests/test_torch_init_overflow.py,
which holds rd_model_base's KL so, for the reasons and the tolerances."""
import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lvae_tpu.models import base as jbase
from lvae_tpu.models.qresvae import zoo as jqzoo

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.qresvae import zoo as tqzoo

from tests.test_torch_init_overflow import (SEED, agree, flax_tree,
                                            no_init, numpy_noise, replay)

QRES_CH = 12


def qres34m_narrow(zoo, ch, **kwargs):
    """The package's own qres34m (its zoo's _qres34m_blocks) at width ch."""
    src = inspect.getsource(zoo._qres34m_blocks)
    assert src.count('ch = 96') == 1
    ns = dict(vars(zoo))
    exec(src.replace('ch = 96', f'ch = {ch}'), ns)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(zoo, '_qres34m_blocks', ns['_qres34m_blocks'])
        return zoo.qres34m(**kwargs)


def test_qres34m_depth_overflows_its_samples_in_both_packages(monkeypatch):
    """qres34m's 24 encoder and 12 latent blocks at ch 12, unconditional
    samples at temperature 1 on a (2, 2, 2) latent grid: the decoder's
    output (before the clip) the same in both packages, NaN at the same
    elements."""
    tm = qres34m_narrow(tqzoo, QRES_CH, device='cpu')
    g = torch.Generator().manual_seed(SEED)
    common.flax_init_(tm.net, g)
    for blk in tm.net.dec_blocks:
        if getattr(blk, 'is_latent_block', False):
            common.lecun_normal_(blk.prior.c4.weight, g)
    with monkeypatch.context() as mp:
        mp.setattr(jbase.VAEModelBase, '__init__', no_init)
        net = qres34m_narrow(jqzoo, QRES_CH).net
    shapes = jax.eval_shape(net.init, {'params': jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3), jnp.float32))['params']
    params = flax_tree(shapes, tm.net.state_dict())
    bhw = (2, 2, 2)
    with monkeypatch.context() as mp:
        drawn = numpy_noise(mp, np.random.default_rng(SEED))
        feature = net.apply({'params': params}, bhw, 1.0,
                            method=net.forward_uncond,
                            rngs={'sample': jax.random.PRNGKey(0)})
        want = np.asarray(net.apply({'params': params}, feature, None,
                                    method=net.sample_output))
    queue = replay(monkeypatch, drawn)
    with torch.no_grad():
        feature = tm.net.forward_with_latents(None, bhw, 1.0)
        got = tm.net.sample_output(feature).permute(0, 2, 3, 1).numpy()
    assert not queue
    agree(got, want)
    assert np.isnan(want).any()
