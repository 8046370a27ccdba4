"""The system under test (lvae_tpu_torch, the PyTorch and CUDA port) and the
plain reference, built from one configuration with the same weights: the
benchmark reads or draws the state dict and hands a copy to each side."""
import gc

import torch

from harness.spec import ROOT
from reference.nets import CodecNet
from reference.weights import read_flax_state, seeded_flax_state


def state_dict(config, seed, device):
    """The configuration's weights on `device`: its checkpoint file, or the
    seeded flax-style draw (reference/weights.py)."""
    w = config['weights']
    if w['kind'] == 'checkpoint':
        return {k: v.to(device)
                for k, v in read_flax_state(ROOT / w['path']).items()}
    if w['kind'] == 'seeded_flax_init':
        with torch.device(device):
            net = CodecNet(config['net'])
        return seeded_flax_state(net, seed, device, w.get('scales'))
    raise ValueError(f"unknown weights kind {w['kind']!r}")


def build_model(config, seed, device, codec=True):
    """The port's model handle with the configuration's weights, its codec
    mode set as the configuration states."""
    import lvae_tpu_torch
    model = lvae_tpu_torch.get_model(config['port_model'], device=device)
    model.net.load_state_dict(state_dict(config, seed, device))
    if codec:
        model.compress_mode(**config['codec'])
    return model


def reference(config, seed, device):
    """The plain reference net with the same weights, in eval mode."""
    with torch.device(device):
        net = CodecNet(config['net'])
    net.load_state_dict(state_dict(config, seed, device))
    return net.eval().requires_grad_(False)


def set_tf32(on):
    """TF32 in cuBLAS products and cuDNN convolutions on or off; the
    configurations state float32 with it off."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def free(device):
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
