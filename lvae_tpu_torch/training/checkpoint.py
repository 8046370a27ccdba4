"""Checkpoints of the trainer, counterpart of
``lvae_tpu/training/checkpoint.py``: a torch.save file of a dict of tensors
and plain numbers, read back with torch.load(weights_only=True), so that
reading one runs no code. The trainer writes `last`, `best`, `last_ema`
and `best_ema` under its run directory, and `failed` when it aborts.

A training checkpoint is {'state': TrainState.state_dict(), 'iter',
'epoch', 'best_loss', 'grad_norms'}; a weights file (save_weights) is a
network's state dict. Both load through VAEModelBase.load_weights
(read_weights).
"""
import os
import shutil
from pathlib import Path

import torch

__all__ = ['save_checkpoint', 'copy_checkpoint', 'load_checkpoint',
           'save_weights', 'read_weights']


def save_checkpoint(path, payload):
    """Write `payload` to `path`, replacing it only once the new file is
    whole."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, path)


def copy_checkpoint(src, dst):
    """`dst` with the contents of the checkpoint `src`: a hard link where
    the file system has them (a qarv_base state is 1.9 GB), else a copy;
    a later save of `src` replaces its file and leaves `dst` as it was."""
    dst = Path(dst)
    tmp = dst.with_name(dst.name + '.tmp')
    if tmp.exists():
        tmp.unlink()
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def load_checkpoint(path, map_location='cpu'):
    return torch.load(path, map_location=map_location, weights_only=True)


def save_weights(path, net):
    """A network's weights alone (its state dict, on the CPU)."""
    save_checkpoint(path, {k: v.detach().cpu()
                           for k, v in net.state_dict().items()})


def read_weights(path):
    """The state dict of a weights file, or the parameters of a training
    checkpoint."""
    obj = load_checkpoint(path)
    if 'state' in obj:
        return obj['state']['params']
    return obj
