"""Distributed verification utilities, counterpart of
``lvae_tpu/parallel/dist_utils.py`` on torch.distributed: barrier,
broadcast_object, check_model_equivalence and sync_params_from_host0.
Each is a no-op at world size 1, as in the JAX package."""
import numpy as np
import torch
import torch.distributed as dist

from lvae_tpu_torch.parallel.mesh import (
    broadcast_tensors, named_tensors, process_count, process_index,
)

__all__ = ['barrier', 'broadcast_object', 'check_model_equivalence',
           'sync_params_from_host0']


def barrier(name='barrier'):
    """Every rank waits here for the others (`name` labels the call
    site)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_object(obj, root=0):
    """A picklable object from rank `root` on every rank."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def _first_mismatch(x, name, t, ref, atol):
    """None when t equals ref (bitwise at atol 0, NaN never equal), else
    where they first differ: the parameter's name for a TrainState's flat
    buffer."""
    same = torch.equal(t, ref) if atol == 0 else torch.allclose(
        t, ref, rtol=0.0, atol=atol)
    if same:
        return None
    if not (hasattr(x, 'flat_buffers') and t.dtype.is_floating_point):
        return name
    off = int(torch.nonzero(~torch.isclose(t, ref, rtol=0.0, atol=atol))[0])
    which = int(np.searchsorted(np.cumsum(x.numels), off, side='right'))
    return f'{name}: {x.names[which]}'


def check_model_equivalence(params, mesh=None, atol=0.0):
    """Whether every rank of the mesh (the world when None) holds rank
    0's tensors of `params` (a TrainState: its flat buffers, each compared
    once, and its counts; a module; a dict or list of tensors), within
    `atol`; a rank that differs prints the first mismatching name. The
    same bool on every rank."""
    group = None if mesh is None else mesh.group
    n = process_count() if mesh is None else mesh.size
    if n == 1 or (mesh is not None and not mesh.includes_me):
        return True
    src = 0 if mesh is None else int(mesh.ranks.flat[0])
    named = named_tensors(params)
    refs = broadcast_tensors([t.detach().clone() for _, t in named], src,
                             group)
    bad = None
    for (name, t), ref in zip(named, refs):
        bad = _first_mismatch(params, name, t, ref, atol)
        if bad is not None:
            print(f'rank {process_index()}: parameter mismatch across ranks '
                  f'at {bad}', flush=True)
            break
    flag_device = 'cuda' if dist.get_backend(group) == 'nccl' else 'cpu'
    ok = torch.tensor([bad is None], dtype=torch.int32, device=flag_device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    return bool(ok.item())


def sync_params_from_host0(params):
    """Rank 0's tensors of `params` (as check_model_equivalence takes them)
    on every rank, in place; -> params."""
    if process_count() > 1:
        broadcast_tensors(params, 0)
    return params
