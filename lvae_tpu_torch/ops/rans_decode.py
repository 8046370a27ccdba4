"""N-lane interleaved rANS decode of one latent block, for one image or B.

`rans_decode_block` and `rans_decode_block_multi` have the interfaces of the
JAX package's Pallas functions (lvae_tpu/ops/pallas/rans_decode.py:160 and
:359): each launches the CUDA kernel of csrc/rans.cu for tensors on the card
and runs its plain PyTorch version, a row loop, for tensors on the CPU. Lane
states and word pointers are device tensors carried from block to block, so
the nine block launches of an image (or of a batch) need no host
synchronisation.
"""
import numpy as np
import torch

from lvae_tpu_torch.ops import build

MASK16 = (1 << 16) - 1
_SENTINEL = 1 << 17  # padded-CDF entry: larger than any 16-bit slot


def prepare_device_cdf(table):
    """CDF table in kernel form: int32 rows, entries past each row's length
    set to a sentinel larger than any 16-bit slot. -> (cdfs, offsets) numpy."""
    cdfs = table.cdfs.astype(np.int64).copy()
    valid = np.arange(cdfs.shape[1])[None, :] < table.cdf_lengths[:, None]
    cdfs[~valid] = _SENTINEL
    return cdfs.astype(np.int32), table.offsets.astype(np.int32)


def to_i32_bits(x):
    """int64 tensor holding uint32 values -> int32 tensor, same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def rans_decode_block_plain(indexes, states, ptr, stream, cdfs, offsets, nsym):
    """Plain PyTorch twin of the decode kernel: a loop over the T rows, each
    lane-vectorised in int64. Same arguments and results as
    `rans_decode_block`; runs on any device."""
    T, N = indexes.shape
    dev = indexes.device
    cdf = cdfs.to(torch.int64)
    idx = indexes.to(torch.int64)
    W = stream.numel()
    # one zero word past the end: reads beyond the stream give 0
    words = torch.cat([stream.to(torch.int64) & MASK16,
                       torch.zeros(1, dtype=torch.int64, device=dev)])
    active = torch.arange(T * N, device=dev).reshape(T, N) < int(nsym)
    x = states.reshape(N).to(torch.int64) & 0xFFFFFFFF
    p = ptr.reshape(()).to(torch.int64)
    syms = []
    for t in range(T):
        act = active[t]
        rows = cdf[idx[t]]                                         # (N, L)
        slot = x & MASK16
        # rows are sentinel-padded, so s + 1 stays inside every row
        s = (rows <= slot[:, None]).sum(1) - 1
        se = rows.gather(1, torch.stack([s, s + 1], 1))
        start = se[:, 0]
        nx = ((se[:, 1] - start) * (x >> 16) + slot - start) & 0xFFFFFFFF
        flag = act & ((nx >> 16) == 0)
        fi = flag.to(torch.int64)
        wpos = p + torch.cumsum(fi, 0) - fi          # ascending lane order
        word = words[wpos.clamp(max=W)]
        nx = torch.where(flag, ((nx << 16) | word) & 0xFFFFFFFF, nx)
        x = torch.where(act, nx, x)
        syms.append(s)
        p = p + fi.sum()
    values = torch.stack(syms) + offsets.to(torch.int64)[idx]
    values = torch.where(active, values, 0).to(torch.int32)
    return values, to_i32_bits(x).reshape(1, N), p.to(torch.int32)


def launches_kernel(name, dev, tensors):
    """True where the kernel is to launch: contiguous int32 tensors on one
    card; False for CPU tensors, where the plain version runs. Raises on
    anything else."""
    if dev.type == 'cpu':
        return False
    if dev.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {dev}')
    for a in tensors:
        if a.device != dev or a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError(f'{name}: every input must be a contiguous '
                             f'int32 tensor on the same card')
    return True


def launch_context(dev):
    """(device ordinal, current stream handle) for a kernel launch."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def rans_decode_block(indexes, states, ptr, stream, cdfs, offsets, nsym,
                      num_lanes=128):
    """Decode one latent block's symbols.

    Args:
        indexes: (T, N) int32 scale indexes, row-major lane layout, padded
        states:  (1, N) int32 lane states (uint32 bit patterns)
        ptr:     0-dim int32 tensor, the current word position in `stream`
        stream:  (W,) int32 words (16-bit payloads)
        cdfs:    (S, L) int32 sentinel-padded CDF rows (prepare_device_cdf)
        offsets: (S,) int32 symbol offset per scale
        nsym:    int, the number of valid symbols in this block
    Returns:
        (values (T, N) int32, new_states (1, N) int32, new_ptr 0-dim int32)
    """
    T, N = indexes.shape
    if N != num_lanes:
        raise ValueError(f'indexes have {N} lanes, expected {num_lanes}')
    args = (indexes, states, ptr, stream, cdfs, offsets)
    dev = indexes.device
    if not launches_kernel('rans_decode_block', dev, args):
        return rans_decode_block_plain(*args, nsym)
    if states.numel() != N or ptr.numel() != 1:
        raise ValueError('rans_decode_block: states must be (1, N), ptr 0-dim')
    S, L = cdfs.shape
    lib = build.library()
    values = torch.empty((T, N), dtype=torch.int32, device=dev)
    new_states = torch.empty((1, N), dtype=torch.int32, device=dev)
    new_ptr = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.rans_decode_block(
        indexes.data_ptr(), T, N, states.data_ptr(), new_states.data_ptr(),
        ptr.data_ptr(), new_ptr.data_ptr(), stream.data_ptr(), stream.numel(),
        cdfs.data_ptr(), S, L, offsets.data_ptr(), int(nsym),
        values.data_ptr(), *launch_context(dev))
    build.check(err, 'rans_decode_block')
    rans_decode_block.launches += 1
    return values, new_states, new_ptr


rans_decode_block.launches = 0


def rans_decode_block_multi_plain(indexes, states, ptrs, streams, cdfs,
                                  offsets, nsym):
    """Plain PyTorch twin of the kernel launched with one block per image:
    `rans_decode_block_plain`'s row loop vectorised over (B, N), as the TPU
    kernel stacks the B images' states. Same arguments and results as
    `rans_decode_block_multi`; runs on any device."""
    B, T, N = indexes.shape
    dev = indexes.device
    cdf = cdfs.to(torch.int64)
    idx = indexes.to(torch.int64)
    W = streams.shape[1]
    # one zero word past each stream's end: reads beyond it give 0
    words = torch.cat([streams.to(torch.int64) & MASK16,
                       torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    active = torch.arange(T * N, device=dev).reshape(T, N) < int(nsym)
    x = states.reshape(B, N).to(torch.int64) & 0xFFFFFFFF
    p = ptrs.reshape(B).to(torch.int64)
    syms = []
    for t in range(T):
        act = active[t]
        rows = cdf[idx[:, t]]                                      # (B, N, L)
        slot = x & MASK16
        s = (rows <= slot[..., None]).sum(-1) - 1
        se = rows.gather(2, torch.stack([s, s + 1], 2))
        start = se[..., 0]
        nx = ((se[..., 1] - start) * (x >> 16) + slot - start) & 0xFFFFFFFF
        flag = act & ((nx >> 16) == 0)
        fi = flag.to(torch.int64)
        wpos = p[:, None] + torch.cumsum(fi, 1) - fi   # ascending lane order
        word = words.gather(1, wpos.clamp(max=W))
        nx = torch.where(flag, ((nx << 16) | word) & 0xFFFFFFFF, nx)
        x = torch.where(act, nx, x)
        syms.append(s)
        p = p + fi.sum(1)
    values = torch.stack(syms, 1) + offsets.to(torch.int64)[idx]
    values = torch.where(active, values, 0).to(torch.int32)
    return values, to_i32_bits(x), p.to(torch.int32)


def rans_decode_block_multi(indexes, states, ptrs, streams, cdfs, offsets,
                            nsym, num_lanes=128):
    """Decode one latent block of B same-shape images in one launch (one
    thread block per image); bit-identical to B `rans_decode_block` calls.

    Args:
        indexes: (B, T, N) int32 scale indexes
        states:  (B, N) int32 lane states
        ptrs:    (B,) int32 word positions
        streams: (B, W) int32 words (16-bit payloads), each image's stream
                 zero-padded to the common W
        cdfs, offsets: as for `rans_decode_block`
        nsym:    int, the valid symbols per image (one shape per batch)
    Returns:
        (values (B, T, N) int32, new_states (B, N) int32, new_ptrs (B,))
    """
    B, T, N = indexes.shape
    if N != num_lanes:
        raise ValueError(f'indexes have {N} lanes, expected {num_lanes}')
    args = (indexes, states, ptrs, streams, cdfs, offsets)
    dev = indexes.device
    if not launches_kernel('rans_decode_block_multi', dev, args):
        return rans_decode_block_multi_plain(*args, nsym)
    if (states.shape != (B, N) or ptrs.shape != (B,)
            or streams.ndim != 2 or streams.shape[0] != B):
        raise ValueError('rans_decode_block_multi: states must be (B, N), '
                         'ptrs (B,), streams (B, W)')
    S, L = cdfs.shape
    lib = build.library()
    values = torch.empty((B, T, N), dtype=torch.int32, device=dev)
    new_states = torch.empty((B, N), dtype=torch.int32, device=dev)
    new_ptrs = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.rans_decode_block_multi(
        indexes.data_ptr(), B, T, N, states.data_ptr(),
        new_states.data_ptr(), ptrs.data_ptr(), new_ptrs.data_ptr(),
        streams.data_ptr(), streams.shape[1], cdfs.data_ptr(), S, L,
        offsets.data_ptr(), int(nsym), values.data_ptr(),
        *launch_context(dev))
    build.check(err, 'rans_decode_block_multi')
    rans_decode_block_multi.launches += 1
    return values, new_states, new_ptrs


rans_decode_block_multi.launches = 0
