"""N-lane interleaved rANS encode of all the symbol rows of one image or B.

`rans_encode_all` and `rans_encode_all_multi` have the interfaces of the JAX
package's Pallas functions (lvae_tpu/ops/pallas/rans_encode.py:217 and
:419): each runs the CUDA encode of csrc/rans.cu for tensors on the card
(four launches: lookup, lane chains, scan, word placement; one count a
call) and its plain PyTorch version, a row loop, for tensors on the CPU.
Streams are byte-identical to lvae_tpu/ops/rans_interleaved.py's encoder.
The `_rowsync` wrappers run the first encode kernel, the card checks'
oracle.

Escapes are handled outside the kernel (`prepare_inband`): out-of-range
values are coded as the escape bin and their (position, value) pairs travel
beside the words.
"""
import numpy as np
import torch

from lvae_tpu_torch.ops import build
from lvae_tpu_torch.ops.rans_decode import (launch_context,
                                            launches_kernel, to_i32_bits)

MASK16 = (1 << 16) - 1


def pair_capacity(w_cap):
    """Pair-buffer length (int32 elements) for a capacity of `w_cap` 16-bit
    words, including the JAX kernel's +2048 window overhang, so that the
    payload layout matches the JAX package's."""
    return (((w_cap + 1) // 2 + 2047) // 2048) * 2048 + 2048


def pairs_to_words(pair_buf, n_words):
    """Push-order 16-bit words of a pair buffer (pair j = word 2j | word
    2j+1 << 16); the stream is their reversal."""
    arr = np.ascontiguousarray(np.asarray(pair_buf, dtype='<i4'))
    return arr.view('<u2')[:int(n_words)]


def blocks_to_rows(values_per_block, indexes_per_block, N):
    """Lay out per-block flat symbol arrays as (T, N) rows, each block
    starting on a fresh row. -> (syms_rows, idx_rows, row_n) numpy."""
    sym_rows, idx_rows, row_ns = [], [], []
    for v, ix in zip(values_per_block, indexes_per_block):
        v = np.asarray(v, np.int32).ravel()
        ix = np.asarray(ix, np.int32).ravel()
        Tb = max((v.size + N - 1) // N, 1)
        sv = np.zeros(Tb * N, np.int32)
        si = np.zeros(Tb * N, np.int32)
        sv[:v.size] = v
        si[:ix.size] = ix
        rn = np.full(Tb, N, np.int32)
        rn[-1] = v.size - (Tb - 1) * N if v.size else 0
        sym_rows.append(sv.reshape(Tb, N))
        idx_rows.append(si.reshape(Tb, N))
        row_ns.append(rn)
    return (np.concatenate(sym_rows), np.concatenate(idx_rows),
            np.concatenate(row_ns))


def prepare_inband(values, indexes, offsets, lengths):
    """-> (in-band symbols int32, escape mask). In-band symbol = value minus
    its scale's offset, with out-of-range values replaced by the escape bin
    (cdf_length - 2). offsets/lengths: per-scale tables (numpy or tensor)."""
    dev = values.device
    off = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
    max_sym = torch.as_tensor(lengths, dtype=torch.int64, device=dev) - 2
    ix = indexes.to(torch.int64)
    sym = values.to(torch.int64) - off[ix]
    ms = max_sym[ix]
    esc = (sym < 0) | (sym >= ms)
    return torch.where(esc, ms, sym).to(torch.int32), esc


def rans_encode_all_plain(syms, indexes, row_n, cdfs, w_cap=None):
    """Plain PyTorch twin of the encode kernel: a reverse loop over the rows,
    lane-vectorised in int64; word positions are laid out after the loop.
    Same arguments and results as `rans_encode_all`; runs on any device."""
    T, N = syms.shape
    dev = syms.device
    w_cap = T * N if w_cap is None else int(w_cap)
    cdf = cdfs.to(torch.int64)
    S, L = cdf.shape
    flat = (indexes.to(torch.int64).clamp(0, S - 1) * L
            + syms.to(torch.int64).clamp(0, L - 2))
    rn = torch.as_tensor(row_n, dtype=torch.int64, device=dev)
    active = torch.arange(N, device=dev)[None, :] < rn[:, None]
    start = torch.where(active, cdf.reshape(-1)[flat], 0)
    freq = torch.where(active, cdf.reshape(-1)[flat + 1] - start, 1)
    x = torch.full((N,), 1 << 16, dtype=torch.int64, device=dev)
    flags, words = [], []                   # in push order of the rows
    for t in range(T - 1, -1, -1):
        act, f = active[t], freq[t]
        flag = act & ((x >> 16) >= f)
        flags.append(flag)
        words.append(x & MASK16)
        x = torch.where(flag, x >> 16, x)
        x = torch.where(act, ((x // f) << 16) + x % f + start[t], x)
    # push order: rows T-1 .. 0, lanes descending inside each row
    pf = torch.stack(flags).flip(1).reshape(-1)
    pw = torch.stack(words).flip(1).reshape(-1)
    pos = torch.cumsum(pf.to(torch.int64), 0) - 1
    keep = pf & (pos < w_cap)
    P = pair_capacity(w_cap)
    buf = torch.zeros(2 * P + 1, dtype=torch.int64, device=dev)
    buf.scatter_(0, torch.where(keep, pos, 2 * P), torch.where(keep, pw, 0))
    pairs = to_i32_bits(buf[0:2 * P:2] | (buf[1:2 * P:2] << 16))
    n_words = pf.sum().to(torch.int32)
    return pairs, n_words, to_i32_bits(x).reshape(1, N)


def _encode(entry, syms, indexes, row_n, cdfs, num_lanes, w_cap,
            scratch=None):
    """The encode wrappers' common body, for (T, N) or (B, T, N) symbols:
    the plain version on CPU tensors, else one call of C entry point
    `entry` (on `scratch`, allocated here if None). -> (outputs,
    launched)."""
    multi = syms.dim() == 3
    *_, T, N = syms.shape
    if N != num_lanes:
        raise ValueError(f'symbols have {N} lanes, expected {num_lanes}')
    dev = syms.device
    if dev.type == 'cuda':
        row_n = torch.as_tensor(row_n, dtype=torch.int32, device=dev)
    if not launches_kernel(entry, dev, (syms, indexes, row_n, cdfs)):
        plain = rans_encode_all_multi_plain if multi else rans_encode_all_plain
        return plain(syms, indexes, row_n, cdfs, w_cap), False
    if indexes.shape != syms.shape or row_n.shape != (T,):
        raise ValueError(f'{entry}: bad indexes/row_n shape')
    B = syms.shape[0] if multi else 1
    w_cap = T * N if w_cap is None else int(w_cap)
    S, L = cdfs.shape
    lib = build.library()
    pairs = torch.zeros((B, pair_capacity(w_cap)), dtype=torch.int32,
                        device=dev)
    n_words = torch.empty((B,), dtype=torch.int32, device=dev)
    states = torch.empty((B, N), dtype=torch.int32, device=dev)
    args = [syms.data_ptr(), indexes.data_ptr(), row_n.data_ptr(),
            *([B] if multi else []), T, N, cdfs.data_ptr(), S, L,
            pairs.data_ptr(), pairs.shape[1], w_cap, n_words.data_ptr(),
            states.data_ptr()]
    if not entry.endswith('_rowsync'):
        if scratch is None:
            scratch = encode_scratch(B, T, N, dev)
        args += [scratch.data_ptr(), scratch.numel()]
    build.check(getattr(lib, entry)(*args, *launch_context(dev)), entry)
    if not multi:
        pairs, n_words = pairs[0], n_words[0]
    return (pairs, n_words, states), True


def rans_encode_all(syms, indexes, row_n, cdfs, num_lanes=128, w_cap=None):
    """Encode all of an image's symbol rows (all latent blocks concatenated,
    each block starting on a fresh row).

    Args:
        syms:    (T, N) int32 in-band symbols (prepare_inband)
        indexes: (T, N) int32 scale indexes
        row_n:   (T,) active lanes per row (N except at block tails)
        cdfs:    (S, L) int32 sentinel-padded CDF rows (prepare_device_cdf)
        w_cap:   word capacity (default T*N); words past it are counted in
                 n_words but not stored
    Returns:
        (pair_buf (pair_capacity(w_cap),) int32 in the wire packing, push
         order; n_words 0-dim int32; states (1, N) int32, the decoder's
         initial states)
    """
    out, launched = _encode('rans_encode_all', syms, indexes, row_n, cdfs,
                            num_lanes, w_cap)
    rans_encode_all.launches += int(launched)
    return out


rans_encode_all.launches = 0


def rans_encode_all_rowsync(syms, indexes, row_n, cdfs, num_lanes=128,
                            w_cap=None):
    """rans_encode_all on the first encode kernel (one thread block an
    image, a block barrier a row): the byte-for-byte oracle of the encode
    in chip_smoke.py and the card tests; not on the main path, and not
    counted in rans_encode_all.launches."""
    return _encode('rans_encode_all_rowsync', syms, indexes, row_n, cdfs,
                   num_lanes, w_cap)[0]


def rans_encode_all_multi_plain(syms, indexes, row_n, cdfs, w_cap=None):
    """Plain PyTorch twin of the kernel launched with one block per image:
    `rans_encode_all_plain`'s reverse row loop vectorised over (B, N), as the
    TPU kernel stacks the B images' states; word positions are laid out per
    image after the loop. Same arguments and results as
    `rans_encode_all_multi`; runs on any device."""
    B, T, N = syms.shape
    dev = syms.device
    w_cap = T * N if w_cap is None else int(w_cap)
    cdf = cdfs.to(torch.int64)
    S, L = cdf.shape
    flat = (indexes.to(torch.int64).clamp(0, S - 1) * L
            + syms.to(torch.int64).clamp(0, L - 2))
    rn = torch.as_tensor(row_n, dtype=torch.int64, device=dev)
    active = torch.arange(N, device=dev)[None, :] < rn[:, None]    # (T, N)
    start = torch.where(active, cdf.reshape(-1)[flat], 0)         # (B, T, N)
    freq = torch.where(active, cdf.reshape(-1)[flat + 1] - start, 1)
    x = torch.full((B, N), 1 << 16, dtype=torch.int64, device=dev)
    flags, words = [], []                   # in push order of the rows
    for t in range(T - 1, -1, -1):
        act, f = active[t], freq[:, t]
        flag = act & ((x >> 16) >= f)
        flags.append(flag)
        words.append(x & MASK16)
        x = torch.where(flag, x >> 16, x)
        x = torch.where(act, ((x // f) << 16) + x % f + start[:, t], x)
    # push order per image: rows T-1 .. 0, lanes descending inside each row
    pf = torch.stack(flags, 1).flip(2).reshape(B, -1)
    pw = torch.stack(words, 1).flip(2).reshape(B, -1)
    pos = torch.cumsum(pf.to(torch.int64), 1) - 1
    keep = pf & (pos < w_cap)
    P = pair_capacity(w_cap)
    buf = torch.zeros((B, 2 * P + 1), dtype=torch.int64, device=dev)
    buf.scatter_(1, torch.where(keep, pos, 2 * P), torch.where(keep, pw, 0))
    pairs = to_i32_bits(buf[:, 0:2 * P:2] | (buf[:, 1:2 * P:2] << 16))
    n_words = pf.sum(1).to(torch.int32)
    return pairs, n_words, to_i32_bits(x)


def rans_encode_all_multi(syms, indexes, row_n, cdfs, num_lanes=128,
                          w_cap=None):
    """Encode B same-layout images' symbol rows in one call (the encode's
    launches run over all B images); byte-identical to B `rans_encode_all`
    calls.

    Args:
        syms:    (B, T, N) int32 in-band symbols (prepare_inband)
        indexes: (B, T, N) int32 scale indexes
        row_n:   (T,) active lanes per row, shared by the images
        cdfs, w_cap: as for `rans_encode_all`
    Returns:
        (pairs (B, pair_capacity(w_cap)) int32, image b's pairs in row b;
         n_words (B,) int32; states (B, N) int32)
    """
    out, launched = _encode('rans_encode_all_multi', syms, indexes, row_n,
                            cdfs, num_lanes, w_cap)
    rans_encode_all_multi.launches += int(launched)
    return out


rans_encode_all_multi.launches = 0


def rans_encode_all_multi_rowsync(syms, indexes, row_n, cdfs, num_lanes=128,
                                  w_cap=None):
    """rans_encode_all_multi on the row-sync oracle kernel (as
    rans_encode_all_rowsync); not counted."""
    return _encode('rans_encode_all_multi_rowsync', syms, indexes, row_n,
                   cdfs, num_lanes, w_cap)[0]


def encode_scratch(B, T, N, dev):
    """The scratch of one encode call of B images' (T, N) rows on card
    `dev`: every symbol's (start, freq), the ballots, the rows' first
    positions and the dense words (csrc/rans.cu EncodeScratch)."""
    return torch.empty(build.library().rans_encode_scratch_bytes(B, T, N),
                       dtype=torch.uint8, device=dev)


def chain_phase(syms, indexes, row_n, cdfs, registers_only=False):
    """For the card checks' timings: runs one uncounted multi-image
    encode of (B, T, N) card tensors into a scratch kept here, and returns
    a function that reruns the encode's chain phase alone on it (-> the
    states); with registers_only, the chain's bound: its rows on values
    already in registers (csrc/rans.cu rans_encode_chain_kernel)."""
    B, T, N = syms.shape
    dev = syms.device
    scratch = encode_scratch(B, T, N, dev)
    _, _, states = _encode('rans_encode_all_multi', syms, indexes, row_n,
                           cdfs, N, None, scratch)[0]
    lib = build.library()

    def run():
        build.check(lib.rans_encode_chain_multi(
            B, T, N, scratch.data_ptr(), scratch.numel(),
            states.data_ptr(), int(registers_only), *launch_context(dev)),
            'rans_encode_chain_multi')
        return states
    return run
