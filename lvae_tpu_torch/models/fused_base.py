"""Payload layout, escape handling and stream parsing of the fused codec:
the single-image parts of ``lvae_tpu/models/fused_base.py``.

Wire format of the fused payload (little-endian), identical to the JAX
package's:
    [I n_words][I n_esc][H num_lanes]
    [compact lane states (utils/coding.pack_states)]
    [escape varints (utils/coding.pack_escapes) x n_esc][words u16 x n_words]

On the device, the encode side builds one int32 payload
    [n_words, n_esc, N][N states][pair buffer][escape (pos, val) pairs]
with the escape pairs written right after the words, so that the host
pulls header, words and escapes in one device-to-host copy.
"""
import struct

import numpy as np
import torch

from lvae_tpu_torch.ops import rans_decode as rd
from lvae_tpu_torch.ops import rans_encode as re_
from lvae_tpu_torch.utils import coding


def _extract_escapes_scatter(esc_mask, values, esc_cap):
    """Escape compaction by a scatter over the whole symbol range (any
    escape density); escapes past esc_cap are dropped."""
    mask_i = esc_mask.to(torch.int64)
    rank = torch.cumsum(mask_i, 0) - 1
    slot = torch.where(esc_mask & (rank < esc_cap), rank, esc_cap)
    pos_iota = torch.arange(values.shape[0], device=values.device)
    esc_pos = torch.full((esc_cap + 1,), -1, dtype=torch.int64,
                         device=values.device)
    esc_pos = esc_pos.scatter_(0, slot, pos_iota)[:esc_cap]
    esc_val = torch.where(esc_pos >= 0, values[esc_pos.clamp(min=0)], 0)
    return esc_pos.to(torch.int32), esc_val.to(torch.int32)


class FusedCodecBase:
    """Family-independent half of a fused codec; subclasses provide the
    encode and decode trunks."""

    # a portable codec's trunk runs in the kernels of ops/trunk.py and its
    # streams carry the marker bit (decode in any process); a legacy one's
    # runs library convolutions (streams decode in the writing process only)
    portable = False

    def __init__(self, net, cdf_table, num_lanes=128, esc_cap=8192,
                 word_cap=None, device=None):
        self.net = net
        self.device = (torch.device(device) if device is not None
                       else net.bias.device)
        self._check_table(cdf_table)
        cdfs_np, offs_np = rd.prepare_device_cdf(cdf_table)
        self.cdfs = torch.as_tensor(cdfs_np, device=self.device)
        self.offsets = torch.as_tensor(offs_np, device=self.device)
        self.lengths = torch.as_tensor(cdf_table.cdf_lengths.astype(np.int32),
                                       device=self.device)
        self.N = int(num_lanes)
        self.esc_cap = int(esc_cap)
        # optional cap on the coded stream length in 16-bit words: every
        # word buffer shrinks to it, and a stream that overflows it raises
        # OverflowError at assembly (n_words is always counted exactly)
        self.word_cap = int(word_cap) if word_cap is not None else None
        self._row_n = {}

    @staticmethod
    def _check_table(cdf_table):
        # the kernels assume 16-bit freqs and 15-bit offsets/lengths
        raw = cdf_table.cdfs.astype(np.int64)
        for r, ln in zip(raw, cdf_table.cdf_lengths):
            d = np.diff(r[:ln])
            if not ((d >= 1).all() and (d <= 0xFFFF).all()):
                raise ValueError('CDF row with zero-mass or >16-bit bin')
        if (np.abs(cdf_table.offsets).max() >= (1 << 15)
                or cdf_table.cdf_lengths.max() >= (1 << 15)):
            raise ValueError('CDF offsets/lengths must fit 15 bits')

    # ---- encode side ---------------------------------------------------

    def pack_payload(self, syms_flat, idx_flat):
        """Escapes, row layout, the rANS encode kernel and the payload.
        syms_flat/idx_flat: flat int32 tensors, one per latent block in
        decode order (NHWC symbol order)."""
        N, esc_cap, dev = self.N, self.esc_cap, self.device
        values = torch.cat(syms_flat)
        idx_all = torch.cat(idx_flat)
        inband, esc_mask = re_.prepare_inband(values, idx_all, self.offsets,
                                              self.lengths)
        n_esc_true = esc_mask.sum()
        esc_pos, esc_val = _extract_escapes_scatter(esc_mask, values, esc_cap)

        # each block starts on a fresh row of N lanes
        sizes = tuple(v.shape[0] for v in syms_flat)
        sym_rows, idx_rows = [], []
        off = 0
        for s in sizes:
            pad = max((s + N - 1) // N, 1) * N - s
            sym_rows.append(torch.nn.functional.pad(
                inband[off:off + s], (0, pad)).reshape(-1, N))
            idx_rows.append(torch.nn.functional.pad(
                idx_all[off:off + s], (0, pad)).reshape(-1, N))
            off += s
        sym_cat = torch.cat(sym_rows)
        w_cap = (min(self.word_cap, sym_cat.shape[0] * N)
                 if self.word_cap is not None else None)
        packed, n_words, states = re_.rans_encode_all(
            sym_cat, torch.cat(idx_rows), self._rows_per_block(sizes),
            self.cdfs, num_lanes=N, w_cap=w_cap)
        head = torch.cat([
            torch.stack([n_words, n_esc_true.to(torch.int32),
                         n_words.new_full((), N)]),
            states.reshape(-1)])
        esc_pairs = torch.stack([esc_pos, esc_val], dim=1).reshape(-1)
        # escape pairs go right after the words ((n_words+1)//2 pairs), the
        # offset clamped so the pairs fit, as a dynamic update slice does
        body = torch.cat([packed, torch.zeros_like(esc_pairs)])
        start = torch.clamp((n_words.to(torch.int64) + 1) // 2,
                            max=body.numel() - esc_pairs.numel())
        body.scatter_(0, start + torch.arange(esc_pairs.numel(), device=dev),
                      esc_pairs)
        return torch.cat([head, body])

    def _rows_per_block(self, sizes):
        """Active lanes of each row (N except at block tails), kept on the
        device per block layout."""
        rn = self._row_n.get(sizes)
        if rn is None:
            N = self.N
            rows = [np.full(max((s + N - 1) // N, 1), N, np.int32)
                    for s in sizes]
            for r, s in zip(rows, sizes):
                r[-1] = s - (r.size - 1) * N
            rn = torch.as_tensor(np.concatenate(rows), device=self.device)
            self._row_n[sizes] = rn
        return rn

    def _assemble_body(self, pulled):
        """One image's wire-format body from its pulled int32 payload.
        Returns (bytes, n_words, n_esc)."""
        N, esc_cap = self.N, self.esc_cap
        head_len = 3 + N
        n_words = int(pulled[0])
        n_esc = int(pulled[1])
        if n_esc > esc_cap:
            raise OverflowError(
                f'{n_esc} escapes exceed the fused-codec capacity {esc_cap}; '
                f'raise esc_cap (compress_mode) or use coder="host"')
        if self.word_cap is not None and n_words > self.word_cap:
            raise OverflowError(
                f'{n_words} coded words exceed the fused-codec capacity '
                f'{self.word_cap}; raise word_cap (compress_mode) or leave '
                f'it unset for the worst-case buffers')
        half = (n_words + 1) // 2
        states_u32 = pulled[3:3 + N].copy().view('<u4')
        packed = np.ascontiguousarray(pulled[head_len:head_len + half])
        words16 = packed.view('<u2')[:n_words][::-1]  # push order -> stream
        esc_pairs = pulled[head_len + half:head_len + half + 2 * n_esc]
        # the lane-count field's high bit marks a portable-trunk stream: its
        # floats differ in low bits from the legacy trunk's, so the two kinds
        # are never decoded by each other's codec
        lanes_field = N | (0x8000 if self.portable else 0)
        out = struct.pack('<IIH', n_words, n_esc, lanes_field)
        out += coding.pack_states(states_u32)
        esc_pairs = esc_pairs.astype(np.int64)
        out += coding.pack_escapes(esc_pairs[0::2], esc_pairs[1::2])
        out += words16.astype('<u2').tobytes()
        return out, n_words, n_esc

    def _payload_to_bytes(self, payload):
        """Pull the whole payload (one device-to-host copy) and assemble
        the body."""
        return self._assemble_body(payload.cpu().numpy())[0]

    # ---- decode side ---------------------------------------------------

    def parse_payload(self, body: bytes):
        """-> (states (1,N), words (n_words,) in stream order, esc_pos
        (n_esc,), esc_val (n_esc,)), all int32 numpy."""
        N = self.N
        n_words, n_esc, lanes_field = struct.unpack('<IIH', body[:10])
        portable = bool(lanes_field & 0x8000)
        lanes = lanes_field & 0x7FFF
        if portable != self.portable:
            raise ValueError(
                f'stream trunk kind ({"portable" if portable else "legacy"}) '
                f'!= codec ({"portable" if self.portable else "legacy"}); '
                f'use compress_mode(portable={portable})')
        if lanes != N:
            raise ValueError(f'stream lanes {lanes} != configured {N}')
        off = 10
        states, consumed = coding.unpack_states(body[off:], N)
        off += consumed
        e_pos, e_val, consumed = coding.unpack_escapes(body[off:], n_esc)
        off += consumed
        words = np.frombuffer(body[off:off + 2 * n_words], '<u2')
        if words.size != n_words:
            raise ValueError('truncated stream')
        return (states.view(np.int32).reshape(1, N).copy(),
                words.astype(np.int32), e_pos.astype(np.int32),
                e_val.astype(np.int32))

    def decode_to_device(self, body: bytes, nH, nW, *extra):
        """Parse the body, push states, words and escapes to the device as
        one int32 blob, and run the decode trunk. Returns the image on the
        device (asynchronous)."""
        states, words, esc_pos, esc_val = self.parse_payload(body)
        N, nw, ne = self.N, words.size, esc_pos.size
        blob = torch.from_numpy(np.concatenate(
            [states.ravel(), words, esc_pos, esc_val])).to(self.device)
        return self._decode(blob[:N].reshape(1, N), blob[N:N + nw],
                            blob[N + nw:N + nw + ne], blob[N + nw + ne:],
                            nH, nW, *extra)
