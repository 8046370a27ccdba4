"""Payload layout, escape handling and stream parsing of the fused codec,
for single images and batches: ``lvae_tpu/models/fused_base.py``.

Wire format of the fused payload (little-endian), identical to the JAX
package's:
    [I n_words][I n_esc][H num_lanes]
    [compact lane states (utils/coding.pack_states)]
    [escape varints (utils/coding.pack_escapes) x n_esc][words u16 x n_words]

On the device, the encode side builds one int32 payload per image
    [n_words, n_esc, N][N states][pair buffer][escape (pos, val) pairs]
with the escape pairs written right after the words, so that the host
pulls header, words and escapes of a whole batch chunk in one
device-to-host copy. A batch stream is a single-image stream: each row of
a chunk's (B, P) payload holds exactly the bytes `pack_payload` gives that
image alone.
"""
import struct

import numpy as np
import torch
import torch.nn.functional as F

from lvae_tpu_torch.ops import rans_decode as rd
from lvae_tpu_torch.ops import rans_encode as re_
from lvae_tpu_torch.utils import coding


def _extract_escapes_scatter(esc_mask, values, esc_cap):
    """Escape compaction by a scatter over the whole symbol range (any
    escape density), along the last axis: each row ranked by its own
    cumsum, escapes past esc_cap dropped (into a spare column)."""
    rank = torch.cumsum(esc_mask.to(torch.int64), -1) - 1
    slot = torch.where(esc_mask & (rank < esc_cap), rank, esc_cap)
    pos_iota = torch.arange(values.shape[-1],
                            device=values.device).expand_as(slot)
    esc_pos = torch.full(values.shape[:-1] + (esc_cap + 1,), -1,
                         dtype=torch.int64, device=values.device)
    esc_pos = esc_pos.scatter_(-1, slot, pos_iota)[..., :esc_cap]
    esc_val = torch.where(esc_pos >= 0,
                          values.gather(-1, esc_pos.clamp(min=0)), 0)
    return esc_pos.to(torch.int32), esc_val.to(torch.int32)


def _place_escapes(packed, n_words, esc_pairs):
    """[pair buffer][escape pairs] with the pairs moved to right after the
    words ((n_words+1)//2 pairs), the offset clamped so that they fit, as a
    dynamic update slice does; along the last axis."""
    E = esc_pairs.shape[-1]
    body = torch.cat([packed, torch.zeros_like(esc_pairs)], -1)
    start = torch.clamp((n_words.to(torch.int64) + 1) // 2,
                        max=packed.shape[-1])
    at = start[..., None] + torch.arange(E, device=packed.device)
    return body.scatter_(-1, at, esc_pairs)


class FusedCodecBase:
    """Family-independent half of a fused codec; subclasses provide the
    encode and decode trunks."""

    # a portable codec's trunk runs in the kernels of ops/trunk.py and its
    # streams carry the marker bit (decode in any process); a legacy one's
    # runs library convolutions (streams decode in the writing process only)
    portable = False

    def __init__(self, net, cdf_table, num_lanes=128, esc_cap=8192,
                 word_cap=None, max_program_batch=None, device=None):
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
        # batch requests larger than this run as balanced chunks
        self.max_program_batch = max_program_batch
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
        N, esc_cap = self.N, self.esc_cap
        values = torch.cat(syms_flat)
        idx_all = torch.cat(idx_flat)
        inband, esc_mask = re_.prepare_inband(values, idx_all, self.offsets,
                                              self.lengths)
        n_esc_true = esc_mask.sum()
        esc_pos, esc_val = _extract_escapes_scatter(esc_mask, values, esc_cap)

        sym_cat, idx_cat, row_n, w_cap = self._row_layout(
            inband[None], idx_all[None], [v.shape[0] for v in syms_flat])
        packed, n_words, states = re_.rans_encode_all(
            sym_cat[0], idx_cat[0], row_n, self.cdfs, num_lanes=N,
            w_cap=w_cap)
        head = torch.cat([
            torch.stack([n_words, n_esc_true.to(torch.int32),
                         n_words.new_full((), N)]),
            states.reshape(-1)])
        esc_pairs = torch.stack([esc_pos, esc_val], dim=1).reshape(-1)
        return torch.cat([head, _place_escapes(packed, n_words, esc_pairs)])

    def pack_payload_batch(self, syms_flat, idx_flat):
        """pack_payload for B same-shape images in one pass: the escape
        compaction and row layout over (B, ...), one multi-image rANS encode
        launch. syms_flat/idx_flat: (B, nsym) int32 tensors, one per latent
        block in decode order. Returns (B, P) payload rows, row b equal to
        pack_payload on image b's symbols alone."""
        N, esc_cap = self.N, self.esc_cap
        values = torch.cat(syms_flat, 1)                        # (B, total)
        idx_all = torch.cat(idx_flat, 1)
        B = values.shape[0]
        inband, esc_mask = re_.prepare_inband(values, idx_all, self.offsets,
                                              self.lengths)
        n_esc_true = esc_mask.sum(1)
        esc_pos, esc_val = _extract_escapes_scatter(esc_mask, values, esc_cap)
        sym_cat, idx_cat, row_n, w_cap = self._row_layout(
            inband, idx_all, [v.shape[1] for v in syms_flat])
        packed, n_words, states = re_.rans_encode_all_multi(
            sym_cat, idx_cat, row_n, self.cdfs, num_lanes=N, w_cap=w_cap)
        head = torch.cat([
            torch.stack([n_words, n_esc_true.to(torch.int32),
                         torch.full_like(n_words, N)], 1),
            states], 1)
        esc_pairs = torch.stack([esc_pos, esc_val], dim=2).reshape(B, -1)
        return torch.cat([head, _place_escapes(packed, n_words, esc_pairs)],
                         1)

    def _row_layout(self, inband, idx_all, sizes):
        """(B, total) in-band symbols and indexes of latent blocks of
        `sizes` symbols -> (syms (B, T, N), idx (B, T, N), row_n (T,),
        w_cap): each block starts on a fresh row of N lanes."""
        N = self.N
        B = inband.shape[0]
        sizes = tuple(sizes)
        sym_rows, idx_rows = [], []
        off = 0
        for s in sizes:
            pad = max((s + N - 1) // N, 1) * N - s
            sym_rows.append(F.pad(inband[:, off:off + s], (0, pad)).reshape(
                B, -1, N))
            idx_rows.append(F.pad(idx_all[:, off:off + s], (0, pad)).reshape(
                B, -1, N))
            off += s
        sym_cat = torch.cat(sym_rows, 1)
        T = sym_cat.shape[1]
        w_cap = (min(self.word_cap, T * N) if self.word_cap is not None
                 else None)
        return (sym_cat, torch.cat(idx_rows, 1), self._rows_per_block(sizes),
                w_cap)

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
        """One image's (P,) payload -> its body."""
        return self._payloads_to_bytes(payload[None])[0]

    def _payloads_to_bytes(self, payload):
        """(B, P) payload rows -> B bodies: ONE device-to-host copy, then
        each row assembled."""
        return [self._assemble_body(row)[0] for row in payload.cpu().numpy()]

    # ---- batch serving (lvae_tpu/models/fused_base.py:477-650) ----------

    @staticmethod
    def _chunk_sizes(B, mpb):
        """Balanced chunk sizes for a B-image request under a per-chunk
        batch cap: sizes differ by at most 1 (B=8, cap 4 -> [4, 4]; B=7 ->
        [4, 3]). Deterministic in (B, cap): decode re-derives the split, so
        legacy streams decode at the batch size that wrote them."""
        if not mpb or B <= mpb:
            return [B]
        k = -(-B // mpb)
        base, rem = divmod(B, k)
        return [base + 1] * rem + [base] * (k - rem)

    def _chunks(self, B):
        """(start, stop) of each chunk of a B-image request."""
        edges = np.cumsum([0] + self._chunk_sizes(B, self.max_program_batch))
        return list(zip(edges[:-1].tolist(), edges[1:].tolist()))

    def encode_batch(self, ims, lmb):
        """B same-shape images (NCHW float32 on the device, lmb (B,)) ->
        list of B single-image wire-format bodies."""
        return self.encode_batch_finish(self.encode_batch_async(ims, lmb))

    def encode_batch_async(self, ims, lmb):
        """Dispatch-only half of encode_batch: queues every chunk's encode
        and the device-to-host copy of its payload into pinned memory, and
        returns a handle without synchronising the host. A serving loop
        dispatches batch k+1 before finishing batch k, so the copy and the
        stream assembly of one batch overlap the next one's compute."""
        handles = []
        for a, b in self._chunks(ims.shape[0]):
            payload, _ = self._encode(ims[a:b], lmb[a:b], want_image=False,
                                      batch=True)
            handles.append(_pull_async(payload))
        return handles

    def encode_batch_finish(self, handle):
        """Wait for each chunk's payload copy and assemble the bodies."""
        bodies = []
        for host, done in handle:
            if done is not None:
                done.synchronize()
            bodies.extend(self._assemble_body(row)[0]
                          for row in host.numpy())
        return bodies

    def encode_check_batch(self, ims, lmb):
        """encode_batch that also returns the images reconstructed from the
        encode-side symbols ((B, H, W, 3) float32 numpy), chunked exactly
        like encode_batch so that the reconstruction comes from the trunk
        runs that wrote the streams."""
        bodies, imgs = [], []
        for a, b in self._chunks(ims.shape[0]):
            payload, img = self._encode(ims[a:b], lmb[a:b], want_image=True,
                                        batch=True)
            bodies += self._payloads_to_bytes(payload)
            imgs.append(img.float().cpu().numpy())
        return bodies, np.concatenate(imgs)

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

    def _push(self, bodies):
        """Parse the bodies and push their states, words and escapes to the
        device as ONE int32 blob: -> (states (B, N), streams (B, W), esc_pos
        (B, E), esc_val (B, E)), streams zero-padded and escapes padded
        with (-1, 0) to the longest body's."""
        parsed = [self.parse_payload(body) for body in bodies]
        B, N = len(parsed), self.N
        W = max(1, max(p[1].size for p in parsed))
        E = max(p[2].size for p in parsed)
        states = np.concatenate([p[0] for p in parsed])
        streams = np.zeros((B, W), np.int32)
        esc = np.zeros((2, B, E), np.int32)
        esc[0] = -1
        for b, (_, words, pos, val) in enumerate(parsed):
            streams[b, :words.size] = words
            esc[0, b, :pos.size] = pos
            esc[1, b, :val.size] = val
        blob = torch.from_numpy(np.concatenate(
            [states.ravel(), streams.ravel(), esc.ravel()])).to(self.device)
        st, sw, ep, ev = torch.split(blob, [B * N, B * W, B * E, B * E])
        return (st.reshape(B, N), sw.reshape(B, W), ep.reshape(B, E),
                ev.reshape(B, E))

    def decode_to_device(self, body: bytes, nH, nW, *extra):
        """Parse the body, push it to the device in one blob and run the
        decode trunk (single-image kernels). Returns the (1, H, W, 3)
        image on the device (asynchronous)."""
        return self._decode(*self._push([body]), nH, nW, *extra)

    def decode_batch_to_device(self, bodies, nH, nW, lmb):
        """Decode B same-shape bodies, chunked as encode_batch chunks them,
        each chunk pushed in one blob and decoded by the multi-image
        kernels. Returns the (B, H, W, 3) images on the device
        (asynchronous)."""
        imgs = [self._decode(*self._push(bodies[a:b]), nH, nW, lmb[a:b],
                             batch=True)
                for a, b in self._chunks(len(bodies))]
        return imgs[0] if len(imgs) == 1 else torch.cat(imgs)


def _pull_async(payload):
    """Queue a device-to-host copy of `payload` into pinned memory: ->
    (host tensor, event to wait for, None on the CPU)."""
    if payload.device.type == 'cpu':
        return payload, None
    host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
    host.copy_(payload, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done
