"""The family-independent half of the fused codec, for single images and
batches (``lvae_tpu/models/fused_base.py``): the trunk loop that both
directions run, payload layout, escape handling and stream parsing.

Bit-exactness: an arithmetic-coded stream desyncs when the decoder's
recomputed prior floats differ from the encoder's by a single scale-index
flip. Both directions therefore run ONE trunk function (`_trunk`) and differ
only in where the integer symbols come from: the rounded posterior on
encode, the rANS decode kernel on decode. A model family fills the trunk's
stages (`_context`, `_prior`, `_fuse`, `_plain`, and on encode `_backbone`
and `_posterior`), on one of two trunks:

* legacy (the family's codec class): the modules' cuDNN convolutions and
  cuBLAS products, NCHW, in exact float32 whatever the process's flags
  (`base.exact_f32`); a legacy stream decodes bit-exactly in the process
  (and on the card type) that wrote it.
* portable (`PortableTrunk` mixed into the family's codec): every float
  between the integer junctions comes from the hand-written kernels of
  ``ops/trunk.py``, on NHWC features as the JAX kernels take them; outside
  them only data movement (pad, reshape, pixel shuffle, concatenation). The
  kernels' results depend on nothing but their inputs, so a portable stream
  decodes in any process: it is the file format.

On both trunks the encoder backbone and the posterior stay library
convolutions (NCHW), because their outputs only choose which symbols are
written (lvae_tpu/models/qarv/fused.py:36-41). With compute_dtype
('bfloat16') the backbone alone runs in that dtype, on a cast copy of its
blocks (`backbone_blocks`), and hands each feature on as float32.

A lossless pixel head (QRes's GaussianNLL head, given by `head_cdf_table`)
is coded as one more block after the latent ones, in the same stream
(lvae_tpu/models/fused_base.py:117-145, qresvae/fused.py:1-16): the whole
decoder chain is trunk, and the head's means and scale indexes (the
family's `_head_tensors`) are trunk floats too. Its H*W*3 symbols come from
the image on encode (`_head_symbols`) and from one more rANS decode launch
on decode, and the image is `_head_recon` of them: exact uint8 pixels. The
encode kernel takes one table, so the head's CDF rows follow the latent
rows in the encode-side table (head indexes biased by `head_index_base`);
the decode kernel gets the head's own table and unbiased indexes.

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
import contextlib
import copy
import struct

import numpy as np
import torch
import torch.nn.functional as F

from lvae_tpu_torch.models import common
from lvae_tpu_torch.models.base import exact_f32, host_image, torch_dtype
from lvae_tpu_torch.ops import rans_decode as rd
from lvae_tpu_torch.ops import rans_encode as re_
from lvae_tpu_torch.ops import trunk
from lvae_tpu_torch.ops.trunk import pixel_shuffle_nhwc
from lvae_tpu_torch.utils import coding, trace


def patch_escapes(z, esc_pos, esc_val, start):
    """Write the true values of escape-coded positions into one block's
    symbols, per image: z (B, n), esc_pos/esc_val (B, E) in the image's
    symbol numbering, which starts the block at `start`. Out-of-block and
    padding (-1) entries go to a spare slot past the end, which is
    dropped."""
    n = z.shape[1]
    rel = esc_pos.to(torch.int64) - start
    valid = (rel >= 0) & (rel < n) & (esc_pos >= 0)
    out = torch.cat([z, z.new_zeros(z.shape[0], 1)], 1)
    out.scatter_(1, torch.where(valid, rel, n), esc_val.to(z.dtype))
    return out[:, :n]


_PERMS = {('NCHW', 'NHWC'): (0, 2, 3, 1), ('NHWC', 'NCHW'): (0, 3, 1, 2),
          ('NCHW', 'NCHW'): (0, 1, 2, 3), ('NHWC', 'NHWC'): (0, 1, 2, 3)}


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
    """Family-independent half of a fused codec on the legacy trunk. A
    family's subclass provides the trunk's stages and sets `stop` (the
    blocks before it run in both directions) and `tail_start` (the first
    block of the synthesis tail, which only decode and the self-check run).

    The per-image context `ctx` of the entry points (QARV: the lambdas;
    QRes: none) is a tuple of (B, ...) tensors, cut with the batch into
    chunks; `_context(*ctx)` turns it into the trunk's context, which every
    stage receives."""

    # a portable codec's trunk runs in the kernels of ops/trunk.py and its
    # streams carry the marker bit (decode in any process); a legacy one's
    # runs library convolutions (streams decode in the writing process only)
    portable = False
    # a family whose every block has a portable kernel sets this True:
    # compress_file then writes portable streams unless told otherwise
    supports_portable = False
    layout = 'NCHW'                      # of the trunk's features
    # Precision policy around the whole trunk (the JAX package's "encode
    # and decode agree on every trunk float" invariant, held within one
    # process): the legacy trunk is all library calls, so it runs in exact
    # float32 - no TF32 in convolutions (cuDNN's default) or matmuls - with
    # deterministic cuDNN algorithms chosen by shape alone, whatever the
    # process's flags. GELU is the exact erf form.
    trunk_scope = staticmethod(exact_f32)

    def __init__(self, net, cdf_table, num_lanes=128, esc_cap=8192,
                 word_cap=None, max_program_batch=None, device=None,
                 head_cdf_table=None, compute_dtype=None):
        self.net = net
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
        self._backbone_copy = (None, None)         # (source key, blocks)
        self.device = (torch.device(device) if device is not None
                       else net.bias.device)
        self._check_table(cdf_table)
        cdfs_np, offs_np = rd.prepare_device_cdf(cdf_table)
        lengths_np = cdf_table.cdf_lengths.astype(np.int32)
        dev = self.device
        self.cdfs = torch.as_tensor(cdfs_np, device=dev)
        self.offsets = torch.as_tensor(offs_np, device=dev)
        self.head_index_base = None
        if head_cdf_table is not None:
            # the encode side codes all blocks against one table: the head's
            # rows after the latent rows, both padded to one row length
            self._check_table(head_cdf_table)
            h_np, h_offs = rd.prepare_device_cdf(head_cdf_table)
            L = max(cdfs_np.shape[1], h_np.shape[1])

            def pad(a):
                return np.pad(a, ((0, 0), (0, L - a.shape[1])),
                              constant_values=rd._SENTINEL)
            self.head_index_base = cdfs_np.shape[0]
            self.head_cdfs = torch.as_tensor(h_np, device=dev)
            self.head_offsets = torch.as_tensor(h_offs, device=dev)
            cdfs_np = np.concatenate([pad(cdfs_np), pad(h_np)])
            offs_np = np.concatenate([offs_np, h_offs])
            lengths_np = np.concatenate(
                [lengths_np, head_cdf_table.cdf_lengths.astype(np.int32)])
        self.enc_cdfs = torch.as_tensor(cdfs_np, device=dev)
        self.enc_offsets = torch.as_tensor(offs_np, device=dev)
        self.enc_lengths = torch.as_tensor(lengths_np, device=dev)
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

    def backbone_blocks(self):
        """The encoder blocks in compute_dtype: a copy cast once, and cast
        again only when a weight of the net's blocks has changed since (a
        load_state_dict or an optimizer step bumps its version)."""
        src = self.net.enc_blocks
        key = tuple((p.data_ptr(), p._version) for p in src.parameters())
        if self._backbone_copy[0] != key:
            blocks = copy.deepcopy(src).to(self.compute_dtype)
            self._backbone_copy = (key, blocks.requires_grad_(False))
        return self._backbone_copy[1]

    def _to(self, t, layout):
        """A feature of this trunk -> a view in `layout`."""
        return t.permute(_PERMS[self.layout, layout])

    def _from(self, t, layout):
        """A tensor in `layout` -> this trunk's layout, contiguous."""
        return t.permute(_PERMS[layout, self.layout]).contiguous()

    # ---- the trunk (legacy stages; a family adds _context, _prior, _fuse,
    # _plain, _backbone and _posterior) ----------------------------------

    def _start(self, B, nH, nW):
        return self.net.bias.expand(B, -1, nH, nW)           # NCHW

    def _finish(self, feature):
        """-> (B, H, W, 3) float16 in [0, 1], NHWC."""
        im = torch.clamp(feature.float(), -1.0, 1.0) * 0.5 + 0.5
        return im.to(torch.float16).permute(0, 2, 3, 1)

    def _trunk(self, ctx, B, nH, nW, symbols_for):
        """The trunk's context, then per latent block prior -> symbols ->
        fuse, with the plain blocks in between, up to `stop`.
        symbols_for(block, f_mid, pm, indexes, tctx) -> symbols in this
        trunk's layout. Returns (feature, tctx, symbols, indexes), the last
        two per block as (B, nsym) int32 tensors in NHWC order."""
        tctx = self._context(*ctx)
        feature = self._start(B, nH, nW)
        syms_flat, idx_flat = [], []
        for blk in list(self.net.dec_blocks)[:self.stop]:
            if getattr(blk, 'is_latent_block', False):
                f_mid, pm, indexes = self._prior(blk, feature, *tctx)
                # canonical layout: both directions feed the fuse the same
                # contiguous int32 tensor
                syms = symbols_for(blk, f_mid, pm, indexes,
                                   tctx).to(torch.int32).contiguous()
                feature = self._fuse(blk, f_mid, pm, syms, *tctx)
                syms_flat.append(self._to(syms, 'NHWC').reshape(B, -1))
                idx_flat.append(self._to(indexes, 'NHWC').reshape(B, -1))
            else:
                feature = self._plain(blk, feature, *tctx)
        return feature, tctx, syms_flat, idx_flat

    def _tail(self, feature, tctx):
        for blk in list(self.net.dec_blocks)[self.tail_start:]:
            feature = self._plain(blk, feature, *tctx)
        return self._finish(feature)

    # ---- the two directions -------------------------------------------

    def _posterior_symbols(self, im):
        """The encode side's symbols_for: the rounded posterior mean minus
        the prior mean, the encoder backbone run (on the trunk's context)
        at the first latent block. -> (symbols_for, the encoder features,
        filled by then)."""
        enc_features = {}

        def posterior_symbols(blk, f_mid, pm, indexes, tctx):
            with exact_f32():
                if not enc_features:   # the backbone, on the trunk's context
                    enc_features.update(self._backbone(im, *tctx))
                qm = self._posterior(blk, self._to(f_mid, 'NCHW'),
                                     enc_features, *tctx)
            qm = self._from(qm, 'NCHW')
            return torch.round(qm.float() - pm.float())
        return posterior_symbols, enc_features

    @torch.no_grad()
    def _encode(self, im, *ctx, want_image, batch=False):
        """im: (B, 3, H, W) float32 on the device, ctx: the per-image
        context -> (payload, image|None); a single image's payload (P,)
        from the single-image rANS kernel, a batch's (B, P) from the
        multi-image one."""
        B, _, imH, imW = im.shape
        ms = self.net.max_stride
        posterior_symbols, _ = self._posterior_symbols(im)
        with trace.span('enc.trunk'), self.trunk_scope():
            feature, tctx, syms_flat, idx_flat = self._trunk(
                ctx, B, imH // ms, imW // ms, posterior_symbols)
            if self.head_index_base is None:
                image = self._tail(feature, tctx) if want_image else None
            else:                              # the lossless head's block
                pm, idx = self._head_tensors(feature)
                xs = self._head_symbols(im, pm)
                syms_flat.append(xs.reshape(B, -1))
                idx_flat.append((idx + self.head_index_base).reshape(B, -1))
                image = self._head_recon(xs, pm) if want_image else None
        if batch:
            return self.pack_payload_batch(syms_flat, idx_flat), image
        return self.pack_payload([s[0] for s in syms_flat],
                                 [i[0] for i in idx_flat]), image

    def encode(self, im, *ctx):
        payload, _ = self._encode(im, *ctx, want_image=False)
        return self._payload_to_bytes(payload)

    def encode_check(self, im, *ctx):
        """encode() that also returns the image reconstructed from the
        encode-side symbols (NHWC float16 on the device)."""
        payload, img = self._encode(im, *ctx, want_image=True)
        return self._payload_to_bytes(payload), img

    @torch.no_grad()
    def _decode(self, states, streams, esc_pos, esc_val, nH, nW, *ctx,
                batch=False):
        """states (B, N), streams (B, W), esc_pos/esc_val (B, E) and the
        per-image context on the device -> (B, H, W, 3) images: float16, or
        uint8 from a lossless head. A single image (batch=False, B = 1)
        decodes through the single-image rANS kernel, a batch through one
        multi-image launch per block."""
        N = self.N
        B = states.shape[0]
        ptr = torch.zeros((B,) if batch else (), dtype=torch.int32,
                          device=self.device)
        carry = {'states': states, 'ptr': ptr, 'start': 0}

        def decode_block(flat_idx, cdfs, offsets):
            """The next block's symbols (B, nsym), its escapes patched in,
            from its indexes (B, nsym) against the table (cdfs, offsets)."""
            nsym = flat_idx.shape[1]
            T = max((nsym + N - 1) // N, 1)
            idx_rows = F.pad(flat_idx, (0, T * N - nsym)).reshape(B, T, N)
            with trace.span('dec.rans'):
                if batch:
                    vals, carry['states'], carry['ptr'] = (
                        rd.rans_decode_block_multi(
                            idx_rows, carry['states'], carry['ptr'], streams,
                            cdfs, offsets, nsym, num_lanes=N))
                else:
                    vals, carry['states'], carry['ptr'] = (
                        rd.rans_decode_block(
                            idx_rows[0], carry['states'], carry['ptr'],
                            streams[0], cdfs, offsets, nsym, num_lanes=N))
                z = patch_escapes(vals.reshape(B, -1)[:, :nsym], esc_pos,
                                  esc_val, carry['start'])
            carry['start'] += nsym
            return z

        def decoded_symbols(blk, f_mid, pm, indexes, tctx):
            shape = self._to(pm, 'NHWC').shape
            z = decode_block(self._to(indexes, 'NHWC').reshape(B, -1),
                             self.cdfs, self.offsets)
            return self._from(z.reshape(shape), 'NHWC')

        with trace.span('dec.trunk'), self.trunk_scope():
            feature, tctx, _, _ = self._trunk(ctx, B, nH, nW,
                                              decoded_symbols)
            if self.head_index_base is None:
                return self._tail(feature, tctx)
            pm, idx = self._head_tensors(feature)      # the lossless head
            xs = decode_block(idx.reshape(B, -1), self.head_cdfs,
                              self.head_offsets)
            return self._head_recon(xs.reshape(pm.shape), pm)

    # ---- encode side ---------------------------------------------------

    def pack_payload(self, syms_flat, idx_flat):
        """Escapes, row layout, the rANS encode kernel and the payload.
        syms_flat/idx_flat: flat int32 tensors, one per latent block in
        decode order (NHWC symbol order)."""
        with trace.span('enc.pack'):
            N, esc_cap = self.N, self.esc_cap
            values = torch.cat(syms_flat)
            idx_all = torch.cat(idx_flat)
            inband, esc_mask = re_.prepare_inband(values, idx_all,
                                                  self.enc_offsets,
                                                  self.enc_lengths)
            n_esc_true = esc_mask.sum()
            esc_pos, esc_val = _extract_escapes_scatter(esc_mask, values,
                                                        esc_cap)

            sym_cat, idx_cat, row_n, w_cap = self._row_layout(
                inband[None], idx_all[None], [v.shape[0] for v in syms_flat])
            packed, n_words, states = re_.rans_encode_all(
                sym_cat[0], idx_cat[0], row_n, self.enc_cdfs, num_lanes=N,
                w_cap=w_cap)
            head = torch.cat([
                torch.stack([n_words, n_esc_true.to(torch.int32),
                             n_words.new_full((), N)]),
                states.reshape(-1)])
            esc_pairs = torch.stack([esc_pos, esc_val], dim=1).reshape(-1)
            return torch.cat([head,
                              _place_escapes(packed, n_words, esc_pairs)])

    def pack_payload_batch(self, syms_flat, idx_flat):
        """pack_payload for B same-shape images in one pass: the escape
        compaction and row layout over (B, ...), one multi-image rANS encode
        launch. syms_flat/idx_flat: (B, nsym) int32 tensors, one per latent
        block in decode order. Returns (B, P) payload rows, row b equal to
        pack_payload on image b's symbols alone."""
        with trace.span('enc.pack'):
            N, esc_cap = self.N, self.esc_cap
            values = torch.cat(syms_flat, 1)                    # (B, total)
            idx_all = torch.cat(idx_flat, 1)
            B = values.shape[0]
            inband, esc_mask = re_.prepare_inband(values, idx_all,
                                                  self.enc_offsets,
                                                  self.enc_lengths)
            n_esc_true = esc_mask.sum(1)
            esc_pos, esc_val = _extract_escapes_scatter(esc_mask, values,
                                                        esc_cap)
            sym_cat, idx_cat, row_n, w_cap = self._row_layout(
                inband, idx_all, [v.shape[1] for v in syms_flat])
            packed, n_words, states = re_.rans_encode_all_multi(
                sym_cat, idx_cat, row_n, self.enc_cdfs, num_lanes=N,
                w_cap=w_cap)
            head = torch.cat([
                torch.stack([n_words, n_esc_true.to(torch.int32),
                             torch.full_like(n_words, N)], 1),
                states], 1)
            esc_pairs = torch.stack([esc_pos, esc_val], dim=2).reshape(B, -1)
            return torch.cat(
                [head, _place_escapes(packed, n_words, esc_pairs)], 1)

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

    def encode_batch(self, ims, *ctx):
        """B same-shape images (NCHW float32 on the device) and their
        context -> list of B single-image wire-format bodies."""
        return self.encode_batch_finish(self.encode_batch_async(ims, *ctx))

    def encode_batch_async(self, ims, *ctx):
        """Dispatch-only half of encode_batch: queues every chunk's encode
        and the device-to-host copy of its payload into pinned memory, and
        returns a handle without synchronising the host. A serving loop
        dispatches batch k+1 before finishing batch k, so the copy and the
        stream assembly of one batch overlap the next one's compute."""
        handles = []
        for a, b in self._chunks(ims.shape[0]):
            payload, _ = self._encode(ims[a:b], *(c[a:b] for c in ctx),
                                      want_image=False, batch=True)
            handles.append(_pull_async(payload))
        return handles

    def encode_batch_finish(self, handle):
        """Wait for each chunk's payload copy and assemble the bodies."""
        bodies = []
        for host, done in handle:
            if done is not None:
                with trace.span('enc.pull_wait'):
                    done.synchronize()
            bodies.extend(self._assemble_body(row)[0]
                          for row in host.numpy())
        return bodies

    def encode_check_batch(self, ims, *ctx):
        """encode_batch that also returns the images reconstructed from the
        encode-side symbols ((B, H, W, 3) float32 numpy, models/base.py
        host_image), chunked exactly
        like encode_batch so that the reconstruction comes from the trunk
        runs that wrote the streams."""
        bodies, imgs = [], []
        for a, b in self._chunks(ims.shape[0]):
            payload, img = self._encode(ims[a:b], *(c[a:b] for c in ctx),
                                        want_image=True, batch=True)
            bodies += self._payloads_to_bytes(payload)
            imgs.append(host_image(img))
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
        with trace.span('dec.push'):
            return self._push_parsed([self.parse_payload(body)
                                      for body in bodies])

    def _push_parsed(self, parsed):
        """_push of streams already parsed into (states (1, N), words,
        esc_pos, esc_val) int32 numpy."""
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

    def decode_to_device(self, body: bytes, nH, nW, *ctx):
        """Parse the body, push it to the device in one blob and run the
        decode trunk (single-image kernels). Returns the (1, H, W, 3)
        image on the device (asynchronous)."""
        return self._decode(*self._push([body]), nH, nW, *ctx)

    def decode_batch_to_device(self, bodies, nH, nW, *ctx):
        """Decode B same-shape bodies, chunked as encode_batch chunks them,
        each chunk pushed in one blob and decoded by the multi-image
        kernels. Returns the (B, H, W, 3) images on the device
        (asynchronous)."""
        imgs = [self._decode(*self._push(bodies[a:b]), nH, nW,
                             *(c[a:b] for c in ctx), batch=True)
                for a, b in self._chunks(len(bodies))]
        return imgs[0] if len(imgs) == 1 else torch.cat(imgs)

    # ---- the staged coders (coder='host' and coder='device',
    # models/staged.py): this codec's trunk, with the symbols coded on the
    # host (lvae_tpu/models/qarv/model.py:846-939, 1025-1136) -------------

    @torch.no_grad()
    def encode_blocks(self, im, *ctx, want_image=False):
        """The encode trunk with the symbols pulled to the host in one copy
        (int32: no narrowing at the junction). im: (B, 3, H, W) on the
        device -> (syms, idx: per latent block (B, nsym) int32 numpy in
        NHWC order, the trunk's last feature, its context, the encoder
        features, the reconstruction (B, H, W, 3) float16 on the device
        from the tail when want_image, else None)."""
        B, _, imH, imW = im.shape
        ms = self.net.max_stride
        posterior_symbols, enc_features = self._posterior_symbols(im)
        with self.trunk_scope():
            feature, tctx, syms_flat, idx_flat = self._trunk(
                ctx, B, imH // ms, imW // ms, posterior_symbols)
            image = self._tail(feature, tctx) if want_image else None
        n = len(syms_flat)
        sizes = [t.shape[1] for t in syms_flat]
        flat = torch.cat(syms_flat + idx_flat, 1).cpu().numpy()
        parts = np.split(flat, np.cumsum(sizes + sizes)[:-1], axis=1)
        return parts[:n], parts[n:], feature, tctx, enc_features, image

    @torch.no_grad()
    def decode_blocks(self, symbols_of, B, nH, nW, *ctx, want_image=True):
        """The decode trunk of the host coder: per latent block the scale
        indexes are pulled to the host and symbols_of(indexes (B, nsym)
        int32 numpy, NHWC order) gives the block's symbols, pushed back as
        the int32 tensor the encode side fed the fuse. -> (the trunk's last
        feature, its context, the tail's (B, H, W, 3) float16 image when
        want_image, else None)."""
        def host_symbols(blk, f_mid, pm, indexes, tctx):
            idx = self._to(indexes, 'NHWC')
            syms = symbols_of(idx.reshape(B, -1).cpu().numpy())
            z = torch.from_numpy(np.ascontiguousarray(syms, np.int32))
            return self._from(z.to(self.device).reshape(idx.shape), 'NHWC')

        with self.trunk_scope():
            feature, tctx, _, _ = self._trunk(ctx, B, nH, nW, host_symbols)
            image = self._tail(feature, tctx) if want_image else None
        return feature, tctx, image


class PortableTrunk:
    """Mixed in before a family's codec class: the trunk on the kernels of
    ops/trunk.py, NHWC, with the stages every family shares (the seed, the
    resampling blocks, the tail's last conv with the pixel finish); its
    streams carry the portable marker and decode in any process."""

    portable = True
    layout = 'NHWC'
    # the kernels' results depend on no flag; only the backbone and
    # posterior (library calls) are scoped, in _encode
    trunk_scope = staticmethod(contextlib.nullcontext)

    def __init__(self, net, cdf_table, **cfg):
        super().__init__(net, cdf_table, **cfg)
        # the tail ends in the conv that upsample_finish folds the finish
        # into; the lossless head's two convs run as upsample_head
        if self.head_index_base is None:
            ups = list(net.dec_blocks)[self.tail_start:][-1:]
        else:
            ups = [net.out_net.conv_mean, net.out_net.conv_scale]
        if not ups or not all(
                isinstance(up, common.patch_upsample)
                and up.conv.out_channels == 3 * up.rate ** 2
                and up.rate == ups[0].rate
                and up.conv.in_channels == ups[0].conv.in_channels
                for up in ups):
            raise NotImplementedError(
                'portable trunk: the synthesis tail (or each conv of the '
                'lossless head) must end in a patch_upsample to 3 channels; '
                'use portable=False')

    def _start(self, B, nH, nW):
        bias = self.net.bias.reshape(1, 1, 1, -1)
        return bias.expand(B, nH, nW, -1).contiguous()

    def _plain(self, blk, feature, *tctx):
        if isinstance(blk, common.patch_upsample):
            y = trunk.conv1x1(feature, blk.conv)
            return pixel_shuffle_nhwc(y, blk.rate).contiguous()
        if isinstance(blk, common.upsample_nearest):         # data movement
            r = blk.rate
            return feature.repeat_interleave(r, 1).repeat_interleave(r, 2)
        raise NotImplementedError(
            f'portable trunk: unsupported block {type(blk).__name__}')

    def _tail(self, feature, tctx):
        """The tail's blocks but the last, then its last conv with the
        pixel finish in one launch -> (B, H, W, 3) float16."""
        *blocks, last = list(self.net.dec_blocks)[self.tail_start:]
        for blk in blocks:
            feature = self._plain(blk, feature, *tctx)
        return trunk.patch_upsample_finish(feature, last)


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
