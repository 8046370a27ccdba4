"""The staged coders' streams: coder='host' (per-block native rANS on the
host) and coder='device' (one N-lane interleaved stream, encoded on the
host and decoded on the card), the JAX package's two coders besides the
fused one (lvae_tpu/models/qarv/model.py:846-939, 1025-1136;
qresvae/model.py:660-847).

Both run the legacy fused codec's trunk (FusedCodecBase.encode_blocks,
decode_blocks, _decode) with the symbols coded here, so
that the host, device and legacy-fused reconstructions agree bitwise within
one process. Like legacy fused streams, their streams carry no trunk marker
and decode in the process, and at the batch size, that wrote them.

Host coder body (QARV):  pack_byte_strings([one string a latent block]),
each string the per-block coder's (ops/rans_numpy.py layout).
Device coder payload:
    [<IIH n_words, n_escapes, N][N x <u4 lane states][n_words x <u2 words]
    [escape varints (utils/coding.pack_escapes) x n_escapes]
with the escapes' positions counted across the blocks of the image. It is
not the fused payload, whose states are compact and whose escapes precede
the words.
"""
import struct

import numpy as np

from lvae_tpu_torch.ops import crans
from lvae_tpu_torch.utils import coding


def interleaved_payload(syms, idx, table, num_lanes):
    """One image's device-coder payload from its per-block flat symbols and
    indexes (decode order), by the native N-lane encoder."""
    states, words, escapes = crans.interleaved_encode(
        np.concatenate(syms), np.concatenate(idx), [s.size for s in syms],
        table, num_lanes=num_lanes)
    return (struct.pack('<IIH', words.size, len(escapes), num_lanes)
            + states.astype('<u4').tobytes() + words.astype('<u2').tobytes()
            + coding.pack_escapes(escapes[:, 0], escapes[:, 1]))


def parse_interleaved(payload, num_lanes):
    """A device-coder payload -> (states (1, N), words (n_words,), esc_pos,
    esc_val), int32 numpy; the escape table padded with (-1, 0) to a power
    of two of at least 8, as the JAX package pads it
    (lvae_tpu/models/qarv/model.py:1100-1107)."""
    n_words, n_esc, lanes = struct.unpack('<IIH', payload[:10])
    if lanes != num_lanes:
        raise ValueError(f'stream lanes {lanes} != configured {num_lanes}')
    off = 10
    states = np.frombuffer(payload[off:off + 4 * lanes], '<u4')
    off += 4 * lanes
    words = np.frombuffer(payload[off:off + 2 * n_words], '<u2')
    off += 2 * n_words
    if states.size != lanes or words.size != n_words:
        raise ValueError('truncated stream')
    e_pos, e_val, _ = coding.unpack_escapes(payload[off:], n_esc)
    kpad = max(8, 1 << int(n_esc - 1).bit_length()) if n_esc else 0
    esc_pos = np.full(kpad, -1, np.int32)
    esc_val = np.zeros(kpad, np.int32)
    esc_pos[:n_esc] = e_pos
    esc_val[:n_esc] = e_val
    return (states.view(np.int32).reshape(1, lanes).copy(),
            words.astype(np.int32), esc_pos, esc_val)


def decode_host(codec, coder, blocks, B, nH, nW, *ctx, want_image=True):
    """The host coder's decode: the legacy fused codec's decode trunk
    (FusedCodecBase.decode_blocks) with each latent block's symbols decoded
    on the host by coder (entropy_coding.DiscretizedGaussian). blocks: one
    entry a latent block, each B strings, one an image. -> decode_blocks's
    (the trunk's last feature, its context, the image or None)."""
    blocks = iter(blocks)

    def symbols_of(idx):
        strings = next(blocks, None)
        if strings is None:
            raise ValueError('stream holds fewer blocks than the model')
        return np.stack([coder.decompress_symbols(strings[b], idx[b])
                         for b in range(B)])
    out = codec.decode_blocks(symbols_of, B, nH, nW, *ctx,
                              want_image=want_image)
    if next(blocks, None) is not None:
        raise ValueError('stream holds more blocks than the model')
    return out


def decode_device(codec, payload, nH, nW, *ctx):
    """The device coder's payload -> (1, H, W, 3) float16 image on the
    device: the legacy fused codec's decode (FusedCodecBase._decode), one
    launch of the rANS decode kernel a latent block, the lane states and
    the word pointer carried across the blocks."""
    parsed = parse_interleaved(payload, codec.N)
    return codec._decode(*codec._push_parsed([parsed]), nH, nW, *ctx)
