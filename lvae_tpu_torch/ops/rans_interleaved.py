"""N-lane interleaved rANS in numpy, a copy of
``lvae_tpu/ops/rans_interleaved.py``: the device coder's stream, decoded
on the card by the rANS decode kernel (ops/rans_decode.py). This module is
the oracle of the native N-lane encoder (ops/crans.interleaved_encode).

Format ("rans16"):
  * PRECISION = 16-bit CDFs (the tables of ops/cdf.py)
  * 32-bit lane states in [2^16, 2^32), 16-bit word renormalization: a
    decode step reads at most one word a lane
  * symbol j of a block belongs to lane j % N (the lanes restart at 0 in
    every block); a decode step takes one row of N symbols
  * word order: row-major, lanes ascending within a row
  * escapes are out of band: the stream codes the escape bin in-band and
    the exact values go to a (global position, value) side table, patched
    in after the decode
  * the encoder runs the symbols in reverse from states 2^16; the final
    states (the decoder's initial ones) are stored in the header
  * the lane states persist across the latent blocks of one image: one
    flush an image
"""
import numpy as np

from lvae_tpu_torch.ops.cdf import CdfTable, PRECISION

RANS16_L = 1 << 16
MASK16 = (1 << 16) - 1


class InterleavedEncoder:
    """Encodes blocks of symbols (appended in DECODE order) into one N-lane
    stream. Call append_block() for each latent block in decode order, then
    finish() to get (header_states, words, escapes)."""

    def __init__(self, table: CdfTable, num_lanes: int = 128):
        self.table = table
        self.N = num_lanes
        self._blocks = []  # (values, indexes) in decode order

    def append_block(self, values, indexes):
        values = np.asarray(values, dtype=np.int64).ravel()
        indexes = np.asarray(indexes, dtype=np.int64).ravel()
        assert values.shape == indexes.shape
        self._blocks.append((values, indexes))

    def finish(self):
        """Returns (states uint32[N], words uint16[W], escapes int64[K,2])
        where escapes rows are (global_position, true_value)."""
        N = self.N
        cdfs = self.table.cdfs.astype(np.int64)
        lengths = self.table.cdf_lengths
        offsets = self.table.offsets

        # global symbol order = concatenation of blocks (decode order);
        # lane assignment restarts at 0 for every block (the kernel decodes
        # block-by-block with row-major lanes)
        if self._blocks:
            values = np.concatenate([v for v, _ in self._blocks])
            indexes = np.concatenate([ix for _, ix in self._blocks])
            lanes = np.concatenate([np.arange(v.size, dtype=np.int64) % N
                                    for v, _ in self._blocks])
        else:
            values = np.zeros(0, np.int64)
            indexes = np.zeros(0, np.int64)
            lanes = np.zeros(0, np.int64)
        n = values.size

        escapes = []
        states = np.full(N, RANS16_L, dtype=np.uint64)
        words_rev = []

        for i in range(n - 1, -1, -1):
            lane = int(lanes[i])
            idx = int(indexes[i])
            row = cdfs[idx]
            max_symbol = int(lengths[idx]) - 2
            sym = int(values[i]) - int(offsets[idx])
            if not (0 <= sym < max_symbol):
                escapes.append((i, int(values[i])))
                sym = max_symbol  # code the escape bin in-band
            start = int(row[sym])
            freq = int(row[sym + 1]) - start
            st = int(states[lane])
            if st >= (freq << 16):
                words_rev.append(st & MASK16)
                st >>= 16
            states[lane] = ((st // freq) << PRECISION) + (st % freq) + start

        words = np.array(words_rev[::-1], dtype=np.uint16)
        escapes = np.array(sorted(escapes), dtype=np.int64).reshape(-1, 2)
        return states.astype(np.uint32), words, escapes


def decode_interleaved(states, words, blocks, table: CdfTable, escapes=None,
                       num_lanes=128):
    """Numpy reference N-lane decoder (oracle of the decode kernel, csrc/rans.cu).

    blocks: list of index arrays (one per latent block, decode order).
    Returns: list of int32 value arrays (escape positions already patched).
    """
    N = num_lanes
    cdfs = table.cdfs.astype(np.int64)
    lengths = table.cdf_lengths
    offsets = table.offsets

    st = states.astype(np.uint64).copy()
    ptr = 0
    gpos = 0
    all_out = []
    for indexes in blocks:
        indexes = np.asarray(indexes, dtype=np.int64).ravel()
        out = np.empty(indexes.size, dtype=np.int64)
        for j in range(indexes.size):
            lane = j % N  # block-local lane assignment
            idx = int(indexes[j])
            row = cdfs[idx]
            s_state = int(st[lane])
            slot = s_state & MASK16
            # linear search (reference impl)
            cdf_len = int(lengths[idx])
            s = int(np.searchsorted(row[:cdf_len], slot, side='right')) - 1
            start = int(row[s])
            freq = int(row[s + 1]) - start
            s_state = freq * (s_state >> 16) + slot - start
            if s_state < RANS16_L:
                s_state = (s_state << 16) | int(words[ptr])
                ptr += 1
            st[lane] = s_state
            out[j] = s + int(offsets[idx])
        all_out.append(out)
        gpos += indexes.size
    # apply escapes (positions are global)
    if escapes is not None and len(escapes):
        sizes = np.array([np.asarray(b).size for b in blocks])
        edges = np.concatenate([[0], np.cumsum(sizes)])
        for pos, val in escapes:
            bi = int(np.searchsorted(edges, pos, side='right')) - 1
            all_out[bi][pos - edges[bi]] = val
    return [o.astype(np.int32) for o in all_out]
