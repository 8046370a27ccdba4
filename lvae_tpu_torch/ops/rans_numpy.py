"""Plain numpy per-block rANS coder in the host coder's byte layout, a copy
of ``lvae_tpu/ops/rans_numpy.py``: the plain version of the native coder
(csrc/crans.cpp, bound by ops/crans.py) and the oracle its bytes are held
to.

Format (shared with the native coder):
  * 64-bit rANS state, 32-bit little-endian word renormalization
  * PRECISION = 16-bit quantized CDFs (ops/cdf.py)
  * state invariant: RANS_L <= state < RANS_L << 32, RANS_L = 1 << 31
  * the encoder walks the symbols in reverse, the decoder forward
  * stream = [8-byte LE final state][32-bit words in decode order]
  * an out-of-range value codes its row's escape bin, then a zigzag
    nibble varint (3 payload bits + 1 continuation bit a nibble) pushed as
    raw bits
"""
import numpy as np

from lvae_tpu_torch.ops.cdf import CdfTable, PRECISION

RANS_L = 1 << 31          # renormalization lower bound
MASK = (1 << PRECISION) - 1


class _Writer:
    """Collects 32-bit words emitted back-to-front (rANS encodes in reverse)."""

    def __init__(self):
        self.words = []

    def put(self, w):
        self.words.append(w & 0xFFFFFFFF)

    def tobytes(self, state):
        # final state stored first (8 bytes LE), then words in decode order
        out = bytearray(state.to_bytes(8, 'little'))
        for w in reversed(self.words):
            out += int(w).to_bytes(4, 'little')
        return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.state = int.from_bytes(data[:8], 'little')
        self.data = data
        self.pos = 8

    def next_word(self):
        w = int.from_bytes(self.data[self.pos:self.pos + 4], 'little')
        self.pos += 4
        return w


def _enc_put(writer, state, start, freq):
    # renormalize: flush 32 bits whenever encoding would overflow the invariant
    x_max = ((RANS_L >> PRECISION) << 32) * freq
    if state >= x_max:
        writer.put(state & 0xFFFFFFFF)
        state >>= 32
    return ((state // freq) << PRECISION) + (state % freq) + start


def _enc_put_bits(writer, state, val, nbits):
    x_max = (RANS_L >> nbits) << 32
    if state >= x_max:
        writer.put(state & 0xFFFFFFFF)
        state >>= 32
    return (state << nbits) | (val & ((1 << nbits) - 1))


def _dec_get(reader, cdf_row, cdf_len):
    state = reader.state
    slot = state & MASK
    # binary search: largest s with cdf_row[s] <= slot
    lo, hi = 0, cdf_len - 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cdf_row[mid] <= slot:
            lo = mid
        else:
            hi = mid
    s = lo
    start = int(cdf_row[s])
    freq = int(cdf_row[s + 1]) - start
    state = freq * (state >> PRECISION) + slot - start
    if state < RANS_L:
        state = (state << 32) | reader.next_word()
    reader.state = state
    return s


def _dec_get_bits(reader, nbits):
    state = reader.state
    val = state & ((1 << nbits) - 1)
    state >>= nbits
    if state < RANS_L:
        state = (state << 32) | reader.next_word()
    reader.state = state
    return val


def _zigzag_escape(value_sym, max_symbol):
    """Map an out-of-range symbol index to a non-negative varint payload."""
    if value_sym < 0:
        return 2 * (-value_sym - 1) + 1
    return 2 * (value_sym - max_symbol)


def _unzigzag_escape(u, max_symbol):
    if u & 1:
        return -((u - 1) // 2) - 1
    return u // 2 + max_symbol


def encode_with_indexes(values, indexes, table: CdfTable) -> bytes:
    """Encode int32 `values` (= round(x - mean)) against per-element CDF rows.

    Args:
        values:  int array (N,) — quantized residuals
        indexes: int array (N,) — scale-table row per element
        table:   CdfTable
    """
    values = np.asarray(values, dtype=np.int64).ravel()
    indexes = np.asarray(indexes, dtype=np.int64).ravel()
    assert values.shape == indexes.shape
    cdfs, lengths, offsets = table.cdfs, table.cdf_lengths, table.offsets

    writer = _Writer()
    state = RANS_L
    # encode in reverse so that decoding is forward
    for i in range(values.size - 1, -1, -1):
        idx = int(indexes[i])
        row = cdfs[idx]
        cdf_len = int(lengths[idx])
        max_symbol = cdf_len - 2          # escape bin index
        sym = int(values[i]) - int(offsets[idx])
        if 0 <= sym < max_symbol:
            start = int(row[sym])
            freq = int(row[sym + 1]) - start
            state = _enc_put(writer, state, start, freq)
        else:
            # escape: push varint nibbles in reverse, then the escape symbol
            u = _zigzag_escape(sym, max_symbol)
            nibbles = []
            while True:
                nib = u & 0x7
                u >>= 3
                more = 1 if u > 0 else 0
                nibbles.append((more << 3) | nib)
                if not more:
                    break
            for nib in reversed(nibbles):
                state = _enc_put_bits(writer, state, nib, 4)
            start = int(row[max_symbol])
            freq = int(row[max_symbol + 1]) - start
            state = _enc_put(writer, state, start, freq)
    return writer.tobytes(state)


def decode_with_indexes(data: bytes, indexes, table: CdfTable) -> np.ndarray:
    """Decode int32 values; exact inverse of encode_with_indexes."""
    indexes = np.asarray(indexes, dtype=np.int64).ravel()
    cdfs, lengths, offsets = table.cdfs, table.cdf_lengths, table.offsets

    reader = _Reader(data)
    out = np.empty(indexes.size, dtype=np.int32)
    for i in range(indexes.size):
        idx = int(indexes[i])
        row = cdfs[idx]
        cdf_len = int(lengths[idx])
        max_symbol = cdf_len - 2
        s = _dec_get(reader, row, cdf_len)
        if s == max_symbol:
            u = 0
            shift = 0
            while True:
                nib = _dec_get_bits(reader, 4)
                u |= (nib & 0x7) << shift
                shift += 3
                if not (nib & 0x8):
                    break
            s = _unzigzag_escape(u, max_symbol)
        out[i] = s + int(offsets[idx])
    return out
