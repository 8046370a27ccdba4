// Host rANS entropy coder of the port's host and device coders: a copy of
// lvae_tpu/ops/crans/rans.cpp without its optional slot->symbol lookup
// decode (slower than the binary search on a trained model's symbols:
// scripts/probe-host-coder.py),
// byte-identical to it and to the numpy coder in ops/rans_numpy.py, which
// serves as its oracle.
//
// Format summary (per-block coder):
//   * 64-bit state, 32-bit LE word renormalization, PRECISION=16 CDFs
//   * stream = [8-byte LE final state][32-bit words in decode order]
//   * out-of-range symbols: escape bin + nibble varint (3 payload bits +
//     1 continuation bit) pushed as raw bits
//
// Host code, built by g++ (ops/crans.py), not by nvcc:
//   g++ -O3 -std=c++17 -shared -fPIC crans.cpp -o libcrans.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr uint64_t kRansL = 1ull << 31;
constexpr uint64_t kMask = (1ull << kPrecision) - 1;

struct Encoder {
  std::vector<uint32_t> words;
  uint64_t state = kRansL;

  inline void put(uint32_t start, uint32_t freq) {
    uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
    if (state >= x_max) {
      words.push_back(static_cast<uint32_t>(state));
      state >>= 32;
    }
    state = ((state / freq) << kPrecision) + (state % freq) + start;
  }

  inline void put_bits(uint32_t val, int nbits) {
    uint64_t x_max = (kRansL >> nbits) << 32;
    if (state >= x_max) {
      words.push_back(static_cast<uint32_t>(state));
      state >>= 32;
    }
    state = (state << nbits) | (val & ((1u << nbits) - 1));
  }
};

struct Decoder {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
  uint64_t state;

  explicit Decoder(const uint8_t* d, int64_t n) : data(d), len(n), pos(8) {
    state = 0;
    std::memcpy(&state, d, 8);  // little-endian host assumed (x86/ARM LE)
  }

  inline uint32_t next_word() {
    uint32_t w = 0;
    if (pos + 4 <= len) std::memcpy(&w, data + pos, 4);
    pos += 4;
    return w;
  }

  inline void renorm() {
    if (state < kRansL) state = (state << 32) | next_word();
  }

  inline uint32_t get_bits(int nbits) {
    uint32_t val = static_cast<uint32_t>(state & ((1ull << nbits) - 1));
    state >>= nbits;
    renorm();
    return val;
  }
};

inline int64_t zigzag_escape(int64_t sym, int64_t max_symbol) {
  return (sym < 0) ? (2 * (-sym - 1) + 1) : (2 * (sym - max_symbol));
}

inline int64_t unzigzag_escape(uint64_t u, int64_t max_symbol) {
  if (u & 1) return -static_cast<int64_t>((u - 1) / 2) - 1;
  return static_cast<int64_t>(u / 2) + max_symbol;
}

}  // namespace

extern "C" {

// Worst-case output bytes for n symbols (escape varints included).
int64_t rans_encode_bound(int64_t n) { return 8 + 4 * (14 * n + 4); }

// Encode `values[i]` against CDF row `indexes[i]`.
// cdfs: (num_scales, max_len) row-major uint32. Returns bytes written, or -1
// if out_capacity is insufficient.
int64_t rans_encode_with_indexes(
    const int32_t* values, const int32_t* indexes, int64_t n,
    const uint32_t* cdfs, const int32_t* cdf_lengths, const int32_t* offsets,
    int64_t num_scales, int64_t max_len,
    uint8_t* out, int64_t out_capacity) {
  (void)num_scales;
  Encoder enc;
  enc.words.reserve(static_cast<size_t>(n / 2 + 16));

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    const uint32_t* row = cdfs + static_cast<int64_t>(idx) * max_len;
    const int64_t cdf_len = cdf_lengths[idx];
    const int64_t max_symbol = cdf_len - 2;
    const int64_t sym = static_cast<int64_t>(values[i]) - offsets[idx];

    if (sym >= 0 && sym < max_symbol) {
      const uint32_t start = row[sym];
      const uint32_t freq = row[sym + 1] - start;
      enc.put(start, freq);
    } else {
      uint64_t u = static_cast<uint64_t>(zigzag_escape(sym, max_symbol));
      uint32_t nibbles[24];
      int k = 0;
      for (;;) {
        uint32_t nib = static_cast<uint32_t>(u & 0x7);
        u >>= 3;
        uint32_t more = (u > 0) ? 1u : 0u;
        nibbles[k++] = (more << 3) | nib;
        if (!more) break;
      }
      for (int j = k - 1; j >= 0; --j) enc.put_bits(nibbles[j], 4);
      const uint32_t start = row[max_symbol];
      const uint32_t freq = row[max_symbol + 1] - start;
      enc.put(start, freq);
    }
  }

  const int64_t total = 8 + 4 * static_cast<int64_t>(enc.words.size());
  if (total > out_capacity) return -1;
  std::memcpy(out, &enc.state, 8);
  uint8_t* p = out + 8;
  for (int64_t j = static_cast<int64_t>(enc.words.size()) - 1; j >= 0; --j) {
    std::memcpy(p, &enc.words[j], 4);
    p += 4;
  }
  return total;
}

// Decode n values, each symbol found by a binary search of its CDF row.
int64_t rans_decode_with_indexes(
    const uint8_t* data, int64_t data_len,
    const int32_t* indexes, int64_t n,
    const uint32_t* cdfs, const int32_t* cdf_lengths, const int32_t* offsets,
    int64_t num_scales, int64_t max_len,
    int32_t* out_values) {
  (void)num_scales;
  Decoder dec(data, data_len);

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t* row = cdfs + static_cast<int64_t>(idx) * max_len;
    const int64_t cdf_len = cdf_lengths[idx];
    const int64_t max_symbol = cdf_len - 2;

    const uint32_t slot = static_cast<uint32_t>(dec.state & kMask);
    int64_t lo = 0, hi = cdf_len - 1;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) >> 1;
      if (row[mid] <= slot) lo = mid; else hi = mid;
    }
    int64_t s = lo;
    const uint32_t start = row[s];
    const uint32_t freq = row[s + 1] - start;
    dec.state = freq * (dec.state >> kPrecision) + slot - start;
    dec.renorm();

    if (s == max_symbol) {
      uint64_t u = 0;
      int shift = 0;
      for (;;) {
        const uint32_t nib = dec.get_bits(4);
        u |= static_cast<uint64_t>(nib & 0x7) << shift;
        shift += 3;
        if (!(nib & 0x8)) break;
      }
      s = unzigzag_escape(u, max_symbol);
    }
    out_values[i] = static_cast<int32_t>(s + offsets[idx]);
  }
  return n;
}

// ---------------------------------------------------------------------------
// N-lane interleaved encoder ("rans16" format, decoded on the card by the
// rANS decode kernel of csrc/rans.cu). Must match the numpy oracle in
// ops/rans_interleaved.py bit-exactly.
//   * 32-bit lane states in [2^16, 2^32), 16-bit word renormalization
//   * lane assignment restarts at 0 for every block
//   * escapes recorded out-of-band as (global position, value) pairs while
//     the escape bin is coded in-band
// ---------------------------------------------------------------------------

// Returns the number of 16-bit words written, or -1 on capacity error.
int64_t rans_interleaved_encode(
    const int32_t* values, const int32_t* indexes,
    const int64_t* block_sizes, int64_t num_blocks,
    const uint32_t* cdfs, const int32_t* cdf_lengths, const int32_t* offsets,
    int64_t num_scales, int64_t max_len, int64_t num_lanes,
    uint32_t* out_states,            // (num_lanes,)
    uint16_t* out_words, int64_t words_capacity,
    int64_t* out_escapes, int64_t escapes_capacity,   // (cap, 2) row-major
    int64_t* out_n_escapes) {
  (void)num_scales;
  constexpr uint32_t kL16 = 1u << 16;

  int64_t n = 0;
  for (int64_t b = 0; b < num_blocks; ++b) n += block_sizes[b];

  // block-local lane for every global position
  std::vector<int32_t> lanes(static_cast<size_t>(n));
  {
    int64_t pos = 0;
    for (int64_t b = 0; b < num_blocks; ++b) {
      for (int64_t j = 0; j < block_sizes[b]; ++j)
        lanes[pos++] = static_cast<int32_t>(j % num_lanes);
    }
  }

  std::vector<uint32_t> states(static_cast<size_t>(num_lanes), kL16);
  std::vector<uint16_t> words_rev;
  words_rev.reserve(static_cast<size_t>(n / 2 + 64));
  int64_t n_esc = 0;

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t lane = lanes[static_cast<size_t>(i)];
    const int32_t idx = indexes[i];
    const uint32_t* row = cdfs + static_cast<int64_t>(idx) * max_len;
    const int64_t max_symbol = cdf_lengths[idx] - 2;
    int64_t sym = static_cast<int64_t>(values[i]) - offsets[idx];
    if (!(sym >= 0 && sym < max_symbol)) {
      if (n_esc >= escapes_capacity) return -1;
      // escapes recorded ascending by position: fill from the back
      out_escapes[2 * (escapes_capacity - 1 - n_esc)] = i;
      out_escapes[2 * (escapes_capacity - 1 - n_esc) + 1] = values[i];
      ++n_esc;
      sym = max_symbol;
    }
    const uint32_t start = row[sym];
    const uint32_t freq = row[sym + 1] - start;
    uint32_t st = states[static_cast<size_t>(lane)];
    if (st >= (freq << 16)) {
      words_rev.push_back(static_cast<uint16_t>(st & 0xFFFFu));
      st >>= 16;
    }
    states[static_cast<size_t>(lane)] =
        ((st / freq) << kPrecision) + (st % freq) + start;
  }

  const int64_t n_words = static_cast<int64_t>(words_rev.size());
  if (n_words > words_capacity) return -1;
  for (int64_t j = 0; j < n_words; ++j)
    out_words[j] = words_rev[static_cast<size_t>(n_words - 1 - j)];
  std::memcpy(out_states, states.data(), sizeof(uint32_t) * num_lanes);
  // move escapes to the front of the buffer (already position-ascending)
  if (n_esc > 0 && n_esc < escapes_capacity) {
    std::memmove(out_escapes, out_escapes + 2 * (escapes_capacity - n_esc),
                 sizeof(int64_t) * 2 * n_esc);
  }
  *out_n_escapes = n_esc;
  return n_words;
}

}  // extern "C"
