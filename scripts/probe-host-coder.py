#!/usr/bin/env python3
"""Two questions about the host coders (lvae_tpu_torch/ops/crans.py,
csrc/crans.cpp), asked of one image's real symbols.

    python3 scripts/probe-host-coder.py [out.json]            # on the card
    python3 scripts/probe-host-coder.py --cpu [out.json]      # tiny models

1. Where do the per-block stream (64-bit state, 32-bit words) and the
   N-lane stream (32-bit lane states in [2^16, 2^32), 16-bit words, the
   escapes out of band) lose bytes against the table's ideal code length,
   -log2(freq / 2^16) a symbol? Each latent block is coded alone by the
   per-block coder, by the N-lane encoder at N = 1 (the lane format without
   the lanes) and at N = 128, and the whole image as the host and device
   coders code it.
2. Would an (S, 2^16) slot -> symbol lookup make the host decode faster
   than the binary search of the CDF row it runs? A copy of csrc/crans.cpp
   with a lookup decode appended is built by g++ into a temporary
   directory; both decodes run on the same strings (host clock, median of
   7 after a warm-up, one thread), and their outputs are held equal.

The symbols are the host coder's (FusedCodecBase.encode_blocks, the legacy
trunk) for photo1: qarv_base with the committed weights at lambda 2048,
qres34m and qres17m with chip_smoke.build_qres34m's seeded weights. With
--cpu, qarv_tiny and qres_tiny on images/collie64.png instead (a check of
the script, not a measurement). Prints the card's name and power limit,
then one JSON object (also written to out.json when given).
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOOKUP_DECODE = r'''
extern "C" int64_t probe_lookup_decode(
    const uint8_t* data, int64_t data_len, const int32_t* indexes, int64_t n,
    const uint32_t* cdfs, const int32_t* cdf_lengths, const int32_t* offsets,
    int64_t max_len, const uint16_t* slot_to_sym, int32_t* out_values) {
  Decoder dec(data, data_len);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const uint32_t* row = cdfs + static_cast<int64_t>(idx) * max_len;
    const int64_t max_symbol = cdf_lengths[idx] - 2;
    const uint32_t slot = static_cast<uint32_t>(dec.state & kMask);
    int64_t s = slot_to_sym[(static_cast<int64_t>(idx) << kPrecision) + slot];
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
'''


def lookup_library(tmp):
    """csrc/crans.cpp with probe_lookup_decode appended, built as the port
    builds the coder (ops/crans.py's flags)."""
    from lvae_tpu_torch.ops import crans
    src = os.path.join(tmp, 'crans_lookup.cpp')
    with open(crans.SOURCE) as f:
        text = f.read()
    with open(src, 'w') as f:    # the same unit: crans.cpp's Decoder
        f.write(text + LOOKUP_DECODE)
    lib = os.path.join(tmp, 'libcrans_lookup.so')
    subprocess.run(['g++', *crans._FLAGS, src, '-o', lib], check=True)
    lib = ctypes.CDLL(lib)
    fn = lib.probe_lookup_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    return fn


def slot_lookup(table):
    """The (S, 2^16) uint16 slot -> symbol table: row[s] <= slot <
    row[s + 1]."""
    slots = np.arange(1 << 16, dtype=np.uint32)
    lut = np.empty((table.num_scales, 1 << 16), dtype=np.uint16)
    for i in range(table.num_scales):
        row = table.cdfs[i, :int(table.cdf_lengths[i])].astype(np.uint32)
        lut[i] = np.searchsorted(row, slots, side='right') - 1
    return lut


def ideal(syms, idx, table):
    """-> (ideal bits of the coded bins, escapes, the per-block coder's
    escape payload bits: 4 a 3-bit nibble of the zigzagged value)."""
    off = table.offsets[idx].astype(np.int64)
    max_sym = table.cdf_lengths[idx].astype(np.int64) - 2
    rel = syms.astype(np.int64) - off
    esc = (rel < 0) | (rel >= max_sym)
    b = np.where(esc, max_sym, rel)
    cdfs = table.cdfs.astype(np.int64)
    freq = cdfs[idx, b + 1] - cdfs[idx, b]
    bits = float(np.sum(16 - np.log2(freq)))
    u = np.where(rel < 0, 2 * (-rel - 1) + 1, 2 * (rel - max_sym))[esc]
    nibbles = np.maximum(1, np.ceil(np.log2(u + 1) / 3)).astype(np.int64)
    return bits, int(esc.sum()), int(4 * nibbles.sum())


def byte_rows(syms, idx, table, codec):
    from lvae_tpu_torch.ops import crans
    from lvae_tpu_torch.utils import coding
    rows = []
    for k, (s, ix) in enumerate(zip(syms, idx)):
        bits, n_esc, host_esc_bits = ideal(s, ix, table)
        row = dict(block=k, symbols=int(s.size), escapes=n_esc,
                   ideal_bytes=bits / 8,
                   host_bytes=len(codec.encode_with_indexes(s, ix)),
                   host_escape_payload_bytes=host_esc_bits / 8)
        for lanes in (1, 128):
            states, words, escapes = crans.interleaved_encode(
                s, ix, [s.size], table, num_lanes=lanes)
            row[f'lanes{lanes}_bytes'] = 2 * words.size + 4 * lanes
            row[f'lanes{lanes}_escape_table_bytes'] = len(
                coding.pack_escapes(escapes[:, 0], escapes[:, 1]))
        rows.append(row)
    return rows


def totals(rows, host_strings, device_payload):
    t = {k: sum(r[k] for r in rows) for k in rows[0] if k != 'block'}
    words = lambda r, lanes: r[f'lanes{lanes}_bytes'] - 4 * lanes
    t['host_words_over_ideal'] = (
        sum(r['host_bytes'] - 8 - r['host_escape_payload_bytes']
            for r in rows) / t['ideal_bytes'] - 1)
    for lanes in (1, 128):
        t[f'lanes{lanes}_words_over_ideal'] = (
            sum(words(r, lanes) for r in rows) / t['ideal_bytes'] - 1)
    # the image as the two coders code it (the host coder's container of
    # lengths left out: the families' differ)
    t['host_strings_bytes'] = sum(len(s) for s in host_strings)
    t['device_payload_bytes'] = len(device_payload)
    t['device_over_host'] = len(device_payload) / t['host_strings_bytes'] - 1
    return t


def decode_times(syms, idx, table, codec, lookup_fn, lut):
    from lvae_tpu_torch.ops.crans import _as_c
    strings = [codec.encode_with_indexes(s, ix) for s, ix in zip(syms, idx)]
    cdfs, cp = _as_c(table.cdfs, np.uint32)   # kept alive by the names
    lens, lnp = _as_c(table.cdf_lengths, np.int32)
    offs, offp = _as_c(table.offsets, np.int32)
    lut, lutp = _as_c(lut, np.uint16)

    def search():
        return [codec.decode_with_indexes(st, ix)
                for st, ix in zip(strings, idx)]

    def lookup():
        out = []
        for st, ix in zip(strings, idx):
            buf = np.frombuffer(st, np.uint8)
            ix, ixp = _as_c(ix, np.int32)
            o = np.empty(ix.size, np.int32)
            lookup_fn(buf.ctypes.data_as(ctypes.c_void_p), buf.size, ixp,
                      ix.size, cp, lnp, offp, table.max_cdf_length, lutp,
                      o.ctypes.data_as(ctypes.c_void_p))
            out.append(o)
        return out

    res = {}
    for name, fn in (('search', search), ('lookup', lookup),
                     ('search_again', search), ('lookup_again', lookup)):
        got = fn()
        if not all(np.array_equal(g, s) for g, s in zip(got, syms)):
            raise AssertionError(f'{name} decode differs from the symbols')
        ts = []
        for _ in range(7):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        res[f'{name}_ms'] = float(np.median(ts) * 1e3)
    n = sum(s.size for s in syms)
    res['ns_per_symbol'] = {k[:-3]: v * 1e6 / n for k, v in res.items()}
    return res


def models(cpu):
    import torch
    import lvae_tpu_torch
    import chip_smoke
    from lvae_tpu_torch.utils import coding
    if cpu:
        im = coding.read_png(os.path.join(ROOT, 'images', 'collie64.png'))
        im = im.astype(np.float32)[None] / 255.0
        yield 'qarv_tiny', lvae_tpu_torch.get_model(
            'qarv_tiny', device='cpu'), im, 512.0
        yield 'qres_tiny', lvae_tpu_torch.get_model(
            'qres_tiny', device='cpu'), im, None
        return
    im = coding.read_png(chip_smoke.PHOTO).astype(np.float32)[None] / 255.0
    yield 'qarv_base', lvae_tpu_torch.get_model(
        'qarv_base', pretrained=chip_smoke.CHECKPOINT), im, \
        chip_smoke.STAGED_LMB
    for name in ('qres34m', 'qres17m'):
        yield name, chip_smoke.build_qres34m(torch, name), im, None
        torch.cuda.empty_cache()


def main(argv):
    cpu = '--cpu' in argv
    argv = [a for a in argv if a != '--cpu']
    if not cpu:
        import torch
        if not torch.cuda.is_available():
            print('no CUDA device (use --cpu for the tiny models)',
                  file=sys.stderr)
            return 1
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip()
        print(card, flush=True)
    out = dict(card=None if cpu else card, threads='one host thread',
               times='host clock, median of 7 after a warm-up', results={})
    from lvae_tpu_torch.utils import coding
    with tempfile.TemporaryDirectory() as tmp:
        lookup_fn = lookup_library(tmp)
        for name, model, im, lmb in models(cpu):
            model.compress_mode(coder='host')
            codec = model._staged_codec()
            x = model._to_input(im)
            ctx = [] if lmb is None else [
                model._lmb_tensor([model._round_lmb(lmb)])]
            syms, idx = codec.encode_blocks(x, *ctx)[:2]
            syms, idx = [s[0] for s in syms], [i[0] for i in idx]
            coder = model._coder
            table = coder.cdf_table
            kw = {} if lmb is None else dict(lmb=lmb)
            host = model.compress(im, **kw)
            model.compress_mode(coder='device')
            device = model.compress(im, **kw)
            if isinstance(host, bytes):    # QARV: header + container
                host = coding.unpack_byte_string(host[10:])
                device = device[10:]
            else:                          # QRes: [[string] a block, shape]
                host, device = [s[0] for s in host[:-1]], device[0]
            rows = byte_rows(syms, idx, table, coder._codec)
            t = time.perf_counter()
            lut = slot_lookup(table)
            lut_s = time.perf_counter() - t
            out['results'][name] = dict(
                blocks=rows, totals=totals(rows, host, device),
                decode=dict(decode_times(syms, idx, table, coder._codec,
                                         lookup_fn, lut),
                            lookup_build_s=lut_s, lookup_bytes=lut.nbytes,
                            table_scales=int(table.num_scales)))
            print(name, json.dumps(out['results'][name]['totals']),
                  json.dumps(out['results'][name]['decode']), flush=True)
            del model
    line = json.dumps(out)
    if argv:
        os.makedirs(os.path.dirname(os.path.abspath(argv[0])), exist_ok=True)
        with open(argv[0], 'w') as f:
            f.write(line)
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
